"""Discrete SAC in the port (tianshou_tpu_torch) against the JAX package
(tianshou_tpu): one update on the same replay rows (indices handed over),
with automatic and fixed alpha, the trap of the update's order (the actor
reads the critics after their step), the default target entropy, acting,
and the sampled ``obs_next`` the n-step update never reads.

Weights are carried across by
``tianshou_tpu_torch.models.convert.actor_critic_params_from_flax``
(``log_alpha`` included). Discrete SAC draws nothing in its update: the
target and the actor loss are exact expectations over the categorical.

Tolerances: n-step returns, losses, entropy and TD errors rtol 1e-4 / atol
1e-5 (float32 sums in another order); parameters and targets after one
update (Adam 1e-3, ``log_alpha`` Adam 3e-4) atol 2e-6 for at least 99.9% of
each tensor and 2e-5 for all, as ``tests/test_torch_dqn.py`` holds DQN's
(Adam's first step ``lr * g / (|g| + eps)`` moves a weight whose gradient is
near eps by a share of lr set by its gradient's last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.discrete_sac import DiscreteSAC as JDiscreteSAC
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models.discrete import DiscreteActor as JActor
from tianshou_tpu.models.discrete import DiscreteCritic as JCritic
from tianshou_tpu_torch.algorithm.modelfree.discrete_sac import DiscreteSAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

OBS, A, E, C, B = 5, 3, 4, 16, 24
TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _example(jax_side):
    ex = dict(obs=np.zeros(OBS, np.float32), act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False),
              truncated=np.bool_(False), obs_next=np.zeros(OBS, np.float32))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


@pytest.fixture(scope="module")
def filled():
    rng = np.random.default_rng(0)
    jb, tb = JVRB(E * C, E), VectorReplayBuffer(E * C, E)
    js, ts = jb.init(_example(True)), tb.init(_example(False), device="cpu")
    for _ in range(11):
        step = dict(obs=rng.standard_normal((E, OBS)).astype(np.float32), act=rng.integers(0, A, E).astype(np.int32),
                    rew=rng.standard_normal(E).astype(np.float32), terminated=rng.random(E) < 0.15,
                    truncated=rng.random(E) < 0.05, obs_next=rng.standard_normal((E, OBS)).astype(np.float32))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    return jb, js, tb, ts, rng.integers(0, E * 11, B)


def _algos(alpha="auto", n_step=3, critic_lr=1e-3):
    kw = dict(gamma=0.9, tau=0.05, alpha=alpha, n_step_return_horizon=n_step)
    jalgo = JDiscreteSAC(actor=JActor((16, 16), A), critic=JCritic((16, 16), last_size=A),
                         action_space=jcore.Discrete(A), policy_optim=JAdam(lr=1e-3), critic_optim=JAdam(lr=critic_lr),
                         **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    talgo = DiscreteSAC(actor=DiscreteActor((16, 16), A, input_dim=OBS),
                        critic=DiscreteCritic((16, 16), last_size=A, input_dim=OBS), action_space=tcore.Discrete(A),
                        policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=critic_lr),
                        **kw)
    tts = talgo.init("cpu")
    tts.model.load_state_dict(actor_critic_params_from_flax(_np_tree(jts.params), tts.model))
    tts.target.load_state_dict(actor_critic_params_from_flax(_np_tree(jts.target_params), tts.target))
    return jalgo, jts, talgo, tts


def _batches(filled, jalgo, jts, talgo, tts):
    jb, js, tb, ts, idx = filled
    jidx, tidx = jnp.asarray(idx), torch.from_numpy(idx)
    jbatch = jalgo.preprocess(jts, jb, js, jb.get(js, jidx), jidx, jax.random.key(1))
    tbatch = talgo.preprocess(tts, tb, ts, tb.get(ts, tidx, drop_keys=talgo.update_sample_drop_keys), tidx,
                              torch.Generator())
    return jbatch, tbatch


@pytest.mark.parametrize("alpha,n_step", [("auto", 3), (0.05, 1)], ids=["auto_alpha", "fixed_alpha"])
def test_one_discrete_sac_update_matches_jax(filled, alpha, n_step):
    jalgo, jts, talgo, tts = _algos(alpha, n_step)
    jbatch, tbatch = _batches(filled, jalgo, jts, talgo, tts)
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)
    before = {k: v.clone() for k, v in tts.model.state_dict().items()}
    jts2, jstats = jalgo.update_step(jts, jbatch, jax.random.key(2))
    tts, tstats = talgo.update_step(tts, tbatch)
    for name in ("loss", "actor_loss", "critic_loss", "entropy"):
        np.testing.assert_allclose(tstats[name].item(), float(jstats[name]), **TOL, err_msg=name)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **TOL)
    for got_sd, want_sd in ((tts.model.state_dict(), actor_critic_params_from_flax(_np_tree(jts2.params), tts.model)),
                            (tts.target.state_dict(),
                             actor_critic_params_from_flax(_np_tree(jts2.target_params), tts.target))):
        assert set(got_sd) == set(want_sd)
        for k, w in want_sd.items():
            got, w = got_sd[k].detach().numpy(), w.numpy()
            np.testing.assert_allclose(got, w, rtol=0, atol=2e-5, err_msg=k)
            assert np.mean(np.abs(got - w) <= 2e-6) >= 0.999, k
    for k, v in before.items():  # every net trains, and log_alpha moves with "auto"
        assert not torch.equal(tts.model.state_dict()[k], v), k
    assert ("log_alpha" in before) == (alpha == "auto")
    assert int(tts.step) == int(jts2.step) == 1


def test_the_actor_reads_the_stepped_critics(filled):
    """With a critic step large enough to matter, the actor loss is JAX's, and
    not the loss against the critics from before their step."""
    jalgo, jts, talgo, tts = _algos(critic_lr=0.3)
    jbatch, tbatch = _batches(filled, jalgo, jts, talgo, tts)
    with torch.no_grad():
        logits = tts.model["actor"](tbatch.obs)
        q_old = torch.minimum(tts.model["critic"](tbatch.obs), tts.model["critic2"](tbatch.obs))
        probs, logp = logits.softmax(-1), logits.log_softmax(-1)
        stale = float((probs * (talgo._alpha(tts) * logp - q_old)).sum(-1).mean())
    _, jstats = jalgo.update_step(jts, jbatch, jax.random.key(2))
    _, tstats = talgo.update_step(tts, tbatch)
    np.testing.assert_allclose(tstats.actor_loss.item(), float(jstats.actor_loss), **TOL)
    assert abs(stale - float(jstats.actor_loss)) > 100 * (TOL["atol"] + TOL["rtol"] * abs(float(jstats.actor_loss)))


@pytest.mark.parametrize("n", [2, 6, 18])
def test_default_target_entropy_matches_jax(n):
    jalgo = JDiscreteSAC(actor=JActor((8,), n), critic=JCritic((8,), last_size=n), action_space=jcore.Discrete(n))
    talgo = DiscreteSAC(actor=DiscreteActor((8,), n, input_dim=3), critic=DiscreteCritic((8,), last_size=n, input_dim=3),
                        action_space=tcore.Discrete(n))
    assert talgo.target_entropy == jalgo.target_entropy
    assert talgo.n_step == 1 and talgo.update_sample_drop_keys == jalgo.update_sample_drop_keys == ()


def test_acting_samples_the_categorical_or_takes_its_mode(filled):
    jalgo, jts, talgo, tts = _algos()
    obs = filled[2].get(filled[3], torch.from_numpy(filled[4]), keys=("obs",)).obs
    det = talgo.forward(tts, obs, torch.Generator(), deterministic=True).act
    jdet = jalgo.forward(jts, jnp.asarray(obs.numpy()), jax.random.key(0), deterministic=True).act
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    a = talgo.forward(tts, obs, torch.Generator().manual_seed(4)).act
    b = talgo.forward(tts, obs, torch.Generator().manual_seed(4)).act
    assert torch.equal(a, b) and a.shape == (B,) and bool(((a >= 0) & (a < A)).all())
    assert not torch.equal(a, talgo.forward(tts, obs, torch.Generator().manual_seed(5)).act)


def test_the_n_step_update_does_not_gather_the_sampled_obs_next(filled):
    """For n > 1 the targets come from the terminal row: the port drops the
    sampled ``obs_next`` (the JAX DiscreteSAC gathers it unread), with the
    same returns and update."""
    jalgo, jts, talgo, tts = _algos(n_step=3)
    assert talgo.update_sample_drop_keys == ("obs_next",) and jalgo.update_sample_drop_keys == ()
    jb, js, tb, ts, idx = filled
    tidx = torch.from_numpy(idx)
    full = talgo.preprocess(tts, tb, ts, tb.get(ts, tidx), tidx, torch.Generator())
    dropped = talgo.preprocess(tts, tb, ts, tb.get(ts, tidx, drop_keys=("obs_next",)), tidx, torch.Generator())
    assert "obs_next" not in dropped and torch.equal(full.returns, dropped.returns)
