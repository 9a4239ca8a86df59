"""The model-based slice of the port against the JAX package: the ICM
wrappers over DQN (off-policy) and PPO (on-policy), ``NChain`` and PSRL.

- ICM: one update of each wrapper from the same weights (flax's, carried
  across by ``net_params_from_flax``, ``actor_critic_params_from_flax`` and
  ``icm_params_from_flax``), the same rows (``Draws(indices=...)``) or the
  same rollout with PPO's minibatches handed over (``perm``). Returns,
  rewards, losses and TD errors rtol 1e-5 / atol 1e-6 (off-policy; PPO's
  statistics rtol 1e-4 / atol 1e-4, ``tests/test_torch_onpolicy.py``'s rule);
  the weights after the step all within 2e-5 (PPO's: 1e-4) and 99.9% of each
  tensor within 2e-6.
- ``NChain``: steps from every position, with the slip's uniforms of the JAX
  env's keys handed over (``step_from``): observations, rewards and flags
  bit-exact.
- PSRL: two ``update_rollout`` calls with JAX's Dirichlet and normal draws
  handed over (``Draws(psrl_trans=, psrl_rew=)``): the counts exact (sums of
  ones), the reward sums rtol 1e-6, the value after ``value_iterations``
  sweeps rtol 1e-5 / atol 1e-5 (float32 matrix-vector products summed in
  another order, repeated), the greedy policy exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelbased.icm import ICMOffPolicyWrapper as JICMOff
from tianshou_tpu.algorithm.modelbased.icm import ICMOnPolicyWrapper as JICMOn
from tianshou_tpu.algorithm.modelbased.psrl import PSRL as JPSRL
from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
from tianshou_tpu.algorithm.modelfree.ppo import PPO as JPPO
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.env.classic.nchain import NChain as JNChain
from tianshou_tpu.env.classic.nchain import NChainState as JNChainState
from tianshou_tpu.models import discrete as jdisc
from tianshou_tpu.models.mlp import Net as JNet
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.algorithm.modelbased.icm import ICMOffPolicyWrapper, ICMOnPolicyWrapper
from tianshou_tpu_torch.algorithm.modelbased.psrl import PSRL
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.classic.nchain import NChain, NChainState
from tianshou_tpu_torch.models import discrete
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax, icm_params_from_flax, net_params_from_flax
from tianshou_tpu_torch.models.mlp import Net
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

OBS, ACT, E, C, B, T = 4, 2, 4, 16, 12, 8
TOL = dict(rtol=1e-5, atol=1e-6)
ICM_KW = dict(lr_scale=0.5, reward_scale=0.3, forward_loss_weight=0.2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _hold(got, want, atol=2e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].detach().numpy(), w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)
        assert np.mean(np.abs(g - w) <= 2e-6) >= 0.999, k


def _icm_nets():
    return (jdisc.IntrinsicCuriosityModule((16, 8), ACT, (16,)),
            discrete.IntrinsicCuriosityModule((16, 8), ACT, (16,), input_dim=OBS))


# ---------------------------------------------------------------------------
# ICM over DQN
# ---------------------------------------------------------------------------
def _example(jax_side):
    ex = dict(obs=np.zeros(OBS, np.float32), act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False),
              truncated=np.bool_(False), obs_next=np.zeros(OBS, np.float32))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


@pytest.fixture(scope="module")
def ring():
    rng = np.random.default_rng(0)
    jb, tb = JVRB(E * C, E), VectorReplayBuffer(E * C, E)
    js, ts = jb.init(_example(True)), tb.init(_example(False), device="cpu")
    for _ in range(13):
        term = rng.random(E) < 0.15
        step = dict(obs=rng.standard_normal((E, OBS)).astype(np.float32), act=rng.integers(0, ACT, E).astype(np.int32),
                    rew=rng.standard_normal(E).astype(np.float32), terminated=term,
                    truncated=(rng.random(E) < 0.1) & ~term, obs_next=rng.standard_normal((E, OBS)).astype(np.float32))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    return jb, js, tb, ts, rng.integers(0, E * 13, B)


def _off_pair():
    jicm, ticm = _icm_nets()
    kw = dict(gamma=0.9, n_step_return_horizon=3, target_update_freq=320)
    jalgo = JICMOff(JDQN(model=JNet((16, 16), ACT), action_space=jcore.Discrete(ACT), optim=JAdam(lr=1e-3), **kw),
                    jicm, optim=JAdam(lr=1e-3), **ICM_KW)
    talgo = ICMOffPolicyWrapper(DQN(model=Net((16, 16), ACT, input_dim=OBS), action_space=tcore.Discrete(ACT),
                                    optim=AdamOptimizerFactory(lr=1e-3), **kw),
                                ticm, optim=AdamOptimizerFactory(lr=1e-3), **ICM_KW)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    target = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) * np.float32(0.8)), jts.target_params)
    jts = jts.replace(target_params=target)
    tts = talgo.init("cpu")
    tts.model["wrapped"].load_state_dict(net_params_from_flax(_np(jts.params["model"])))
    tts.model["icm"].load_state_dict(icm_params_from_flax(_np(jts.params["icm"])))
    tts.target.load_state_dict(net_params_from_flax(_np(target["model"])))
    return jalgo, jts, talgo, tts


def _off_state(ts):
    return {"model": ts.model["wrapped"].state_dict(), "icm": ts.model["icm"].state_dict(),
            "target": ts.target.state_dict()}


def _off_jax_state(jts):
    return {"model": net_params_from_flax(_np(jts.params["model"])), "icm": icm_params_from_flax(_np(jts.params["icm"])),
            "target": net_params_from_flax(_np(jts.target_params["model"]))}


def test_icm_off_policy_update_matches_jax(ring):
    jb, js, tb, ts, idx = ring
    jalgo, jts, talgo, tts = _off_pair()
    assert talgo.update_sample_drop_keys == jalgo.update_sample_drop_keys == ()  # the ICM reads obs_next
    assert talgo.n_step == 3
    key = jax.random.key(1)
    _, k2, k3 = jax.random.split(key, 3)
    jidx = jnp.asarray(idx)
    jbatch = jax.jit(lambda t, s, b: jalgo.preprocess(t, jb, s, b, jidx, k2))(jts, js, jb.get(js, jidx))
    jts2, jstats = jax.jit(jalgo.update_step)(jts, jbatch, k3)
    before = {k: {n: v.clone() for n, v in sd.items()} for k, sd in _off_state(tts).items()}
    tbatch = talgo.preprocess(tts, tb, ts, tb.get(ts, _t(idx)), _t(idx), torch.Generator())
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)
    _, tstats = talgo.update_step(tts, tbatch)
    assert set(tstats.keys()) == set(jstats.keys())
    for k in tstats.keys():
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(jstats[k]), **TOL, err_msg=k)
    assert int(tts.step) == int(jts2.step) == 1
    got, want = _off_state(tts), _off_jax_state(jts2)
    for k in ("model", "icm", "target"):
        _hold(got[k], want[k])
    for k in ("model", "icm"):  # both nets train; the target keeps its weights (no sync at step 1)
        assert any(not torch.equal(got[k][n], v) for n, v in before[k].items()), k
    assert all(torch.equal(got["target"][n], v) for n, v in before["target"].items())
    # the full update over handed rows is the same as preprocess + update_step
    _, _, talgo2, tts2 = _off_pair()
    talgo2.update(tts2, tb, ts, Draws(indices=_t(idx).long()), B)
    assert all(torch.equal(a, b) for a, b in zip(tts2.model.parameters(), tts.model.parameters()))


def test_icm_off_policy_acting_goes_through_the_wrapped_algorithm():
    _, _, talgo, tts = _off_pair()
    obs = torch.from_numpy(np.random.default_rng(2).standard_normal((6, OBS)).astype(np.float32))
    inner = talgo.inner(tts)
    assert inner.model is tts.model["wrapped"] and inner.step is tts.step and inner.hparams is tts.hparams
    assert torch.equal(talgo.forward(tts, obs).act, talgo.wrapped.forward(inner, obs).act)
    tts.hparams["eps_training"].fill_(1.0)  # every action random: the wrapped eps-greedy reads the shared hparams
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    act = talgo.forward(tts, obs).act
    assert torch.equal(talgo.exploration_noise(tts, act, obs, g1), talgo.wrapped.exploration_noise(inner, act, obs, g2))


# ---------------------------------------------------------------------------
# ICM over PPO
# ---------------------------------------------------------------------------
def test_icm_on_policy_update_rollout_matches_jax():
    rng = np.random.default_rng(3)
    term = rng.random((T, E)) < 0.1
    d = dict(obs=rng.standard_normal((T, E, OBS)).astype(np.float32),
             obs_next=rng.standard_normal((T, E, OBS)).astype(np.float32),
             act=rng.integers(0, ACT, (T, E)), rew=rng.normal(0.5, 1, (T, E)).astype(np.float32), terminated=term,
             truncated=(rng.random((T, E)) < 0.1) & ~term)
    jroll, troll = JBatch(**{k: jnp.asarray(v) for k, v in d.items()}), Batch(**{k: _t(v) for k, v in d.items()})
    jicm, ticm = _icm_nets()
    jalgo = JICMOn(JPPO(actor=jdisc.DiscreteActor((16, 16), ACT), critic=jdisc.DiscreteCritic((16, 16)),
                        action_space=jcore.Discrete(ACT), optim=JAdam(lr=1e-3, max_grad_norm=0.5)),
                   jicm, optim=JAdam(lr=1e-3), **ICM_KW)
    talgo = ICMOnPolicyWrapper(PPO(actor=discrete.DiscreteActor((16, 16), ACT, input_dim=OBS),
                                   critic=discrete.DiscreteCritic((16, 16), input_dim=OBS),
                                   action_space=tcore.Discrete(ACT), optim=AdamOptimizerFactory(lr=1e-3, max_grad_norm=0.5)),
                               ticm, optim=AdamOptimizerFactory(lr=1e-3), **ICM_KW)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    tts = talgo.init("cpu")
    params = _np(jts.params)
    tts.model["wrapped"].load_state_dict(actor_critic_params_from_flax(params, tts.model["wrapped"]))
    tts.model["icm"].load_state_dict(icm_params_from_flax(params["icm"]))
    key = jax.random.key(4)
    repeat, bs = 2, 8
    jts2, jstats = jalgo.update_rollout(jts, jroll, key, repeat=repeat, batch_size=bs)
    n, n_mb = T * E, T * E // bs
    _, k_loop = jax.random.split(key)  # PPO's minibatches, as the wrapped JAX update draws them
    perm = np.stack([np.asarray(jax.random.permutation(jax.random.split(rk)[0], n))[: n_mb * bs].reshape(n_mb, bs)
                     for rk in jax.random.split(k_loop, repeat)])
    _, stats = talgo.update_rollout(tts, troll, None, repeat, bs, perm=_t(perm).long())
    assert set(stats.keys()) == set(jstats.keys())
    for k in stats.keys():
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-4, atol=1e-4, err_msg=k)
    params2 = _np(jts2.params)
    _hold(tts.model["wrapped"].state_dict(), actor_critic_params_from_flax(params2, tts.model["wrapped"]), atol=1e-4)
    _hold(tts.model["icm"].state_dict(), icm_params_from_flax(params2["icm"]))
    assert int(tts.step) == int(jts2.step) == repeat * n_mb == talgo.rollout_grad_steps(n, repeat, bs)
    assert set(tts.optim) == {"wrapped", "icm"} and troll.rew.equal(_t(d["rew"]))


# ---------------------------------------------------------------------------
# NChain and PSRL
# ---------------------------------------------------------------------------
def test_nchain_steps_bit_exact():
    """Every position under both actions, some slipping, and the truncation at the step limit."""
    jenv, tenv = JNChain(n=5, slip=0.2), NChain(n=5, slip=0.2)
    pos = np.tile(np.arange(5, dtype=np.int32), 4)
    act = np.repeat(np.array([0, 1, 0, 1], np.int32), 5)
    t = np.array([0, 98, 99, 50] * 5, np.int32)
    keys = jax.random.split(jax.random.key(7), pos.size)
    out = jax.vmap(jenv.step)(JNChainState(jnp.asarray(pos), jnp.asarray(t)), jnp.asarray(act), keys)
    u = jax.vmap(jax.random.uniform)(keys)
    assert 0 < int((np.asarray(u) < 0.2).sum()) < pos.size  # some slip
    got = tenv.step_from(NChainState(_t(pos), _t(t)), _t(act).long(), _t(u))
    assert got.obs.dtype == torch.float32 and got.obs.shape == (pos.size, 1)
    assert np.array_equal(got.obs.numpy(), np.asarray(out.obs))
    assert np.array_equal(got.reward.numpy(), np.asarray(out.reward))
    assert np.array_equal(got.state.pos.numpy(), np.asarray(out.state.pos))
    assert np.array_equal(got.truncated.numpy(), np.asarray(out.truncated))
    assert not got.terminated.any() and not np.asarray(out.terminated).any()
    s, obs = tenv.reset(3, torch.Generator(), "cpu")
    js, jobs = jenv.reset(jax.random.key(0))
    assert obs.tolist() == [np.asarray(jobs).tolist()] * 3 and not s.t.any()
    assert (tenv.observation_space.low_arr == jenv.observation_space.low_arr).all()


def _psrl_rollout(rng, S=5, A=2):
    term = rng.random((T, E)) < 0.05
    d = dict(obs=rng.integers(0, S, (T, E, 1)).astype(np.float32),
             obs_next=rng.integers(0, S, (T, E, 1)).astype(np.float32), act=rng.integers(0, A, (T, E)),
             rew=rng.normal(1.0, 2.0, (T, E)).astype(np.float32), terminated=term,
             truncated=(rng.random((T, E)) < 0.1) & ~term)
    return JBatch(**{k: jnp.asarray(v) for k, v in d.items()}), Batch(**{k: _t(v) for k, v in d.items()})


@pytest.mark.parametrize("done_loop", [False, True], ids=["plain", "done_loop"])
def test_psrl_posterior_and_value_iteration_match_jax(done_loop):
    S, A = 5, 2
    kw = dict(gamma=0.95, value_iterations=60, add_done_loop=done_loop, rew_mean_prior=0.5, rew_std_prior=2.0)
    jalgo = JPSRL(n_state=S, n_action=A, action_space=jcore.Discrete(A), **kw)
    talgo = PSRL(n_state=S, n_action=A, action_space=tcore.Discrete(A), **kw)
    jts, tts = jalgo.init(jax.random.key(0), jnp.zeros(1)), talgo.init("cpu")
    rng = np.random.default_rng(5)
    for i in range(2):  # the second sweep starts from the first's value
        jroll, troll = _psrl_rollout(rng, S, A)
        key = jax.random.key(10 + i)
        jts, jstats = jalgo.update_rollout(jts, jroll, key, repeat=1, batch_size=0)
        k1, k2 = jax.random.split(key)
        draws = Draws(psrl_trans=_t(jax.random.dirichlet(k1, jts.extra.trans_count.reshape(S * A, S)).reshape(S, A, S)),
                      psrl_rew=_t(jax.random.normal(k2, (S, A))))
        _, stats = talgo.update_rollout(tts, troll, draws, 1, 0)
        x = tts.extra
        assert np.array_equal(x["trans_count"].numpy(), np.asarray(jts.extra.trans_count))
        assert np.array_equal(x["rew_count"].numpy(), np.asarray(jts.extra.rew_count))
        np.testing.assert_allclose(x["rew_sum"].numpy(), np.asarray(jts.extra.rew_sum), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(x["value"].numpy(), np.asarray(jts.extra.value), rtol=1e-5, atol=1e-5)
        assert x["policy"].tolist() == np.asarray(jts.extra.policy).tolist()
        np.testing.assert_allclose(float(stats.value_mean), float(jstats.value_mean), rtol=1e-5, atol=1e-5)
        assert int(stats.n_grad_steps) == int(jstats.n_grad_steps) == talgo.rollout_grad_steps(T * E, 3, 64) == 1
        assert int(tts.step) == int(jts.step) == i + 1
    obs = torch.arange(S, dtype=torch.float32)[:, None]  # acting reads the policy table
    assert talgo.forward(tts, obs).act.tolist() == np.asarray(jalgo.forward(jts, jnp.asarray(obs.numpy()),
                                                                            jax.random.key(0)).act).tolist()


def test_psrl_draws_from_a_generator():
    """The generator route: rows of the transition sample are distributions, the counts are exact over
    duplicate rows, and two equal generators give equal posteriors."""
    S, A = 5, 2
    rng = np.random.default_rng(6)
    _, troll = _psrl_rollout(rng, S, A)
    outs = []
    for _ in range(2):
        talgo = PSRL(n_state=S, n_action=A, action_space=tcore.Discrete(A), value_iterations=30)
        tts = talgo.init("cpu")
        trans, rew = talgo.sample_posterior(tts, torch.Generator().manual_seed(1))
        assert trans.shape == (S, A, S) and rew.shape == (S, A) and bool((trans >= 0).all())
        torch.testing.assert_close(trans.sum(-1), torch.ones(S, A))
        talgo.update_rollout(tts, troll, torch.Generator().manual_seed(2), 1, 0)
        outs.append({k: v.clone() for k, v in tts.extra.items()})
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    s = troll.obs.reshape(-1).long()
    a = troll.act.reshape(-1)
    want = np.ones((S, A))
    np.add.at(want, (s.numpy(), a.numpy()), 1.0)
    assert np.array_equal(outs[0]["rew_count"].numpy(), want)
