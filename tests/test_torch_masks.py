"""Invalid-action masks in the port against the JAX package, on the CPU.

- ``MaskedCategorical``: the filled logits bit-exact (``finfo.min``, not
  ``-inf``), and ``log_prob`` of the valid actions, ``probs``, ``entropy``
  and ``mode`` at atol 1e-6.
- DQN over an observation ``Batch`` with a ``mask`` (a linear Q net on
  ``obs.obs``, flax's weights carried over): ``forward``'s Q (``-inf`` where
  masked) and greedy action exactly; ``exploration_noise`` with JAX's
  uniforms handed over (the Gumbel uniforms of ``jax.random.categorical``
  and the eps draw) exactly, at eps 0.5 and 1; ``_target_q`` double and
  single at atol 1e-6 with the target net apart from the online one. The
  masks make the unmasked argmax invalid in most rows.
- No masked action is ever chosen: 200 draws at eps 1 over random masks,
  and the greedy action where the best Q is masked.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models.distributions import MaskedCategorical as JMaskedCategorical
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.models.distributions import MaskedCategorical
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

B, D, N = 16, 5, 6


def t(x):
    return torch.from_numpy(np.array(x))


def _mask(rng, shape):
    mask = rng.random(shape) < 0.5
    mask[np.arange(shape[0]), rng.integers(0, shape[1], shape[0])] = True  # one valid action at least
    return mask


def test_masked_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (B, N)).astype(np.float32)
    mask = _mask(rng, (B, N))
    jd, td = JMaskedCategorical(jnp.asarray(logits), jnp.asarray(mask)), MaskedCategorical(t(logits), t(mask))
    np.testing.assert_array_equal(td.logits.numpy(), np.asarray(jd.logits))
    assert bool(torch.isfinite(td.logits).all()) and float(td.logits.min()) == torch.finfo(torch.float32).min
    act = np.argmax(np.where(mask, rng.random((B, N)), -1.0), axis=1)  # a valid action per row
    for name, got, want in (("log_prob", td.log_prob(t(act)), jd.log_prob(jnp.asarray(act))),
                            ("probs", td.probs, jd.probs), ("entropy", td.entropy(), jd.entropy())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))
    assert bool((td.probs[~t(mask)] == 0).all())


class JMaskedQ(fnn.Module):
    @fnn.compact
    def __call__(self, obs):
        return fnn.Dense(N)(obs.obs)


class MaskedQ(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(D, N)

    def forward(self, obs):
        return self.dense(obs.obs)


def make_pair():
    """(JAX DQN, JAX train state with a target apart, port DQN, port train state)."""
    jalgo = JDQN(JMaskedQ(), jcore.Discrete(N), target_update_freq=10, eps_training=0.5, eps_inference=1.0)
    jts = jalgo.init(jax.random.key(0), JBatch(obs=jnp.zeros(D), mask=jnp.ones(N, bool)))
    target = jax.tree.map(lambda x: x * -0.7 + 0.1, jts.params["model"])
    jts = jts.replace(target_params={"model": target})
    talgo = DQN(MaskedQ(), tcore.Discrete(N), target_update_freq=10, eps_training=0.5, eps_inference=1.0)
    tts = talgo.init("cpu")
    for net, tree in ((tts.model, jts.params["model"]), (tts.target, target)):
        dense = tree["params"]["Dense_0"]
        net.load_state_dict({"dense.weight": t(np.asarray(dense["kernel"]).T), "dense.bias": t(dense["bias"])})
    return jalgo, jts, talgo, tts


def _obs(seed, masked_best=True):
    rng = np.random.default_rng(seed)
    obs = rng.normal(0, 1, (B, D)).astype(np.float32)
    mask = _mask(rng, (B, N))
    return JBatch(obs=jnp.asarray(obs), mask=jnp.asarray(mask)), Batch(obs=t(obs), mask=t(mask))


def test_forward_matches_jax_and_never_picks_a_masked_action():
    jalgo, jts, talgo, tts = make_pair()
    jobs, tobs = _obs(1)
    want = jalgo.forward(jts, jobs, jax.random.key(0))
    got = talgo.forward(tts, tobs)
    np.testing.assert_array_equal(got.info.q.numpy(), np.asarray(want.info.q))
    np.testing.assert_array_equal(got.act.numpy(), np.asarray(want.act))
    assert bool(tobs.mask.gather(1, got.act[:, None]).all())
    unmasked = talgo.forward(tts, Batch(obs=tobs.obs, mask=torch.ones(B, N, dtype=torch.bool))).act
    assert not bool(tobs.mask.gather(1, unmasked[:, None]).all())  # the mask changed some greedy actions


@pytest.mark.parametrize("training", [True, False], ids=["eps_0.5", "eps_1"])
def test_exploration_noise_matches_jax_with_handed_uniforms(training):
    jalgo, jts, talgo, tts = make_pair()
    jobs, tobs = _obs(2)
    act = talgo.forward(tts, tobs).act
    key = jax.random.key(11)
    want = jalgo.exploration_noise(jts, jnp.asarray(act.numpy().astype(np.int32)), jobs, key, training=training)
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, (B, N), minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)
    rand_act = talgo.masked_random_action(tobs.mask, t(u))
    np.testing.assert_array_equal(
        rand_act.numpy(), np.asarray(jax.random.categorical(k1, jnp.where(jobs.mask, 0.0, -jnp.inf), axis=-1)))
    got = talgo.eps_greedy(tts, act, rand_act, t(jax.random.uniform(k2, (B,))), training)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(tobs.mask.gather(1, got[:, None]).all())


def test_no_masked_action_is_ever_chosen():
    _, _, algo, ts = make_pair()
    g = torch.Generator().manual_seed(0)
    chosen = torch.zeros(N, dtype=torch.int64)
    for seed in range(200):
        _, obs = _obs(100 + seed)
        act = algo.exploration_noise(ts, algo.forward(ts, obs).act, obs, g, training=False)  # eps 1
        assert bool(obs.mask.gather(1, act[:, None]).all())
        chosen += torch.bincount(act, minlength=N)
    assert bool((chosen > 0).all())  # every action drawn somewhere


@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
def test_target_q_matches_jax(double):
    jalgo, jts, talgo, tts = make_pair()
    jalgo.is_double = talgo.is_double = double
    jobs, tobs = _obs(3)
    want = jalgo._target_q(jts, jobs, jax.random.key(0))
    got = talgo._target_q(tts, tobs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert float(got.min()) > -1e8  # a masked action's -1e9 never reaches the target
