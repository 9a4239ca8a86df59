"""BDQN and the rest of ``models/mlp.py`` in the port (tianshou_tpu_torch)
against the JAX package (tianshou_tpu): ``BranchingNet``, ``RandomActor``,
``flatten_dict_obs`` / ``DictObsNet`` (the leaf-order trap), one BDQN update
on the same replay rows (indices handed over) on a ``MultiDiscrete`` action
space, BDQN's acting and exploration, and ``DeviceCollector.stats_from``'s
``max_episodes``.

Tolerances: float32 forwards, n-step returns, losses and TD errors rtol 1e-4
/ atol 1e-5 (float32 sums in another order); flattened observations exactly
(a copy); parameters after one Adam step (lr 1e-3) atol 2e-6 for at least
99.9% of each tensor and 2e-5 for all, as ``tests/test_torch_dqn.py`` holds
DQN's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algorithm.modelfree.bdqn import BDQN as JBDQN
from tianshou_tpu.algorithm.optim import AdamOptimizerFactory as JAdam
from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.env import core as jcore
from tianshou_tpu.models import mlp as jm
from tianshou_tpu_torch.algorithm.modelfree.bdqn import BDQN
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.env import core as tcore
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.models import mlp as tm
from tianshou_tpu_torch.models.convert import branching_net_params_from_flax, dict_obs_net_params_from_flax, \
    net_params_from_flax
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

OBS, K, A, E, C, B = 3, 2, 5, 4, 16, 24
TOL = dict(rtol=1e-4, atol=1e-5)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------
def test_branching_net_matches_jax():
    obs = np.random.default_rng(0).standard_normal((6, OBS)).astype(np.float32)
    m = jm.BranchingNet((16, 16), K, A, value_hidden=(8,), branch_hidden=12)
    p = m.init(jax.random.key(0), jnp.asarray(obs))
    net = tm.BranchingNet((16, 16), K, A, value_hidden=(8,), branch_hidden=12, input_dim=OBS)
    assert net.branch.weight.shape == (K, 16, 12) and net.adv.weight.shape == (K, 12, A)
    net.load_state_dict(branching_net_params_from_flax(_np_tree(p)))
    with torch.no_grad():
        got = net(_t(obs))
    assert got.shape == (6, K, A)
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(p, jnp.asarray(obs))), **TOL)


def test_random_actor_matches_jax():
    obs = np.zeros((4, 7), np.float32)
    for discrete in (True, False):
        want = jm.RandomActor(3, discrete).apply({}, jnp.asarray(obs))
        got = tm.RandomActor(3, discrete)(_t(obs))
        for g, w in zip(got if not discrete else [got], want if not discrete else [want]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _dict_obs(rng):
    """Three leaves whose JAX order (by ``str`` of the key path) is neither
    their insertion order nor the order of their key-name tuples: ``' '``
    sorts before ``"'"`` and ``'B'`` before ``'a'``."""
    return {"a": {"x": rng.standard_normal((4, 2)).astype(np.float32)},
            "a b": rng.standard_normal((4, 3)).astype(np.float32),
            "B": rng.standard_normal((4, 1, 2)).astype(np.float32)}


def test_flatten_dict_obs_takes_the_jax_leaf_order():
    d = _dict_obs(np.random.default_rng(1))
    jobs = JBatch({"a": {"x": jnp.asarray(d["a"]["x"])}, "a b": jnp.asarray(d["a b"]), "B": jnp.asarray(d["B"])})
    want = np.asarray(jm.flatten_dict_obs(jobs))
    got = tm.flatten_dict_obs(Batch({"a": {"x": _t(d["a"]["x"])}, "a b": _t(d["a b"]), "B": _t(d["B"])}))
    np.testing.assert_array_equal(got.numpy(), want)
    # B, then "a b", then a.x: neither insertion order nor sorted key tuples
    np.testing.assert_array_equal(got.numpy(), np.concatenate([d["B"].reshape(4, -1), d["a b"], d["a"]["x"]], -1))
    assert not np.array_equal(got.numpy(), np.concatenate([d["B"].reshape(4, -1), d["a"]["x"], d["a b"]], -1))
    plain = {"a": {"x": _t(d["a"]["x"])}, "a b": _t(d["a b"]), "B": _t(d["B"])}  # a plain dict too
    assert torch.equal(tm.flatten_dict_obs(plain), got)


def test_dict_obs_net_matches_jax():
    d = _dict_obs(np.random.default_rng(2))
    jobs = JBatch({"a": {"x": jnp.asarray(d["a"]["x"])}, "a b": jnp.asarray(d["a b"]), "B": jnp.asarray(d["B"])})
    m = jm.DictObsNet(jm.Net((8,), 3))
    p = m.init(jax.random.key(3), jobs)
    net = tm.DictObsNet(tm.Net((8,), 3, input_dim=7))
    net.load_state_dict(dict_obs_net_params_from_flax(_np_tree(p), net_params_from_flax))
    with torch.no_grad():
        got = net(Batch({"a": {"x": _t(d["a"]["x"])}, "a b": _t(d["a b"]), "B": _t(d["B"])}))
        flat = net(tm.flatten_dict_obs(Batch({"a": {"x": _t(d["a"]["x"])}, "a b": _t(d["a b"]), "B": _t(d["B"])})))
    np.testing.assert_allclose(got.numpy(), np.asarray(m.apply(p, jobs)), **TOL)
    assert torch.equal(got, flat)  # a tensor passes through unflattened


# ---------------------------------------------------------------------------
# BDQN
# ---------------------------------------------------------------------------
def _example(jax_side):
    ex = dict(obs=np.zeros(OBS, np.float32), act=np.zeros(K, np.int32), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False), obs_next=np.zeros(OBS, np.float32))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


@pytest.fixture(scope="module")
def filled():
    rng = np.random.default_rng(0)
    jb, tb = JVRB(E * C, E), VectorReplayBuffer(E * C, E)
    js, ts = jb.init(_example(True)), tb.init(_example(False), device="cpu")
    for _ in range(11):
        step = dict(obs=rng.standard_normal((E, OBS)).astype(np.float32),
                    act=rng.integers(0, A, (E, K)).astype(np.int32), rew=rng.standard_normal(E).astype(np.float32),
                    terminated=rng.random(E) < 0.15, truncated=rng.random(E) < 0.05,
                    obs_next=rng.standard_normal((E, OBS)).astype(np.float32))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}))
    return jb, js, tb, ts, rng.integers(0, E * 11, B)


def _algos(**kw):
    kw = dict(gamma=0.9, target_update_freq=2, **kw)
    jalgo = JBDQN(model=jm.BranchingNet((16,), K, A, value_hidden=(8,), branch_hidden=12),
                  action_space=jcore.MultiDiscrete([A] * K), optim=JAdam(lr=1e-3), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(OBS))
    net = tm.BranchingNet((16,), K, A, value_hidden=(8,), branch_hidden=12, input_dim=OBS)
    net.load_state_dict(branching_net_params_from_flax(_np_tree(jts.params["model"])))
    talgo = BDQN(model=net, action_space=tcore.MultiDiscrete([A] * K), optim=AdamOptimizerFactory(lr=1e-3), **kw)
    return jalgo, jts, talgo, talgo.init("cpu")


@pytest.mark.parametrize("n_step,is_double", [(1, True), (3, True), (1, False)], ids=["n1", "n3", "single"])
def test_one_bdqn_update_matches_jax(filled, n_step, is_double):
    jb, js, tb, ts, idx = filled
    jalgo, jts, talgo, tts = _algos(n_step_return_horizon=n_step, is_double=is_double)
    assert talgo.update_sample_drop_keys == jalgo.update_sample_drop_keys
    jidx, tidx = jnp.asarray(idx), torch.from_numpy(idx)
    jbatch = jalgo.preprocess(jts, jb, js, jb.get(js, jidx, drop_keys=jalgo.update_sample_drop_keys), jidx,
                              jax.random.key(1))
    tbatch = talgo.preprocess(tts, tb, ts, tb.get(ts, tidx, drop_keys=talgo.update_sample_drop_keys), tidx,
                              torch.Generator())
    assert tbatch.act.shape == (B, K) and tbatch.returns.shape == (B,)
    np.testing.assert_allclose(tbatch.returns.numpy(), np.asarray(jbatch.returns), **TOL)
    jts2, jstats = jalgo.update_step(jts, jbatch, jax.random.key(2))
    tts, tstats = talgo.update_step(tts, tbatch)
    np.testing.assert_allclose(tstats.loss.item(), float(jstats.loss), **TOL)
    np.testing.assert_allclose(tstats.td_error.numpy(), np.asarray(jstats.td_error), **TOL)
    want = branching_net_params_from_flax(_np_tree(jts2.params["model"]))
    for k, v in tts.model.state_dict().items():
        got, w = v.numpy(), want[k].numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=2e-5, err_msg=k)
        assert np.mean(np.abs(got - w) <= 2e-6) >= 0.999, k
    assert int(tts.step) == int(jts2.step) == 1


def test_bdqn_defaults_and_acting(filled):
    jalgo, jts, talgo, tts = _algos()
    assert talgo.n_step == jalgo.n_step == 1 and talgo.is_discrete
    obs = filled[2].get(filled[3], torch.from_numpy(filled[4]), keys=("obs",)).obs
    out = talgo.forward(tts, obs, torch.Generator())
    jout = jalgo.forward(jts, jnp.asarray(obs.numpy()), jax.random.key(0))
    assert out.act.shape == (B, K)
    np.testing.assert_array_equal(out.act.numpy(), np.asarray(jout.act))
    assert torch.equal(talgo.map_action(out.act), out.act)  # MultiDiscrete actions pass unchanged


def test_bdqn_explores_per_sample_over_the_whole_branch_vector(filled):
    _, _, talgo, tts = _algos()
    act = torch.zeros((4096, K), dtype=torch.int64)
    g = torch.Generator().manual_seed(0)
    tts.hparams["eps_training"].fill_(0.5)
    out = talgo.exploration_noise(tts, act, None, g)
    explored = (out != 0).any(-1)
    share = float(explored.float().mean())
    # a sample explores with probability 0.5, then every branch draws: all zero with 1 / A^K
    assert abs(share - 0.5 * (1 - 1 / A**K)) < 0.03 and int(out.max()) == A - 1
    g2 = torch.Generator().manual_seed(0)
    rand = torch.randint(0, A, act.shape, generator=g2, dtype=act.dtype)
    u = torch.rand(4096, generator=g2)
    assert torch.equal(out, torch.where((u < 0.5)[:, None], rand, act))  # one uniform per sample
    assert torch.equal(talgo.exploration_noise(tts, act, None, g, training=False), act)  # eps_inference 0


def test_stats_from_max_episodes():
    coll = DeviceCollector(tcore.VectorDeviceEnv(CartPole(), 2, device="cpu"), None, None)
    done = torch.tensor([[False, True], [True, False], [False, True]])
    out = Batch(done=done, ep_ret=torch.arange(6.0).reshape(3, 2), ep_len=torch.arange(6).reshape(3, 2))
    full, first = coll.stats_from(out), coll.stats_from(out, max_episodes=2)
    assert full.n_collected_episodes == 3 and list(full.returns) == [1.0, 2.0, 5.0]
    assert first.n_collected_episodes == 2 and list(first.returns) == [1.0, 2.0] and list(first.lens) == [1, 2]
    assert first.n_collected_steps == full.n_collected_steps == 6
