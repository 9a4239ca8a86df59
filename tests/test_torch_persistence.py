"""Persistence in the port (``tianshou_tpu_torch.utils.persistence``) against
the JAX package's (``tianshou_tpu.utils.persistence``).

- HDF5 buffers cross between the packages: a ``BufferState``, a PER
  ``PrioState`` (its sum tree and max/min priority) and a ``CachedState``
  filled with the same transitions in both (the two fills agree bit for bit
  but for the PER tree and max/min priority, at rtol 1e-6: ``prio ** alpha``
  may differ by an ulp), saved by either package and read by the other,
  equal the writer's state bit for bit (the port's ring indices are int64,
  the JAX package's int32: the values are compared), with ``Batch`` key
  order, dtypes and nested dict observations kept.
- ``buffer_from_data``, ``buffer_from_d4rl`` and ``load_d4rl_hdf5`` give the
  JAX package's rows, flags and ring indices bit for bit (float64 input
  becomes float32 in both), and ``next`` / ``get`` read them alike.
- Train states: a DQN train state after three updates, saved and restored
  into a fresh train state, is bit-identical (weights, target, Adam's state,
  step, hyper-parameters), and an update after the restore equals the update
  without it bit for bit; a multi-agent dict of train states and an
  actor-critic dict of optimizers round-trip too.
- Twins of the HDF5 cases of ``tests/test_buffer_battery.py:186-230``,
  ``tests/test_utils_infra.py:83-158`` and ``tests/test_d4rl_ingestion.py:38-78``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import ReplayBuffer as JRB
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu.data.buffer.cached import CachedReplayBuffer as JCached
from tianshou_tpu.data.buffer.prio import PrioritizedVectorReplayBuffer as JPVRB
from tianshou_tpu.utils import persistence as jp
from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import BufferState, ReplayBuffer, VectorReplayBuffer
from tianshou_tpu_torch.data.buffer.cached import CachedReplayBuffer, CachedState
from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer, PrioState
from tianshou_tpu_torch.env.core import Box, Discrete
from tianshou_tpu_torch.models.continuous import ContinuousActorProbabilistic, ContinuousCritic
from tianshou_tpu_torch.models.mlp import Net
from tianshou_tpu_torch.utils import persistence as tp
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, OBS = 2, 3


def example(jax_side: bool, dict_obs: bool = False):
    obs = dict(image=np.zeros((2, 2), np.uint8), state=np.zeros(OBS, np.float32)) if dict_obs else np.zeros(
        OBS, np.float32)
    d = dict(obs=obs, act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False), truncated=np.bool_(False),
             obs_next=obs)
    return convert(d, jax_side)


def convert(d, jax_side: bool):
    if isinstance(d, dict):
        return (JBatch if jax_side else Batch)(**{k: convert(v, jax_side) for k, v in d.items()})
    return jnp.asarray(d) if jax_side else torch.as_tensor(np.asarray(d))


def transitions(n: int, seed: int = 0, dict_obs: bool = False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        def ob():
            if dict_obs:
                return dict(image=rng.integers(0, 255, (E, 2, 2)).astype(np.uint8),
                            state=rng.normal(size=(E, OBS)).astype(np.float32))
            return rng.normal(size=(E, OBS)).astype(np.float32)
        term = rng.random(E) < 0.2
        out.append(dict(obs=ob(), act=rng.integers(0, 4, E).astype(np.int32), rew=rng.normal(size=E).astype(np.float32),
                        terminated=term, truncated=(rng.random(E) < 0.1) & ~term, obs_next=ob()))
    return out


def make_pair(kind: str, dict_obs: bool = False):
    if kind == "plain":
        jb, tb = JVRB(16, E), VectorReplayBuffer(16, E)
    elif kind == "prio":
        jb, tb = JPVRB(16, E, alpha=0.6, beta=0.4), PrioritizedVectorReplayBuffer(16, E, alpha=0.6, beta=0.4)
    else:
        jb, tb = JCached(16, E, 8), CachedReplayBuffer(16, E, 8)
    js, ts = jb.init(example(True, dict_obs)), tb.init(example(False, dict_obs), device="cpu")
    jadd = jax.jit(jb.add)  # one compile, not one per op
    for tr in transitions(13, dict_obs=dict_obs):  # wraps the 8-slot rings
        js, _ = jadd(js, convert(tr, True))
        ts, _ = tb.add(ts, convert(tr, False))
    if kind == "prio":  # priorities written back, so that the tree is not uniform
        idx = np.array([0, 3, 9, 12])
        js = jb.update_weight(js, jnp.asarray(idx), jnp.asarray([0.5, 2.0, 1.5, 3.0]))
        ts = tb.update_weight(ts, torch.as_tensor(idx), torch.tensor([0.5, 2.0, 1.5, 3.0]))
    return jb, js, tb, ts


PRIO_FIELDS = ("tree", "max_prio", "min_prio")


def assert_same_tree(port, jax_state, path="state", prio_rtol=0.0):
    """Every leaf equal in value and dtype (ring indices int64 against int32);
    with ``prio_rtol`` the PER tree and max/min priority at that rtol."""
    if isinstance(port, Batch):
        assert isinstance(jax_state, JBatch) and list(port.keys()) == list(jax_state.keys()), path
        for k in port.keys():
            assert_same_tree(port[k], jax_state[k], f"{path}.{k}", prio_rtol)
    elif isinstance(port, (BufferState, PrioState, CachedState)):
        assert type(port).__name__ == type(jax_state).__name__, path
        for k in jax_state._fields:
            assert_same_tree(getattr(port, k), getattr(jax_state, k), f"{path}.{k}", prio_rtol)
    else:
        a, b = port.numpy(), np.asarray(jax_state)
        name = path.rsplit(".", 1)[-1]
        if name in ("cursor", "size", "last_idx"):
            assert (a.dtype, b.dtype) == (np.int64, np.int32), path
        elif name != "act":  # actions: int64 in the port, int32 in JAX (as collected)
            assert a.dtype == b.dtype, path
        if prio_rtol and name in PRIO_FIELDS:
            np.testing.assert_allclose(a, b, rtol=prio_rtol, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


def assert_jax_equal(a, b):
    """Two JAX states equal leaf by leaf (values; int64 read as int32)."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) and type(a).__name__ == type(b).__name__
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def port_leaves(state) -> list[torch.Tensor]:
    if isinstance(state, Batch):
        return [x for k in state.keys() for x in port_leaves(state[k])]
    if isinstance(state, (BufferState, PrioState, CachedState)):
        names = state._fields if isinstance(state, tuple) else [f for f in vars(state)]
        return [x for k in names for x in port_leaves(getattr(state, k))]
    return [state]


def assert_port_equal(a, b):
    la, lb = port_leaves(a), port_leaves(b)
    assert len(la) == len(lb) and type(a) is type(b)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("kind", ["plain", "prio", "cached"])
def test_hdf5_files_cross_between_the_packages(kind, tmp_path):
    jb, js, tb, ts = make_pair(kind)
    assert_same_tree(ts, js, prio_rtol=1e-6)  # the two fills agree (``prio ** alpha``: an ulp apart at most)
    jp.save_buffer_hdf5(str(tmp_path / "jax.h5"), js)
    tp.save_buffer_hdf5(str(tmp_path / "port.h5"), ts)
    from_jax = tp.load_buffer_hdf5(str(tmp_path / "jax.h5"), device="cpu")
    assert_same_tree(from_jax, js)  # the JAX file's state, bit for bit
    assert_port_equal(tp.load_buffer_hdf5(str(tmp_path / "port.h5"), device="cpu"), ts)
    # the JAX package reads the port's file as the port's state (int32 indices under its x64 default)
    assert_same_tree(ts, jp.load_buffer_hdf5(str(tmp_path / "port.h5")))
    assert_jax_equal(jp.load_buffer_hdf5(str(tmp_path / "jax.h5")), js)
    # the port samples from the state read from the JAX file as from its own
    if kind != "cached":
        idx = torch.tensor([0, 5, 9, 15])
        for k, v in tb.get(from_jax, idx).items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jb.get(js, jnp.asarray(idx.numpy()))[k]), err_msg=k)


def test_hdf5_roundtrip_preserves_ring_topology(tmp_path):
    """``tests/test_buffer_battery.py:186``: saved mid-wraparound, the loaded
    state's cursors, links and sampled batch are the saved one's."""
    _, js, tb, ts = make_pair("plain")
    path = str(tmp_path / "buf.h5")
    tp.save_buffer_hdf5(path, ts)
    loaded = tp.load_buffer_hdf5(path, device="cpu")
    assert type(loaded) is BufferState
    for k in ("cursor", "size", "last_idx"):
        assert torch.equal(getattr(loaded, k), getattr(ts, k)), k
    for k in ts.data.keys():
        assert torch.equal(loaded.data[k], ts.data[k]), k
    idx = torch.arange(16)
    assert torch.equal(tb.next(loaded, idx), tb.next(ts, idx)) and torch.equal(tb.prev(loaded, idx), tb.prev(ts, idx))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    b1, i1 = tb.sample(ts, g1, 16)
    b2, i2 = tb.sample(loaded, g2, 16)
    assert torch.equal(i1, i2) and torch.equal(b1.obs, b2.obs)


def test_hdf5_roundtrip_dict_obs_across_packages(tmp_path):
    """``tests/test_buffer_battery.py:210``: nested observations keep their
    keys, order and uint8 dtype, read by either package."""
    jb, js, tb, ts = make_pair("plain", dict_obs=True)
    tp.save_buffer_hdf5(str(tmp_path / "port.h5"), ts)
    loaded = tp.load_buffer_hdf5(str(tmp_path / "port.h5"), device="cpu")
    assert list(loaded.data.obs.keys()) == ["image", "state"] and loaded.data.obs.image.dtype == torch.uint8
    assert_same_tree(loaded, js)
    back = jp.load_buffer_hdf5(str(tmp_path / "port.h5"))
    assert back.data.obs.image.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(back.data.obs.image), np.asarray(js.data.obs.image))


def test_legacy_flat_layout_is_read(tmp_path):
    """The JAX package's first layout (flat ``data`` / ``cursor`` / ``size`` /
    ``last_idx``) is read into a ``BufferState``."""
    _, js, _, ts = make_pair("plain")
    path = str(tmp_path / "legacy.h5")
    with h5py.File(path, "w") as f:
        jp._write_tree(f, "data", js.data)
        for k in ("cursor", "size", "last_idx"):
            f.create_dataset(k, data=np.asarray(getattr(js, k)))
    assert_same_tree(tp.load_buffer_hdf5(path, device="cpu"), js)


def d4rl_dict(n=200, obs_dim=3, seed=0, float64=False):
    """``tests/test_d4rl_ingestion.py:17``'s dataset: 50-step episodes, a
    mid-episode timeout and one on a terminal."""
    rng = np.random.default_rng(seed)
    terminals = np.zeros(n, bool)
    terminals[49::50] = True
    timeouts = np.zeros(n, bool)
    timeouts[[75, 99]] = True
    dt = np.float64 if float64 else np.float32
    return {"observations": rng.standard_normal((n, obs_dim)).astype(dt),
            "actions": rng.uniform(-1, 1, (n, 1)).astype(dt), "rewards": rng.standard_normal(n).astype(dt),
            "terminals": terminals, "timeouts": timeouts,
            "next_observations": rng.standard_normal((n, obs_dim)).astype(dt)}


@pytest.mark.parametrize("float64", [False, True], ids=["float32", "float64"])
def test_d4rl_loaders_give_the_jax_rows(float64, tmp_path):
    data = d4rl_dict(float64=float64)
    path = str(tmp_path / "toy_d4rl.hdf5")
    with h5py.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v)
    jbuf, js = jp.load_d4rl_hdf5(path)
    tbuf, ts = tp.load_d4rl_hdf5(path, device="cpu")
    assert_same_tree(ts, js)
    assert ts.data.obs.dtype == torch.float32 and int(tbuf.num_stored(ts)) == int(jbuf.num_stored(js)) == 200
    _, ts2 = tp.buffer_from_d4rl(data, device="cpu")
    assert_same_tree(ts2, js)
    # terminals win over timeouts; next() stops at a terminal
    assert not bool(ts.data.truncated[0][49]) and not bool(ts.data.truncated[0][99]) and bool(ts.data.truncated[0][75])
    np.testing.assert_array_equal(tbuf.next(ts, torch.tensor([48, 49, 50])).numpy(), [49, 49, 51])
    idx = np.array([0, 49, 75, 199])
    got, want = tbuf.get(ts, torch.as_tensor(idx)), jbuf.get(js, jnp.asarray(idx))
    for k in ("obs", "act", "rew", "obs_next", "terminated", "truncated", "done"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_buffer_from_data_and_d4rl_without_timeouts():
    rng = np.random.default_rng(1)
    n = 50
    d = {"observations": rng.standard_normal((n, 2)).astype(np.float32),
         "actions": rng.standard_normal((n, 1)).astype(np.float32), "rewards": np.ones(n, np.float32),
         "terminals": rng.random(n) < 0.1, "next_observations": rng.standard_normal((n, 2)).astype(np.float32)}
    _, js = jp.buffer_from_d4rl(d)
    buf, ts = tp.buffer_from_d4rl(d, device="cpu")
    assert_same_tree(ts, js)
    assert int(buf.num_stored(ts)) == n and not bool(ts.data.truncated.any())
    arrays = dict(obs=d["observations"], act=np.arange(n, dtype=np.int64) % 3, rew=d["rewards"],
                  terminated=d["terminals"], truncated=np.zeros(n, bool), obs_next=d["next_observations"])
    jbuf, js = jp.buffer_from_data(JRB, **arrays)
    tbuf, ts = tp.buffer_from_data(ReplayBuffer, **arrays, device="cpu")
    assert isinstance(tbuf, ReplayBuffer) and tbuf.capacity == jbuf.capacity == n
    for k in ("obs", "rew", "terminated", "truncated", "done", "obs_next"):
        np.testing.assert_array_equal(ts.data[k].numpy(), np.asarray(js.data[k]), err_msg=k)
    np.testing.assert_array_equal(ts.data.act.numpy(), np.asarray(js.data.act))
    batch, idx = tbuf.sample(ts, torch.Generator().manual_seed(0), 16)
    assert batch.obs.shape == (16, 2)
    np.testing.assert_array_equal(batch.obs.numpy(), d["observations"][idx.numpy()])


# ---------------------------------------------------------------------------
# train states
# ---------------------------------------------------------------------------
def small_dqn(seed: int):
    torch.manual_seed(seed)
    return DQN(model=Net((16, 16), 2, input_dim=4), action_space=Discrete(2), optim=AdamOptimizerFactory(lr=1e-3),
               gamma=0.97, n_step_return_horizon=2, target_update_freq=2, eps_training=0.2)


def filled_cartpole_like():
    buf = VectorReplayBuffer(64, 2)
    rng = np.random.default_rng(0)
    state = buf.init(Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0), terminated=torch.tensor(False),
                           truncated=torch.tensor(False), obs_next=torch.zeros(4)), device="cpu")
    for _ in range(20):
        state, _ = buf.add(state, Batch(obs=torch.as_tensor(rng.normal(size=(2, 4)), dtype=torch.float32),
                                        act=torch.as_tensor(rng.integers(0, 2, 2)),
                                        rew=torch.ones(2), terminated=torch.as_tensor(rng.random(2) < 0.1),
                                        truncated=torch.zeros(2, dtype=torch.bool),
                                        obs_next=torch.as_tensor(rng.normal(size=(2, 4)), dtype=torch.float32)))
    return buf, state


def all_tensors(ts) -> list[torch.Tensor]:
    out = list(ts.model.state_dict().values()) + list(ts.target.state_dict().values())
    opts = ts.optim.values() if isinstance(ts.optim, dict) else [ts.optim]
    for opt in opts:
        for st in opt.state.values():
            out += [v for v in st.values() if torch.is_tensor(v)]
    return out + [ts.step] + list(ts.hparams.values()) + list(ts.extra.values())


def test_train_state_round_trip_is_bit_exact_and_training_resumes(tmp_path):
    algo = small_dqn(0)
    buf, bs = filled_cartpole_like()
    ts = algo.init("cpu")
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        algo.update(ts, buf, bs, g, 8)
    ts.hparams["eps_training"].fill_(0.05)
    path = tp.save_train_state(str(tmp_path / "ckpt"), ts)
    assert (tmp_path / "ckpt").is_dir() and path == str(tmp_path / "ckpt")
    fresh = small_dqn(9).init("cpu")  # other weights, no optimizer state yet
    restored = tp.restore_train_state(path, fresh)
    assert restored is fresh
    saved, back = all_tensors(ts), all_tensors(restored)
    assert len(saved) == len(back) > 10
    for a, b in zip(saved, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    idx = Draws(indices=torch.tensor([0, 5, 17, 33, 40, 2, 9, 60]))
    _, _, s1 = algo.update(ts, buf, bs, idx, 8)
    _, _, s2 = algo.update(restored, buf, bs, idx, 8)
    assert torch.equal(s1.loss, s2.loss) and torch.equal(s1.td_error, s2.td_error)
    for a, b in zip(all_tensors(ts), all_tensors(restored)):
        assert torch.equal(a, b)


def test_multi_agent_and_actor_critic_train_states_round_trip(tmp_path):
    from tianshou_tpu_torch.algorithm.multiagent.marl import MARLRandomPolicy, MultiAgentOffPolicyAlgorithm

    torch.manual_seed(0)
    sac = SAC(actor=ContinuousActorProbabilistic((8,), 1, conditioned_sigma=True, input_dim=3),
              critic=ContinuousCritic((8,), input_dim=3, action_dim=1), action_space=Box([-1.0], [1.0]), alpha="auto",
              policy_optim=AdamOptimizerFactory(lr=1e-3), critic_optim=AdamOptimizerFactory(lr=1e-3))
    ts = sac.init("cpu")
    with torch.no_grad():
        ts.model.log_alpha.fill_(0.3)
        for p in ts.target.parameters():
            p.add_(1.0)
    tp.save_train_state(str(tmp_path / "sac"), ts)
    torch.manual_seed(1)
    back = tp.restore_train_state(str(tmp_path / "sac"), sac.init("cpu"))
    for a, b in zip(all_tensors(ts), all_tensors(back)):
        assert torch.equal(a, b)
    marl = MultiAgentOffPolicyAlgorithm([small_dqn(0), MARLRandomPolicy(Discrete(2))], action_space=Discrete(2))
    mts = marl.init("cpu")
    mts["agent0"].step.fill_(7)
    tp.save_train_state(str(tmp_path / "marl"), mts)
    fresh = MultiAgentOffPolicyAlgorithm([small_dqn(5), MARLRandomPolicy(Discrete(2))], action_space=Discrete(2))
    mback = tp.restore_train_state(str(tmp_path / "marl"), fresh.init("cpu"))
    assert int(mback["agent0"].step) == 7
    for a, b in zip(mts["agent0"].model.state_dict().values(), mback["agent0"].model.state_dict().values()):
        assert torch.equal(a, b)
