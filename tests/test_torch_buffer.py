"""Parity of the port's replay buffer (tianshou_tpu_torch/data/buffer/base.py)
with the JAX package's (tianshou_tpu/data/buffer/base.py).

The same transitions, made from a numpy seed, are added to both buffers:
3 env rings of 7 slots, 12 steps so that every ring wraps, one masked add,
frame stack 4, under both ``save_only_last_obs`` settings and both
``ignore_obs_next`` settings. Rings, cursors, ``prev``/``next``, ``get``
(with its ``keys``/``drop_keys`` restrictions and the ignore-obs_next
reconstruction), ``_stacked`` (with the episode-start clamp) and
``n_step_gather`` are then held BIT-EXACT on the same indices: they are
integer index math and copies. ``sample_indices`` draws from another RNG
stream, so it is checked for range and validity only.

The host-level utilities are held bit-exact too: ``get_buffer_indices`` on
every span of every ring (wrapping, whole-ring and malformed spans: the
same result or the same exception), ``chronological_indices``,
``num_stored``, also on partly filled rings, and ``update`` merging every
pair's rows into a 16-slot single ring (rings and cursors). And the
collector's policy-state carry: a stand-in stateful policy on
``MoveToRightEnv`` gives the JAX collector's actions, episode ends and
carried state, reset to zero where an episode ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import VectorReplayBuffer as JVRB
from tianshou_tpu_torch.data.batch import Batch as TBatch
from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer as TVRB
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

E, SIZE, STEPS, STACK, HW = 3, 21, 12, 4, (6, 6, 1)


def _transitions(rng, save_only_last_obs):
    shape = (STEPS, E, STACK) + HW if save_only_last_obs else (STEPS, E) + HW
    return dict(
        obs=rng.integers(0, 256, shape, dtype=np.uint8),
        obs_next=rng.integers(0, 256, shape, dtype=np.uint8),
        act=rng.integers(0, 6, (STEPS, E)).astype(np.int32),
        rew=rng.standard_normal((STEPS, E)).astype(np.float32),
        terminated=rng.random((STEPS, E)) < 0.2,
        truncated=rng.random((STEPS, E)) < 0.1,
    )


@pytest.fixture(scope="module", params=[(False, False), (True, False), (False, True), (True, True)],
                ids=["plain", "last_obs", "ignore_next", "last_obs+ignore_next"])
def pair(request):
    save_only_last_obs, ignore_obs_next = request.param
    kw = dict(stack_num=STACK, save_only_last_obs=save_only_last_obs, ignore_obs_next=ignore_obs_next)
    jb, tb = JVRB(SIZE, E, **kw), TVRB(SIZE, E, **kw)
    ex = dict(obs=np.zeros(HW, np.uint8), obs_next=np.zeros(HW, np.uint8), act=np.int32(0),
              rew=np.float32(0), terminated=np.bool_(False), truncated=np.bool_(False))
    js = jb.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    ts = tb.init(TBatch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()}), device="cpu")
    tr = _transitions(np.random.default_rng(0), save_only_last_obs)
    mask = np.array([True, False, True])
    for t in range(STEPS):
        step = {k: v[t] for k, v in tr.items()}
        m = mask if t == 5 else None
        js, jinfo = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}),
                           None if m is None else jnp.asarray(m))
        ts, tinfo = tb.add(ts, TBatch({k: torch.from_numpy(v) for k, v in step.items()}),
                           None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(tinfo.indices.numpy(), np.asarray(jinfo.indices))
        np.testing.assert_array_equal(tinfo.done.numpy(), np.asarray(jinfo.done))
    return jb, js, tb, ts


def _eq(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_array_equal(t, j.astype(t.dtype) if j.dtype != t.dtype else j)


def _eq_batch(tb, jb):
    assert set(tb.keys()) == set(jb.keys())
    for k in jb.keys():
        _eq(tb[k], jb[k])


ALL = np.arange(E * 7)


def test_add_writes_identical_rings(pair):
    jb, js, tb, ts = pair
    assert tb.capacity == jb.capacity == 7
    _eq_batch(ts.data, js.data)
    for f in ("cursor", "size", "last_idx"):
        _eq(getattr(ts, f), getattr(js, f))


def test_prev_next_bit_exact(pair):
    jb, js, tb, ts = pair
    idx_t, idx_j = torch.from_numpy(ALL), jnp.asarray(ALL)
    _eq(tb.prev(ts, idx_t), jb.prev(js, idx_j))
    _eq(tb.next(ts, idx_t), jb.next(js, idx_j))


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"keys": ("obs_next", "terminated")}, {"drop_keys": ("obs_next",)}, {"stack_num": 1},
     {"keys": ("obs", "rew", "done")}],
    ids=["all", "terminal_keys", "drop_obs_next", "stack1", "obs_rew_done"],
)
def test_get_bit_exact(pair, kwargs):
    jb, js, tb, ts = pair
    idx = np.array([0, 3, 6, 7, 13, 14, 20, 20, 5], np.int64)
    _eq_batch(tb.get(ts, torch.from_numpy(idx), **kwargs), jb.get(js, jnp.asarray(idx), **kwargs))


def test_stacked_bit_exact_with_episode_start_clamp(pair):
    jb, js, tb, ts = pair
    got = tb._stacked(ts, torch.from_numpy(ALL), "obs", STACK)
    want = jb._stacked(js, jnp.asarray(ALL), "obs", STACK)
    _eq(got, want)
    # at least one sample repeats its earliest frame (an episode start inside the stack)
    chain_rep = (got[:, 0] == got[:, 1]).flatten(1).all(1)
    assert bool(chain_rep.any())


@pytest.mark.parametrize("n", [1, 3])
def test_n_step_gather_bit_exact(pair, n):
    jb, js, tb, ts = pair
    got = tb.n_step_gather(ts, torch.from_numpy(ALL), n)
    want = jb.n_step_gather(js, jnp.asarray(ALL), n)
    for g, w in zip(got, want):
        _eq(g, w)


def test_avail_mask_bit_exact(pair):
    jb, js, tb, ts = pair
    _eq(tb._avail_mask(ts), jb._avail_mask(js))


def test_sample_indices_range_and_validity(pair):
    _, _, tb, ts = pair
    g = torch.Generator().manual_seed(0)
    idx = tb.sample_indices(ts, g, 512)
    assert idx.dtype == torch.int64 and idx.shape == (512,)
    env, slot = idx // tb.capacity, idx % tb.capacity
    assert bool(((env >= 0) & (env < E)).all())
    assert bool((slot < ts.size[env]).all())
    # every stored entry is reachable
    assert len(set(idx.tolist())) == int(ts.size.sum())
    tb.sample_avail = True
    try:
        ok = tb._avail_mask(ts)
        assert bool(ok[tb.sample_indices(ts, g, 256)].all())
    finally:
        tb.sample_avail = False


def test_add_rollout_matches_jax():
    rng = np.random.default_rng(7)
    kw = dict(stack_num=STACK, save_only_last_obs=True)
    jb, tb = JVRB(SIZE, E, **kw), TVRB(SIZE, E, **kw)
    ex = dict(obs=np.zeros(HW, np.uint8), act=np.int32(0), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False))
    js = jb.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    ts = tb.init(TBatch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()}), device="cpu")
    tr = _transitions(rng, True)
    del tr["obs_next"]
    tr = {k: tr[k] for k in ex}  # the JAX Batch pytree matches keys in order
    js = jb.add_rollout(js, JBatch({k: jnp.asarray(v) for k, v in tr.items()}))
    ts = tb.add_rollout(ts, TBatch({k: torch.from_numpy(v) for k, v in tr.items()}))
    _eq_batch(ts.data, js.data)
    for f in ("cursor", "size", "last_idx"):
        _eq(getattr(ts, f), getattr(js, f))


def test_sample_indices_partial_rings_stay_in_stored_slots():
    tb = TVRB(40, 4)
    ts = tb.init(TBatch(obs=torch.zeros(2), act=torch.tensor(0), rew=torch.tensor(0.0),
                        terminated=torch.tensor(False), truncated=torch.tensor(False)), device="cpu")
    for t in range(3):
        step = TBatch(obs=torch.full((4, 2), float(t)), act=torch.zeros(4, dtype=torch.int64),
                      rew=torch.zeros(4), terminated=torch.zeros(4, dtype=torch.bool),
                      truncated=torch.zeros(4, dtype=torch.bool))
        tb.add(ts, step, mask=torch.tensor([True, t < 1, False, True]))
    idx = tb.sample_indices(ts, torch.Generator().manual_seed(1), 1000)
    env, slot = idx // tb.capacity, idx % tb.capacity
    assert set(env.tolist()) == {0, 1, 3}
    assert bool((slot < ts.size[env]).all())


def test_init_raises_without_cuda_and_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TVRB(8, 2).init(TBatch(obs=torch.zeros(2), act=torch.tensor(0), rew=torch.tensor(0.0),
                               terminated=torch.tensor(False), truncated=torch.tensor(False)))


def test_n_step_return_at_an_unfinished_episode_follows_the_jax_package():
    """A deviation inherited from the JAX package, pinned: at the newest row of
    an episode that has not finished, ``next`` stays put while the episode-end
    flag is only ``done``, so the chain repeats that row's reward and the
    bootstrap is discounted by gamma**n. One env, rewards 1, 2, 3, 4 with none
    done, n = 3, gamma 0.99, target Q = 0, indices [1, 2, 3]: both packages
    give [8.8904, 10.8804, 11.8804]. Upstream tianshou's
    ``compute_nstep_return`` marks the unfinished row as an end
    (``end_flag[buffer.unfinished_index()] = True``) and gives
    [8.8904, 6.96, 4.0]."""
    from tianshou_tpu.ops.returns import nstep_returns as jnstep
    from tianshou_tpu_torch.ops.returns import nstep_returns as tnstep

    upstream = np.array([8.8904, 6.96, 4.0], np.float32)
    jb, tb = JVRB(8, 1), TVRB(8, 1)
    ex = dict(obs=np.zeros(2, np.float32), act=np.int32(0), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False))
    js = jb.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    ts = tb.init(TBatch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()}), device="cpu")
    for r in (1.0, 2.0, 3.0, 4.0):
        step = dict(obs=np.zeros((1, 2), np.float32), act=np.zeros(1, np.int32), rew=np.full(1, r, np.float32),
                    terminated=np.zeros(1, bool), truncated=np.zeros(1, bool))
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}))
        tb.add(ts, TBatch({k: torch.from_numpy(v) for k, v in step.items()}))
    idx = np.array([1, 2, 3], np.int64)
    jr, je, _ = jb.n_step_gather(js, jnp.asarray(idx), 3)
    tr, te, _ = tb.n_step_gather(ts, torch.from_numpy(idx), 3)
    want = np.asarray(jnstep(jr, je, jnp.zeros(3, jnp.float32), 0.99))
    got = tnstep(tr, te, torch.zeros(3), 0.99).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, [8.8904, 10.8804, 11.8804], rtol=1e-6)
    assert np.isclose(got[0], upstream[0], rtol=1e-6) and not np.allclose(got[1:], upstream[1:])


# ---------------------------------------------------------------------------
# host-level episode and merge utilities, and the collector's policy-state carry
def _spans(tb, ts):
    """(start, stop) pairs in every ring: whole rings, wraps, one entry, and the malformed cases."""
    C = tb.capacity
    out = []
    for env in range(tb.num_envs):
        size = int(ts.size[env])
        base = env * C
        out += [(base + a, base + b) for a in range(C) for b in range(C)]
        out += [(base + size - 1, base), (base, base + C - 1)]
    out += [(0, C + 1), (-1, 3), (E * C, E * C + 1)]
    return out


def _outcome(fn, *args):
    try:
        return ("ok", np.asarray(fn(*args)))
    except (ValueError, NotImplementedError) as e:
        return ("raises", type(e).__name__)


def test_get_buffer_indices_and_chronological_indices_bit_exact(pair):
    jb, js, tb, ts = pair
    for start, stop in _spans(tb, ts):
        got, want = _outcome(tb.get_buffer_indices, ts, start, stop), _outcome(jb.get_buffer_indices, js, start, stop)
        assert got[0] == want[0], (start, stop)
        if got[0] == "ok":
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] == want[1]
    for env in range(E):
        np.testing.assert_array_equal(tb.chronological_indices(ts, env), jb.chronological_indices(js, env))
    assert int(tb.num_stored(ts)) == int(jb.num_stored(js)) == 21


def test_partial_rings_indices_bit_exact():
    jb, tb = JVRB(SIZE, E), TVRB(SIZE, E)
    ex = dict(obs=np.zeros(2, np.float32), act=np.int32(0), rew=np.float32(0), terminated=np.bool_(False),
              truncated=np.bool_(False))
    js = jb.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    ts = tb.init(TBatch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()}), device="cpu")
    rng = np.random.default_rng(3)
    for i in range(4):
        step = dict(obs=rng.normal(size=(E, 2)).astype(np.float32), act=np.full(E, i, np.int32),
                    rew=rng.normal(size=E).astype(np.float32), terminated=rng.random(E) < 0.3, truncated=np.zeros(E, bool))
        m = np.array([True, i % 2 == 0, i < 1])
        js, _ = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}), jnp.asarray(m))
        tb.add(ts, TBatch({k: torch.from_numpy(v) for k, v in step.items()}), torch.from_numpy(m))
    assert ts.size.tolist() == [4, 2, 1]
    for start, stop in _spans(tb, ts):
        got, want = _outcome(tb.get_buffer_indices, ts, start, stop), _outcome(jb.get_buffer_indices, js, start, stop)
        assert got[0] == want[0] and (got[0] != "ok" or np.array_equal(got[1], want[1])), (start, stop)
    for env in range(E):
        np.testing.assert_array_equal(tb.chronological_indices(ts, env), jb.chronological_indices(js, env))
    assert int(tb.num_stored(ts)) == int(jb.num_stored(js)) == 7


def test_update_merges_bit_exact(pair):
    jb, js, tb, ts = pair
    jdst, tdst = JVRB(16, 1), TVRB(16, 1)  # 21 stored rows wrap the 16-slot ring
    # the destination's keys in the source's order (the JAX package's scan adds the rows as one pytree)
    ex = {k: np.asarray(v)[0] for k, v in tb.get(ts, torch.arange(1), stack_num=1).items()}
    jstate = jdst.init(JBatch({k: jnp.asarray(v) for k, v in ex.items()}))
    tstate = tdst.init(TBatch({k: torch.as_tensor(v) for k, v in ex.items()}), device="cpu")
    jstate = jdst.update(jstate, jb, js)
    assert tdst.update(tstate, tb, ts) is tstate
    _eq_batch(tstate.data, jstate.data)
    for f in ("cursor", "size", "last_idx"):
        _eq(getattr(tstate, f), getattr(jstate, f))
    with pytest.raises(NotImplementedError):
        tb.update(ts, tb, ts)


def test_collector_carries_and_resets_a_policy_state_as_jax():
    """A stand-in stateful policy on ``MoveToRightEnv``: its state counts the
    steps of the episode (plus the observation), it moves right where the
    count is odd, and the collector resets it to zero where an episode ends.
    Two chunks of 7 steps over 3 envs: actions, the carried state and the
    episode ends equal to the JAX collector's."""
    from tianshou_tpu.algorithm.base import ActOut as JActOut
    from tianshou_tpu.algorithm.base import Algorithm as JAlgorithm
    from tianshou_tpu.algorithm.base import TrainState as JTrainState
    from tianshou_tpu.data.collector import DeviceCollector as JCollector
    from tianshou_tpu.env.core import VectorDeviceEnv as JVenv
    from tianshou_tpu.env.testing import MoveToRightEnv as JMoveToRightEnv
    from tianshou_tpu_torch.algorithm.base import ActOut, Algorithm, TrainState
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.testing import MoveToRightEnv

    class JCounting(JAlgorithm):
        def init(self, key, obs_example):
            return JTrainState(params={}, target_params={}, opt_state={}, hparams=JBatch(), extra=JBatch(),
                               step=jnp.int32(0))

        def init_policy_state(self, num_envs):
            return JBatch(h=jnp.zeros(num_envs, jnp.int32))

        def forward(self, ts, obs, key, state=None, deterministic=False):
            h = state.h + 1 + obs[:, 0].astype(jnp.int32)
            return JActOut(act=(h % 2).astype(jnp.int32), state=JBatch(h=h), info=JBatch())

    class Counting(Algorithm):
        def init(self, device=None):
            return TrainState(model=torch.nn.Module(), target=None, optim=None, hparams={},
                              step=torch.zeros((), dtype=torch.int64))

        def init_policy_state(self, num_envs, device=None):
            return TBatch(h=torch.zeros(num_envs, dtype=torch.int32, device=device))

        def forward(self, ts, obs, generator=None, state=None, deterministic=False):
            h = state.h + 1 + obs[:, 0].to(torch.int32)
            return ActOut(act=(h % 2).to(torch.int64), state=TBatch(h=h), info=TBatch())

    n_envs, steps = 3, 7
    jenv, env = JMoveToRightEnv(size=3, max_episode_steps=5), MoveToRightEnv(size=3, max_episode_steps=5)
    jalgo, algo = JCounting(jenv.action_space), Counting(env.action_space)
    jcoll = JCollector(JVenv(jenv, n_envs), jalgo, None)
    coll = DeviceCollector(VectorDeviceEnv(env, n_envs, device="cpu"), algo, None)
    jts, ts = jalgo.init(None, None), algo.init()
    jcs = jcoll.reset(jax.random.key(0))
    cs = coll.reset(torch.Generator())
    state = cs.policy_state
    ends = 0
    for chunk in range(2):
        jcs, _, jout = jcoll.collect(jts, jcs, None, jax.random.key(chunk), steps, keep_rollout=True)
        _, _, out = coll.collect(ts, cs, None, torch.Generator(), steps, keep_rollout=True)
        assert cs.policy_state is state  # written in place
        _eq(out.rollout.act, jout.rollout.act)
        _eq(out.done, jout.done)
        _eq(cs.policy_state.h, jcs.policy_state.h)
        ends += int(out.done.sum())
        assert bool((cs.policy_state.h[out.done[-1]] == 0).all())
    assert ends >= 2
