"""Parity of the port's prioritized replay (tianshou_tpu_torch/data/buffer/prio.py)
with the JAX package's (tianshou_tpu/data/buffer/prio.py): the same
transitions go into both, the same uniforms drive both samplers and the same
TD errors are written back.

Tolerances: ``prio ** alpha`` and ``(leaf / min_prio) ** -beta`` may differ
by an ulp between XLA's and PyTorch's ``pow``, so trees, ``max_prio``,
``min_prio`` and weights are held to rtol 1e-6. Indices are compared exactly,
on a tree copied across from JAX bit for bit (an ulp in a leaf may move a
boundary). Ring contents and ``AddInfo.indices`` are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.buffer.base import BufferState as JBufferState
from tianshou_tpu.data.buffer.prio import PrioritizedVectorReplayBuffer as JPVRB
from tianshou_tpu.data.buffer.prio import PrioState as JPrioState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import BufferState
from tianshou_tpu_torch.data.buffer.prio import PrioritizedReplayBuffer, PrioritizedVectorReplayBuffer, PrioState

E, C = 3, 8
RTOL = dict(rtol=1e-6, atol=0)


def _example(jax_side, obs_shape=(5,)):
    ex = dict(obs=np.zeros(obs_shape, np.float32), act=np.int32(0), rew=np.float32(0),
              terminated=np.bool_(False), truncated=np.bool_(False), obs_next=np.zeros(obs_shape, np.float32))
    if jax_side:
        return JBatch({k: jnp.asarray(v) for k, v in ex.items()})
    return Batch({k: torch.as_tensor(np.asarray(v)) for k, v in ex.items()})


def _step(rng):
    return dict(
        obs=rng.standard_normal((E, 5)).astype(np.float32), act=rng.integers(0, 4, E).astype(np.int32),
        rew=rng.standard_normal(E).astype(np.float32), terminated=rng.random(E) < 0.15,
        truncated=rng.random(E) < 0.05, obs_next=rng.standard_normal((E, 5)).astype(np.float32),
    )


def _buffers(**kw):
    jb, tb = JPVRB(E * C, E, **kw), PrioritizedVectorReplayBuffer(E * C, E, **kw)
    assert isinstance(tb, PrioritizedReplayBuffer)
    assert (tb.segtree.size, tb.segtree.bound) == (jb.segtree.size, jb.segtree.bound) == (24, 32)
    return jb, jb.init(_example(True)), tb, tb.init(_example(False), device="cpu")


def _add_both(jb, js, tb, ts, step, mask=None):
    js, jinfo = jb.add(js, JBatch({k: jnp.asarray(v) for k, v in step.items()}),
                       None if mask is None else jnp.asarray(mask))
    out, tinfo = tb.add(ts, Batch({k: torch.from_numpy(v) for k, v in step.items()}),
                        None if mask is None else torch.from_numpy(mask))
    assert out is ts  # in place
    np.testing.assert_array_equal(tinfo.indices.numpy(), np.asarray(jinfo.indices))
    return js


def _assert_state_close(ts: PrioState, js: JPrioState):
    np.testing.assert_allclose(ts.tree.numpy(), np.asarray(js.tree), **RTOL)
    np.testing.assert_allclose(ts.max_prio.item(), float(js.max_prio), **RTOL)
    np.testing.assert_allclose(ts.min_prio.item(), float(js.min_prio), **RTOL)
    for f in ("cursor", "size", "last_idx"):
        np.testing.assert_array_equal(getattr(ts.base, f).numpy(), np.asarray(getattr(js.base, f)))
    for k in js.base.data.keys():
        np.testing.assert_array_equal(ts.base.data[k].numpy(), np.asarray(js.base.data[k]), err_msg=k)


def _tree_invariant(tb, ts):
    tree, bound = ts.tree, tb.segtree.bound
    assert torch.equal(tree[1:bound], tree[2:2 * bound:2] + tree[3:2 * bound:2])
    assert tree[0].item() == 0.0


@pytest.fixture
def filled(rng):
    jb, js, tb, ts = _buffers(alpha=0.6, beta=0.4)
    for t in range(6):
        mask = None if t % 3 else rng.random(E) < 0.7
        js = _add_both(jb, js, tb, ts, _step(rng), mask)
    return jb, js, tb, ts


def test_init_state(rng):
    jb, js, tb, ts = _buffers()
    assert isinstance(ts, PrioState) and isinstance(ts.base, BufferState) and isinstance(js.base, JBufferState)
    assert ts.tree.shape == (64,) and ts.tree.dtype == torch.float32
    assert ts.max_prio.shape == ts.min_prio.shape == () and ts.max_prio.item() == ts.min_prio.item() == 1.0
    _assert_state_close(ts, js)


def test_add_writes_max_priority_like_jax(filled, rng):
    jb, js, tb, ts = filled
    _assert_state_close(ts, js)
    _tree_invariant(tb, ts)
    # after a writeback raised max_prio, new rows enter at max_prio ** alpha
    idx = np.array([0, 1, 8, 9])
    td = np.array([3.0, -0.5, 2.0, 0.01], np.float32)
    js = jb.update_weight(js, jnp.asarray(idx), jnp.asarray(td))
    tb.update_weight(ts, torch.from_numpy(idx), torch.from_numpy(td))
    js = _add_both(jb, js, tb, ts, _step(rng), np.array([True, False, True]))
    _assert_state_close(ts, js)
    _tree_invariant(tb, ts)
    np.testing.assert_allclose(ts.max_prio.item(), 3.0 + 1e-5, rtol=1e-6)


@pytest.mark.parametrize("batch_size", [1, 8, 32])
def test_sample_with_injected_uniforms_matches_jax(filled, batch_size, rng):
    jb, js, tb, ts = filled
    # unequal priorities first, written to both
    idx = rng.integers(0, E * C, 10)
    td = (rng.standard_normal(10) * 2).astype(np.float32)
    js = jb.update_weight(js, jnp.asarray(idx), jnp.asarray(td))
    tb.update_weight(ts, torch.from_numpy(idx), torch.from_numpy(td))
    _assert_state_close(ts, js)
    # the JAX sampler's own uniforms, handed to the port; the tree is copied across
    key = jax.random.key(7)
    u01 = np.array(jax.random.uniform(key, (batch_size,)))
    want_idx = np.asarray(jb.sample_indices(js, key, batch_size))
    ts.tree = torch.from_numpy(np.array(js.tree))
    got_idx = tb.indices_from_uniform(ts, torch.from_numpy(u01))
    assert got_idx.dtype == torch.int64
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    # weights and the gathered batch at those indices
    ts.min_prio, ts.max_prio = torch.tensor(float(js.min_prio)), torch.tensor(float(js.max_prio))
    np.testing.assert_allclose(tb.get_weight(ts, got_idx).numpy(), np.asarray(jb.get_weight(js, jnp.asarray(want_idx))),
                               **RTOL)
    jbatch, _ = jb.sample(js, key, batch_size)
    tbatch = tb.get(ts, got_idx)
    for k in ("obs", "act", "rew", "terminated", "obs_next"):
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    np.testing.assert_array_equal(tb.get(ts.base, got_idx).obs.numpy(), tbatch.obs.numpy())  # takes either state


def test_sample_draws_from_the_generator_and_attaches_weights(filled):
    jb, js, tb, ts = filled
    g = torch.Generator().manual_seed(3)
    batch, idx = tb.sample(ts, g, 16, drop_keys=("obs_next",))
    u01 = torch.rand(16, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(idx.numpy(), tb.indices_from_uniform(ts, u01).numpy())
    assert "obs_next" not in batch and batch.obs.shape == (16, 5)
    w = batch.weight
    assert w.shape == (16,) and bool(((w > 0) & (w <= 1)).all()) and w.max().item() == 1.0
    # stratified: sample b comes from the b-th share of the mass, so indices never decrease
    assert bool((idx[1:] >= idx[:-1]).all())
    # only stored rows carry mass
    env, slot = idx // C, idx % C
    assert bool((slot < ts.base.size[env]).all())


@pytest.mark.parametrize("weight_norm", [True, False])
def test_get_weight_matches_jax(weight_norm, rng):
    jb, js, tb, ts = _buffers(alpha=0.7, beta=0.5, weight_norm=weight_norm)
    for _ in range(C):
        js = _add_both(jb, js, tb, ts, _step(rng))
    idx = rng.integers(0, E * C, 12)
    td = (rng.standard_normal(12) * 3).astype(np.float32)
    js = jb.update_weight(js, jnp.asarray(idx), jnp.asarray(td))
    tb.update_weight(ts, torch.from_numpy(idx), torch.from_numpy(td))
    q = np.arange(E * C)
    np.testing.assert_allclose(tb.get_weight(ts, torch.from_numpy(q)).numpy(),
                               np.asarray(jb.get_weight(js, jnp.asarray(q))), rtol=2e-6, atol=0)
    tb.set_beta(0.9)
    jb.set_beta(0.9)
    np.testing.assert_allclose(tb.get_weight(ts, torch.from_numpy(q)).numpy(),
                               np.asarray(jb.get_weight(js, jnp.asarray(q))), rtol=2e-6, atol=0)


def test_update_weight_matches_jax_with_duplicates(filled, rng):
    jb, js, tb, ts = filled
    idx = np.array([5, 2, 5, 17, 2, 5, 23, 0])  # the last write of a repeated index wins
    td = np.array([0.5, -4.0, 1.5, 0.0, 0.25, -2.5, 9.0, 1e-7], np.float32)
    js = jb.update_weight(js, jnp.asarray(idx), jnp.asarray(td))
    out = tb.update_weight(ts, torch.from_numpy(idx), torch.from_numpy(td))
    assert out is ts
    _assert_state_close(ts, js)
    _tree_invariant(tb, ts)
    leaves = ts.tree[tb.segtree.bound:]
    np.testing.assert_allclose(leaves[5].item(), (2.5 + 1e-5) ** 0.6, rtol=1e-6)
    np.testing.assert_allclose(leaves[2].item(), (0.25 + 1e-5) ** 0.6, rtol=1e-6)
    np.testing.assert_allclose(ts.min_prio.item(), 1e-5, rtol=1e-6)
    np.testing.assert_allclose(ts.max_prio.item(), 9.0 + 1e-5, rtol=1e-6)
    assert ts.max_prio.shape == ts.min_prio.shape == ()
