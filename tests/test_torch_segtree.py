"""Parity of the port's sum tree (tianshou_tpu_torch/ops/segtree.py and the
plain descent of tianshou_tpu_torch/ops/kernels/sumtree.py) with the JAX
package's (tianshou_tpu/ops/segtree.py, tianshou_tpu/ops/pallas/sumtree.py).

Tolerance: none. Leaves are copied, parents are ``tree[2p] + tree[2p+1]`` in
the same order, ``reduce`` adds the same nodes in the same order and the
descent has one compare and one subtract per level, so trees, sums and
indices are held exactly equal. The Pallas kernel runs in interpret mode, as
``tests/test_pallas_sumtree.py`` runs it on the CPU. The cases of
``tests/test_segtree.py`` are repeated on the port against numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.ops.pallas.sumtree import pallas_prefix_sum_idx
from tianshou_tpu.ops.segtree import SegmentTree as JSegmentTree
from tianshou_tpu_torch.ops.kernels import sumtree as ts
from tianshou_tpu_torch.ops.segtree import SegmentTree
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

SIZES = [1, 3, 8, 100, 1024]


def _pair(size):
    jst, st = JSegmentTree(size), SegmentTree(size)
    assert (st.size, st.bound, st.depth) == (jst.size, jst.bound, jst.depth)
    return jst, jst.init(), st, st.init("cpu")


def _update_both(jst, jtree, st, tree, idx, val):
    jtree = jst.update(jtree, jnp.asarray(idx), jnp.asarray(val))
    out = st.update(tree, torch.from_numpy(np.asarray(idx)), torch.from_numpy(np.asarray(val, np.float32)))
    assert out is tree  # in place
    np.testing.assert_array_equal(tree.numpy(), np.asarray(jtree))
    return jtree


def _filled(size, rng):
    jst, jtree, st, tree = _pair(size)
    vals = rng.random(size).astype(np.float32) + 0.01
    jtree = _update_both(jst, jtree, st, tree, np.arange(size), vals)
    return jst, jtree, st, tree, vals


def _queries(rng, vals, n):
    """Uniform values over the mass, the exact prefix sums (boundaries), 0, the total and beyond."""
    total = np.float32(vals.sum(dtype=np.float32))
    cum = np.cumsum(vals, dtype=np.float32)
    return np.concatenate([
        (rng.random(n) * total).astype(np.float32), cum[:64], [0.0, total, total * 2, -1.0],
    ]).astype(np.float32)


@pytest.mark.parametrize("size", SIZES)
def test_update_total_reduce_match_jax_exactly(size, rng):
    jst, jtree, st, tree, vals = _filled(size, rng)
    assert st.total(tree).item() == float(jst.total(jtree))
    assert tree[0].item() == 0.0
    # a partial overwrite of a filled tree
    k = max(1, size // 3)
    idx = rng.integers(0, size, k)
    jtree = _update_both(jst, jtree, st, tree, idx, rng.random(k).astype(np.float32))
    for lo, hi in [(0, size), (0, 1), (size - 1, size), (size // 2, size // 2), (size // 4, size - size // 4),
                   (0, size // 2 + 1)]:
        got = st.reduce(tree, lo, hi)
        assert got.item() == float(jst.reduce(jtree, lo, hi)), (lo, hi)
    assert st.reduce(tree).item() == float(jst.reduce(jtree))
    got = st.reduce(tree, torch.tensor(0), torch.tensor(size))  # tensor bounds, as under jit in JAX
    assert got.item() == float(jst.reduce(jtree, jnp.int32(0), jnp.int32(size)))


@pytest.mark.parametrize("size", SIZES)
def test_update_duplicates_and_dropped_indices_match_jax_exactly(size, rng):
    jst, jtree, st, tree, _ = _filled(size, rng)
    # duplicates (the last write wins), -1 sentinels and indices at and beyond size
    idx = np.concatenate([rng.integers(0, size, 40), [-1, -1, size, size + 5, -7, 10 * size + 3],
                          rng.integers(0, size, 10)])
    val = (rng.random(idx.shape[0]) * 5).astype(np.float32)
    jtree = _update_both(jst, jtree, st, tree, idx, val)
    leaves = tree.numpy()[st.bound:st.bound + size]
    for i in np.unique(idx[(idx >= 0) & (idx < size)]):
        assert leaves[i] == val[np.nonzero(idx == i)[0][-1]]
    assert tree[0].item() == 0.0
    assert np.all(tree.numpy()[st.bound + size:] == 0.0)  # padding leaves never written
    # only dropped indices: nothing changes
    before = tree.clone()
    _update_both(jst, jtree, st, tree, np.array([-1, -1, size]), np.array([9.0, 9.0, 9.0], np.float32))
    assert torch.equal(tree, before)


@pytest.mark.parametrize("size", SIZES)
def test_prefix_sum_idx_matches_jax_exactly(size, rng):
    jst, jtree, st, tree, vals = _filled(size, rng)
    q = _queries(rng, vals, 300)
    want = np.asarray(jst.get_prefix_sum_idx(jtree, jnp.asarray(q)))
    got = st.get_prefix_sum_idx(tree, torch.from_numpy(q))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert ts.launch_count() == 0  # a CPU tree takes the plain version
    # any shape of values
    got2 = st.get_prefix_sum_idx(tree, torch.from_numpy(q[:12]).reshape(3, 4))
    np.testing.assert_array_equal(got2.numpy(), want[:12].reshape(3, 4))


@pytest.mark.parametrize("size,batch", [(64, 32), (100, 257), (1024, 128), (1, 5), (16384, 64)])
def test_plain_descent_matches_pallas_interpret_exactly(size, batch, rng):
    jst, jtree, st, tree, vals = _filled(size, rng)
    q = _queries(rng, vals, batch)
    got = ts.prefix_sum_idx_reference(tree, torch.from_numpy(q), st.bound, st.depth, st.size)
    want = pallas_prefix_sum_idx(jtree, jnp.asarray(q), jst.bound, jst.depth, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.minimum(want, jst.size - 1)))


@pytest.mark.parametrize("case", ["zero_leaves", "all_zero", "sparse"])
def test_prefix_sum_idx_zero_priority_leaves_match_jax_exactly(case, rng):
    size = 100
    jst, jtree, st, tree = _pair(size)
    vals = rng.random(size).astype(np.float32)
    if case == "zero_leaves":
        vals[rng.integers(0, size, 30)] = 0.0
    elif case == "all_zero":
        vals[:] = 0.0
    else:
        vals[:] = 0.0
        vals[3], vals[77] = 1.0, 3.0
    jtree = _update_both(jst, jtree, st, tree, np.arange(size), vals)
    q = _queries(rng, vals, 200)
    got = st.get_prefix_sum_idx(tree, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jst.get_prefix_sum_idx(jtree, jnp.asarray(q))))
    if case == "sparse":
        inside = got[:200]
        assert set(np.unique(inside)) <= {3, 77}


# ---------------------------------------------------------------------------
# the cases of tests/test_segtree.py, on the port
# ---------------------------------------------------------------------------
def test_update_last_write_wins():
    st = SegmentTree(8)
    tree = st.update(st.init("cpu"), torch.tensor([2, 5, 2, 2]), torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert st.total(tree).item() == 6.0
    assert st.reduce(tree, 2, 3).item() == 4.0


def test_prefix_sum_idx_hits_each_leaf_interval(rng):
    size = 16
    st = SegmentTree(size)
    vals = rng.random(size).astype(np.float32) + 0.01
    tree = st.update(st.init("cpu"), torch.arange(size), torch.from_numpy(vals))
    cum = np.concatenate([[0], np.cumsum(vals)])
    got = st.get_prefix_sum_idx(tree, torch.from_numpy(((cum[:-1] + cum[1:]) / 2).astype(np.float32)))
    np.testing.assert_array_equal(got.numpy(), np.arange(size))
    assert st.get_prefix_sum_idx(tree, torch.tensor([0.0])).item() == 0


def test_prefix_sum_sampling_distribution(rng):
    size = 10
    st = SegmentTree(size)
    vals = np.zeros(size, np.float32)
    vals[3], vals[7] = 1.0, 3.0
    tree = st.update(st.init("cpu"), torch.arange(size), torch.from_numpy(vals))
    u = rng.random(10000).astype(np.float32) * st.total(tree).item()
    idx = st.get_prefix_sum_idx(tree, torch.from_numpy(u)).numpy()
    assert set(np.unique(idx)) == {3, 7}
    assert 0.70 < (idx == 7).mean() < 0.80


def test_non_pow2_size_never_samples_padding():
    st = SegmentTree(5)
    tree = st.update(st.init("cpu"), torch.arange(5), torch.ones(5))
    assert st.total(tree).item() == 5.0
    got = st.get_prefix_sum_idx(tree, torch.tensor([4.999, 5.0, 1e9]))
    np.testing.assert_array_equal(got.numpy(), [4, 4, 4])


@pytest.mark.parametrize("bad", ["tree_len", "tree_dtype", "values_dtype", "values_dim", "size", "bound"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    tree, values, bound, depth, size = torch.zeros(16), torch.zeros(4), 8, 3, 8
    if bad == "tree_len":
        tree = torch.zeros(15)
    elif bad == "tree_dtype":
        tree = tree.double()
    elif bad == "values_dtype":
        values = values.double()
    elif bad == "values_dim":
        values = values.reshape(2, 2)
    elif bad == "size":
        size = 9
    else:
        bound = 7
    with pytest.raises((ValueError, TypeError)):
        ts.prefix_sum_idx(tree, values, bound, depth, size)


def test_init_raises_without_cuda_and_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SegmentTree(8).init()
