"""``tests/test_batch_battery.py`` (38 cases) run on the port's Batch
(tianshou_tpu_torch/data/batch.py). Where a case is about values it runs on
both packages' Batch and holds the port's ``to_dict()`` as numpy equal to
JAX's; where a case is about jnp (jit boundaries, tree maps, grad, scan) it
runs the torch counterpart. Values are compared exactly.
"""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu.data.batch import alloc_by_keys_diff as j_alloc
from tianshou_tpu.data.batch import create_value as j_create
from tianshou_tpu_torch.data.batch import Batch, alloc_by_keys_diff, create_value
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _np(v):
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_tree(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b)
        for k in b:
            _same_tree(a[k], b[k])
        return
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def same(t, j):
    """The port's Batch holds JAX's values: ``to_dict()`` as numpy, key for key."""
    if not isinstance(j, JBatch):  # a leaf
        _same_tree(_np(t), _np(j))
        return
    assert isinstance(t, Batch)
    _same_tree(_np(t.to_dict()), _np(j.to_dict()))


def both(fn):
    """``fn(Batch)`` for each package: (port, JAX)."""
    return fn(Batch), fn(JBatch)


# ---------------------------------------------------------------------------
# construction edge cases
# ---------------------------------------------------------------------------
def test_construct_scalars_promote_to_arrays():
    b, jb = both(lambda B: B(a=1, b=1.5, c=True))
    assert b.a.shape == () and b.b.shape == () and b.c.shape == ()
    assert b.c.dtype == torch.bool
    same(b, jb)


def test_construct_deep_nesting_from_dicts():
    b, jb = both(lambda B: B(obs={"pos": np.zeros((3, 2)), "extra": {"vel": np.ones((3, 4))}}, act=np.arange(3)))
    assert isinstance(b.obs, Batch) and isinstance(b.obs.extra, Batch)
    assert b.obs.extra.vel.shape == (3, 4)
    assert b.shape == [3] == jb.shape
    assert b[1].obs.extra.vel.shape == (4,)
    same(b, jb)


def test_nested_setattr_creates_subbatch():
    def run(B):
        b = B(a=np.zeros(3))
        b.sub = {"x": np.ones(3)}
        b.sub.y = np.full(3, 2.0)
        return b

    b, jb = both(run)
    assert isinstance(b.sub, Batch)
    assert float(b.sub.y.sum()) == 6.0
    same(b, jb)


def test_getitem_string_and_tuple_index():
    b, jb = both(lambda B: B(a=np.arange(12).reshape(3, 4), nested=B(x=np.arange(3))))
    np.testing.assert_array_equal(np.asarray(b["a"]), np.arange(12).reshape(3, 4))
    row = b[np.array([0, 2])]
    assert row.a.shape == (2, 4) and row.nested.x.shape == (2,)
    same(row, jb[np.array([0, 2])])


def test_boolean_mask_indexing():
    b, jb = both(lambda B: B(a=np.arange(5), s=B(v=np.arange(10).reshape(5, 2))))
    m = np.array([True, False, True, False, True])
    sel = b[m]
    np.testing.assert_array_equal(np.asarray(sel.a), [0, 2, 4])
    assert sel.s.v.shape == (3, 2)
    same(sel, jb[m])
    same(b[torch.from_numpy(m)], jb[m])


def test_setitem_by_index_writes_all_leaves():
    def run(B):
        b = B(a=np.zeros(4), s=B(v=np.zeros((4, 2))))
        b[2] = B(a=5.0, s=B(v=np.ones(2)))
        return b

    b, jb = both(run)
    assert float(b.a[2]) == 5.0
    np.testing.assert_array_equal(np.asarray(b.s.v[2]), [1, 1])
    assert float(np.asarray(b.a).sum()) == 5.0
    same(b, jb)


def test_len_of_scalar_only_batch_raises():
    with pytest.raises(TypeError):
        len(Batch(a=np.float32(1.0)))


def test_shape_is_elementwise_min_reference_parity():
    b, jb = both(lambda B: B(a=np.zeros((4, 5)), c=B(d=np.zeros((4, 2, 2)))))
    assert b.shape == [4, 2] == jb.shape
    assert len(b) == 4


# ---------------------------------------------------------------------------
# cat / stack deep semantics
# ---------------------------------------------------------------------------
def test_cat_nested_missing_subkeys_zero_pad():
    out, jout = both(lambda B: B.cat([B(a=np.ones((2, 3)), nested=B(x=np.ones(2))), B(a=np.ones((3, 3)))]))
    assert out.a.shape == (5, 3)
    np.testing.assert_array_equal(np.asarray(out.nested.x), [1, 1, 0, 0, 0])
    same(out, jout)


def test_cat_three_way_and_order():
    out, jout = both(lambda B: B.cat([B(a=np.full((i + 1,), i)) for i in range(3)]))
    np.testing.assert_array_equal(np.asarray(out.a), [0, 1, 1, 2, 2, 2])
    same(out, jout)


def test_cat_axis1():
    out, jout = both(lambda B: B.cat([B(a=np.ones((2, 3))), B(a=np.zeros((2, 2)))], axis=1))
    assert out.a.shape == (2, 5)
    same(out, jout)


def test_stack_nested_and_new_axis():
    out, jout = both(lambda B: B.stack([B(o=B(p=np.full(3, i)), r=np.float32(i)) for i in range(4)]))
    assert out.o.p.shape == (4, 3) and out.r.shape == (4,)
    np.testing.assert_array_equal(np.asarray(out.r), [0, 1, 2, 3])
    same(out, jout)
    out1, jout1 = both(lambda B: B.stack([B(a=np.zeros((2, 3))), B(a=np.ones((2, 3)))], axis=1))
    assert out1.a.shape == (2, 2, 3)
    same(out1, jout1)


def test_stack_missing_keys_zero_fill_union():
    out, jout = both(lambda B: B.stack([B(a=np.ones(3), b=np.ones(3)), B(a=np.full(3, 2.0), c=np.full(3, 3.0))]))
    np.testing.assert_array_equal(np.asarray(out.b), [[1, 1, 1], [0, 0, 0]])
    np.testing.assert_array_equal(np.asarray(out.c), [[0, 0, 0], [3, 3, 3]])
    same(out, jout)


def test_cat_inplace_matches_functional():
    b1 = Batch(a=np.ones(2), n=Batch(x=np.ones(2)))
    b2 = Batch(a=np.zeros(3), n=Batch(x=np.zeros(3)))
    func = Batch.cat([b1, b2])
    b1.cat_(b2)
    assert b1 == func


def test_stack_inplace_matches_functional():
    func = Batch.stack([Batch(a=np.ones(2)), Batch(a=np.zeros(2))])
    b3 = Batch(a=np.ones(2))
    b3.stack_([Batch(a=np.zeros(2))])
    assert b3 == func


# ---------------------------------------------------------------------------
# empty semantics
# ---------------------------------------------------------------------------
def test_empty_zeroes_rows_in_place():
    def run(B):
        b = B(a=np.arange(4, dtype=np.float32), n=B(x=np.ones((4, 2))))
        b.empty_(index=np.array([1, 3]))
        return b

    b, jb = both(run)
    np.testing.assert_array_equal(np.asarray(b.a), [0, 0, 2, 0])
    np.testing.assert_array_equal(np.asarray(b.n.x[0]), [1, 1])
    np.testing.assert_array_equal(np.asarray(b.n.x[1]), [0, 0])
    same(b, jb)


def test_empty_static_returns_copy():
    b = Batch(a=np.ones(3))
    out = Batch.empty(b)
    assert float(np.asarray(out.a).sum()) == 0.0
    assert float(np.asarray(b.a).sum()) == 3.0


# ---------------------------------------------------------------------------
# conversion & copies
# ---------------------------------------------------------------------------
def test_to_torch_and_back_preserves_structure_and_values():
    b = Batch(a=np.arange(3, dtype=np.int64), n=Batch(x=np.ones((3, 2), np.float64)))
    j = b.to_torch()
    assert isinstance(j.a, torch.Tensor) and isinstance(j.n.x, torch.Tensor)
    back = j.to_numpy()
    assert isinstance(back.a, np.ndarray)
    np.testing.assert_array_equal(back.a, np.arange(3))
    same(back, JBatch(a=np.arange(3, dtype=np.int64), n=JBatch(x=np.ones((3, 2), np.float64))).to_jax().to_numpy())


def test_inplace_conversion_mutates_self():
    b = Batch(a=np.zeros(2))
    b.to_torch_()
    assert isinstance(b.a, torch.Tensor)
    b.to_numpy_()
    assert isinstance(b.a, np.ndarray)


def test_copy_is_shallow_per_leaf_but_structural():
    b = Batch(a=np.zeros(3), n=Batch(x=np.zeros(3)))
    c = b.copy()
    c.n.y = np.ones(3)  # structural change must not leak back
    assert "y" not in b.n
    d = copy.deepcopy(b)
    d.a[0] = 7  # a deep copy: no leak
    assert float(b.a[0]) == 0.0


def test_pickle_nested_mixed_backends():
    b = Batch(a=np.arange(3), j=torch.ones((3, 2)), n=Batch(x=np.zeros(3)))
    assert pickle.loads(pickle.dumps(b)) == b


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------
def test_scalar_arithmetic_applies_to_all_leaves():
    def run(B):
        b = B(a=np.ones(3), n=B(x=np.full(3, 2.0)))
        out = (b + 1) * 2
        return out, out / 2

    (out, half), (jout, jhalf) = run(Batch), run(JBatch)
    np.testing.assert_array_equal(np.asarray(out.a), [4, 4, 4])
    np.testing.assert_array_equal(np.asarray(out.n.x), [6, 6, 6])
    np.testing.assert_array_equal(np.asarray(half.a), [2, 2, 2])
    same(out, jout)
    same(half, jhalf)


def test_batch_plus_batch_elementwise():
    out, jout = both(lambda B: B(a=np.ones(3)) + B(a=np.full(3, 10.0)))
    np.testing.assert_array_equal(np.asarray(out.a), [11, 11, 11])
    same(out, jout)


def test_inplace_arithmetic():
    def run(B):
        b = B(a=np.ones(3))
        b += 2
        s1 = b.copy()
        b *= 2
        s2 = b.copy()
        b /= 3
        return s1, s2, b

    t, j = run(Batch), run(JBatch)
    np.testing.assert_array_equal(np.asarray(t[0].a), [3, 3, 3])
    np.testing.assert_array_equal(np.asarray(t[1].a), [6, 6, 6])
    np.testing.assert_array_equal(np.asarray(t[2].a), [2, 2, 2])
    for x, y in zip(t, j):
        same(x, y)


def test_mean_over_leaves():
    m, jm = both(lambda B: B(a=np.array([1.0, 3.0]), n=B(x=np.array([2.0, 4.0]))).mean())
    assert float(m.a) == 2.0 and float(m.n.x) == 3.0
    same(m, jm)


# ---------------------------------------------------------------------------
# split
# ---------------------------------------------------------------------------
def test_split_covers_all_rows_shuffled():
    seen = []
    for part in Batch(a=np.arange(10)).split(3, shuffle=True, merge_last=False):
        seen.extend(np.asarray(part.a).tolist())
    assert sorted(seen) == list(range(10))


def test_split_merge_last_absorbs_remainder():
    b = Batch(a=np.arange(10))
    assert [len(p) for p in b.split(4, shuffle=False, merge_last=True)] == [4, 6]
    assert [len(p) for p in b.split(4, shuffle=False, merge_last=False)] == [4, 4, 2]
    jb = JBatch(a=np.arange(10))
    for p, jp in zip(b.split(4, shuffle=False, merge_last=True), jb.split(4, shuffle=False, merge_last=True)):
        same(p, jp)


def test_split_size_larger_than_batch_yields_whole():
    parts = list(Batch(a=np.arange(3)).split(100, shuffle=False))
    assert len(parts) == 1 and len(parts[0]) == 3


# ---------------------------------------------------------------------------
# null handling
# ---------------------------------------------------------------------------
def test_isnull_hasnull_dropnull_nested():
    def make(B):
        return B(a=np.array([1.0, np.nan, 3.0]), n=B(x=np.array([[1.0, 2.0], [3.0, 4.0], [5.0, np.nan]])),
                 clean=np.ones(3))

    b, jb = both(make)
    assert b.hasnull() and jb.hasnull()
    nulls = b.isnull()
    assert bool(np.asarray(nulls.a)[1]) and not bool(np.asarray(nulls.a)[0])
    same(nulls.to_numpy(), jb.isnull().to_numpy())
    dropped = b.dropnull()
    assert not dropped.hasnull()
    assert len(dropped) == 1
    assert float(np.asarray(dropped.a)[0]) == 1.0
    same(dropped, jb.dropnull())


# ---------------------------------------------------------------------------
# set_array_at_key / apply_values_transform
# ---------------------------------------------------------------------------
def test_set_array_at_key_partial_index():
    def run(B):
        b = B(a=np.zeros(5))
        b.set_array_at_key(np.array([9.0, 8.0]), "a", index=np.array([1, 3]))
        return b

    b, jb = both(run)
    np.testing.assert_array_equal(np.asarray(b.a), [0, 9, 0, 8, 0])
    same(b, jb)


def test_set_array_at_key_new_key_requires_full_default():
    def run(B):
        b = B(a=np.zeros(3))
        b.set_array_at_key(np.arange(3.0), "fresh")
        return b

    b, jb = both(run)
    np.testing.assert_array_equal(np.asarray(b.fresh), [0, 1, 2])
    same(b, jb)


def test_apply_values_transform_functional_and_inplace():
    b = Batch(a=np.ones(2), n=Batch(x=np.full(2, 3.0)))
    out = b.apply_values_transform(lambda x: x * 10)
    assert float(np.asarray(out.n.x)[0]) == 30.0
    assert float(np.asarray(b.n.x)[0]) == 3.0
    same(out, JBatch(a=np.ones(2), n=JBatch(x=np.full(2, 3.0))).apply_values_transform(lambda x: x * 10))
    b.apply_values_transform(lambda x: x * 0, inplace=True)
    assert float(np.asarray(b.a).sum()) == 0.0


# ---------------------------------------------------------------------------
# create_value / alloc_by_keys_diff
# ---------------------------------------------------------------------------
def test_create_value_matches_inst_dtype_and_shape():
    v = create_value(np.ones((2, 3), np.float32), size=5)
    assert v.shape == (5, 2, 3) and v.dtype == torch.float32
    same(v, j_create(np.ones((2, 3), np.float32), size=5))
    v = create_value(np.int64(3), size=4)
    assert v.shape == (4,)
    sub = create_value(Batch(x=np.ones(2)), size=3)
    assert isinstance(sub, Batch) and sub.x.shape == (3, 2)
    same(sub, j_create(JBatch(x=np.ones(2)), size=3))


def test_alloc_by_keys_diff_adds_missing_keys():
    def run(B, alloc):
        meta = B(a=np.zeros((4, 2)))
        alloc(meta, B(a=np.ones((1, 2)), fresh=B(x=np.ones((1, 3)))), size=4, stack=False)
        meta2 = B(a=np.zeros((4, 2)))
        alloc(meta2, B(a=np.ones((1, 2)), g=np.ones((1, 3))), size=4)
        return meta, meta2

    (meta, meta2), (jmeta, jmeta2) = run(Batch, alloc_by_keys_diff), run(JBatch, j_alloc)
    assert "fresh" in meta and meta.fresh.x.shape == (4, 3)
    assert meta2.g.shape == (4, 1, 3)
    same(meta, jmeta)
    same(meta2, jmeta2)


# ---------------------------------------------------------------------------
# the device contract: a Batch through functions of tensors
# ---------------------------------------------------------------------------
def test_batch_passes_through_a_function_boundary_with_aux_keys():
    b = Batch(obs=torch.ones((4, 3)), extra=Batch(flag=torch.zeros(4)))

    def f(x):
        x = x.copy()
        x.obs = x.obs * 2
        return x

    out = f(b)
    assert float(out.obs.sum()) == 24.0 and float(b.obs.sum()) == 12.0
    assert "flag" in out.extra


def test_batch_map_preserves_key_order():
    b = Batch(z=torch.zeros(2), a=torch.ones(2))
    out = b.map(lambda x: x + 1)
    assert list(out.keys()) == list(b.keys())
    assert list(out.keys()) == list(JBatch(z=jnp.zeros(2), a=jnp.ones(2)).keys())


def test_batch_grad_through_leaves():
    b = Batch(w=torch.ones(3, requires_grad=True))
    (g,) = torch.autograd.grad((b.w**2).sum(), [b.w])
    np.testing.assert_allclose(g.numpy(), [2, 2, 2])


def test_scan_carry_batch():
    carry, ys = Batch(c=torch.zeros(2)), []
    for _ in range(5):
        carry = carry.copy()
        carry.c = carry.c + 1
        ys.append(carry.c)
    np.testing.assert_array_equal(np.asarray(carry.c), [5, 5])
    assert torch.stack(ys).shape == (5, 2)
