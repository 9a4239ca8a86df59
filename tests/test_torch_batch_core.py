"""``tests/test_batch.py`` (30 cases) run on the port's Batch
(tianshou_tpu_torch/data/batch.py). Where a case is about values it runs on
both packages' Batch and holds the port's ``to_dict()`` as numpy equal to
JAX's, key for key; where a case is about jnp (pytree, jit, vmap, scan) it
runs the torch counterpart (a leaf-wise ``map``, a function of the Batch,
rows, autograd). Values are compared exactly: no arithmetic differs.
"""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu_torch.data.batch import Batch
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
    if b.dtype == object:
        assert all(x == y for x, y in zip(a.flat, b.flat))
    else:
        np.testing.assert_array_equal(a, b)


def same(t, j):
    """The port's Batch holds JAX's values: ``to_dict()`` as numpy, key for key."""
    assert isinstance(t, Batch) and isinstance(j, JBatch)
    _same_tree(_np(t.to_dict()), _np(j.to_dict()))


def both(fn):
    """``fn(Batch)`` for each package: (port, JAX)."""
    return fn(Batch), fn(JBatch)


def test_construct_and_access():
    t, j = both(lambda B: B(a=np.arange(3), b={"c": np.ones((3, 2))}))
    same(t, j)
    assert list(t.keys()) == ["a", "b"]
    assert isinstance(t.b, Batch)
    np.testing.assert_array_equal(t.a, [0, 1, 2])
    np.testing.assert_array_equal(t["b"]["c"], np.ones((3, 2)))
    t.d = [1, 2, 3]
    np.testing.assert_array_equal(t.d, [1, 2, 3])
    assert "d" in t
    del t.d
    assert "d" not in t
    with pytest.raises(AttributeError):
        _ = t.nonexistent


def test_construct_from_list_of_dicts():
    t, j = both(lambda B: B([{"a": 1, "b": {"c": 2.0}}, {"a": 3, "b": {"c": 4.0}}]))
    same(t, j)
    assert len(t) == 2
    np.testing.assert_array_equal(t.a, [1, 3])
    np.testing.assert_array_equal(t.b.c, [2.0, 4.0])


def test_len_and_shape():
    b = Batch(a=np.zeros((4, 3)), b=Batch(c=np.zeros((5, 2))))
    assert len(b) == 4
    assert b.shape == [4, 2] == JBatch(a=np.zeros((4, 3)), b=JBatch(c=np.zeros((5, 2)))).shape
    with pytest.raises(TypeError):
        len(Batch())
    with pytest.raises(TypeError):
        len(Batch(a=np.float64(1.0)))


def test_indexing():
    t, j = both(lambda B: B(obs=np.arange(10), nested=B(x=np.arange(20).reshape(10, 2))))
    s = t[2:5]
    same(s, j[2:5])
    np.testing.assert_array_equal(s.obs, [2, 3, 4])
    assert s.nested.x.shape == (3, 2)
    assert t[3].obs == 3
    idx = np.array([1, 5, 7])
    same(t[idx], j[idx])
    np.testing.assert_array_equal(t[idx].obs, [1, 5, 7])
    mask = np.zeros(10, bool)
    mask[::2] = True
    assert len(t[mask]) == 5
    same(t[mask], j[mask])
    same(t[torch.from_numpy(idx)], j[idx])  # a tensor index too


def test_setitem_slice():
    def write(B):
        b = B(a=np.zeros(5), n=B(x=np.zeros((5, 2))))
        b[2:4] = B(a=np.ones(2), n=B(x=np.ones((2, 2))))
        return b

    t, j = both(write)
    same(t, j)
    np.testing.assert_array_equal(t.a, [0, 0, 1, 1, 0])
    np.testing.assert_array_equal(t.n.x[2], [1, 1])
    # tensor leaves take the functional path, as jax-array leaves do
    bt, bj = Batch(a=torch.zeros(5)), JBatch(a=jnp.zeros(5))
    bt[1] = Batch(a=7.0)
    bj[1] = JBatch(a=7.0)
    assert bt.a[1] == 7.0
    same(bt, bj)


def test_value_semantics_of_a_sliced_write_after_copy():
    """A JAX leaf is written functionally (``tgt.at[index].set(v)``), so a
    sliced write never reaches a copy that shares the array; neither does the
    port's, for tensor leaves at any depth."""
    def write(B, arr):
        b = B(a=arr(np.zeros(5, np.float32)), n=B(x=arr(np.zeros((5, 2), np.float32))))
        c = b.copy()
        b[1:3] = B(a=arr(np.ones(2, np.float32)), n=B(x=arr(np.full((2, 2), 2.0, np.float32))))
        return b, c

    (tb, tc), (jb, jc) = write(Batch, torch.from_numpy), write(JBatch, jnp.asarray)
    same(tb, jb)
    same(tc, jc)
    np.testing.assert_array_equal(tc.a, np.zeros(5))
    np.testing.assert_array_equal(tc.n.x, np.zeros((5, 2)))
    np.testing.assert_array_equal(tb.a, [0, 1, 1, 0, 0])
    # an object (numpy) leaf is written in place, as the JAX package writes numpy leaves
    info = np.array([None] * 3, dtype=object)
    ob = Batch(info=info)
    oc = ob.copy()
    ob[1] = Batch(info=np.array("x", dtype=object))
    assert oc.info[1] == "x" and info[1] == "x"


def test_cat_stack():
    def run(B):
        b1 = B(a=np.ones((2, 3)), n=B(x=np.zeros(2)))
        b2 = B(a=np.zeros((3, 3)), n=B(x=np.ones(3)))
        c, s = B.cat([b1, b2]), B.stack([b1, b1])
        b1.cat_(b2)
        dj = B.cat([B(a=np.ones(2)), B(b=np.ones(2))])
        return c, s, b1, dj

    t, j = run(Batch), run(JBatch)
    for x, y in zip(t, j):
        same(x, y)
    c, s, b1, dj = t
    assert c.a.shape == (5, 3)
    np.testing.assert_array_equal(c.n.x, [0, 0, 1, 1, 1])
    assert s.a.shape == (2, 2, 3)
    assert b1.a.shape == (5, 3)
    np.testing.assert_array_equal(dj.a, [1, 1, 0, 0])
    np.testing.assert_array_equal(dj.b, [0, 0, 1, 1])


def test_split():
    b = Batch(a=np.arange(7))
    chunks = list(b.split(3, shuffle=False))
    assert [len(c) for c in chunks] == [3, 3, 1]
    for c, jc in zip(chunks, JBatch(a=np.arange(7)).split(3, shuffle=False)):
        same(c, jc)
    merged = list(b.split(3, shuffle=False, merge_last=True))
    assert [len(c) for c in merged] == [3, 4]
    shuffled = Batch.cat(list(b.split(2, shuffle=True, rng=np.random.default_rng(0))))
    jshuffled = JBatch.cat(list(JBatch(a=np.arange(7)).split(2, shuffle=True, rng=np.random.default_rng(0))))
    assert sorted(np.asarray(shuffled.a).tolist()) == list(range(7))
    same(shuffled, jshuffled)  # the same rng, the same order


def test_pytree_roundtrip():
    """The port's counterpart of a pytree round trip and a jitted function of a Batch."""
    b = Batch(a=torch.arange(3.0), n=Batch(x=torch.ones((3, 2))))
    leaves = []
    b2 = b.map(lambda x: leaves.append(x) or x)
    assert len(leaves) == 2 and b2 == b and b2 is not b

    def f(batch):
        return Batch(y=batch.a * 2, n=batch.n)

    out = f(b)
    np.testing.assert_allclose(out.y, [0, 2, 4])


def test_vmap_scan_compat():
    """Rows (the leading axis) as a scan and a vmap see them."""
    b = Batch(a=torch.arange(12.0).reshape(4, 3))
    total = 0.0
    for row in b:
        total += float(row.a.sum())
    assert total == 66.0
    out = torch.vmap(lambda x: x + 1)(b.a)
    assert out.shape == (4, 3)


def test_conversion():
    b = Batch(a=np.arange(3, dtype=np.int32), n=Batch(x=np.ones(3, np.float32)))
    j = b.to_torch()
    assert isinstance(j.a, torch.Tensor)
    n = j.to_numpy()
    assert isinstance(n.a, np.ndarray) and isinstance(n.n.x, np.ndarray)
    same(n, JBatch(a=np.arange(3, dtype=np.int32), n=JBatch(x=np.ones(3, np.float32))).to_numpy())
    assert n == b


def test_equality_pickle_deepcopy():
    b = Batch(a=np.arange(3), n=Batch(x=torch.ones(3)))
    b2 = pickle.loads(pickle.dumps(b))
    assert b2 == b
    b3 = copy.deepcopy(b)
    assert b3 == b
    assert b != Batch(a=np.arange(3))
    assert b != Batch(a=np.arange(4), n=Batch(x=torch.ones(3)))


def test_hasnull():
    assert not Batch(a=np.ones(3)).hasnull()
    assert Batch(a=np.array([1.0, np.nan])).hasnull()
    assert Batch(n=Batch(a=torch.tensor([torch.nan]))).hasnull()


def test_empty_and_update():
    b = Batch()
    assert b.is_empty()
    b.update(a=np.ones(2))
    assert not b.is_empty()
    b.update({"c": np.zeros(2)}, d=np.ones(2))
    assert set(b.keys()) == {"a", "c", "d"}
    jb = JBatch(a=np.ones(2))
    jb.update({"c": np.zeros(2)}, d=np.ones(2))
    same(b, jb)
    assert Batch(x=Batch()).is_empty(recurse=True)
    with pytest.raises(IndexError):
        Batch()[0]


def test_object_array_host_only():
    t, j = both(lambda B: B(info=np.array([{"k": 1}, {"k": 2}], dtype=object)))
    assert isinstance(t.info, Batch)
    assert int(t.info[0].k) == 1
    same(t, j)

    class Blob:  # non-dict payload: passes through as an object array
        pass

    blobs = np.array([Blob(), Blob()], dtype=object)
    b2 = Batch(info=blobs)
    assert b2.info.dtype == object
    same(b2, JBatch(info=blobs))
    with pytest.raises(TypeError):
        b2.to_torch()


def test_isnull_dropnull():
    def make(B):
        return B(a=np.array([1.0, np.nan, 3.0]), n=B(x=np.array([[1.0, 2], [3, 4], [np.nan, 6]])))

    t, j = both(make)
    mask = t.isnull()
    same(mask.to_numpy(), j.isnull().to_numpy())
    np.testing.assert_array_equal(np.asarray(mask.a), [False, True, False])
    kept = t.dropnull()
    same(kept, j.dropnull())
    assert len(kept) == 1
    assert float(kept.a[0]) == 1.0


def test_cat_with_missing_keys_zero_pads():
    rng = np.random.default_rng(0)
    aa, ab, bb = rng.standard_normal((3, 4)), rng.standard_normal((3, 4)), rng.standard_normal((3, 4))

    def run(B):
        a = B(a=B(a=aa, t=B()), b=ab)
        b = B(a=B(a=B(), t=B()), b=bb)
        return B.cat([a, b, a])

    ans, jans = run(Batch), run(JBatch)
    same(ans, jans)
    np.testing.assert_allclose(np.asarray(ans.a.a), np.concatenate([aa, np.zeros((3, 4)), aa]))
    np.testing.assert_allclose(np.asarray(ans.b), np.concatenate([ab, bb, ab]))
    assert len(ans.a.t.get_keys()) == 0


def test_cat_empty_batch_contributes_nothing():
    x = np.random.default_rng(1).standard_normal((3, 4))
    out, jout = both(lambda B: B.cat([B(a=B(a=x)), B(a=B(a=B())), B(a=B(a=x))]))
    same(out, jout)
    np.testing.assert_allclose(np.concatenate([x, x]), np.asarray(out.a.a))


def test_cat_reserved_keys():
    rng = np.random.default_rng(2)
    c1, c2 = rng.random((3, 5)), rng.random((4, 5))
    b1 = Batch(a=Batch(), b=torch.zeros((3, 3)), common=Batch(c=c1))
    b2 = Batch(a=Batch(), b=torch.ones((4, 3)), common=Batch(c=c2))
    test = Batch.cat([b1, b2])
    assert len(test.a.get_keys()) == 0
    np.testing.assert_allclose(np.asarray(test.b), np.concatenate([np.zeros((3, 3)), np.ones((4, 3))]))
    np.testing.assert_allclose(np.asarray(test.common.c), np.concatenate([c1, c2]))
    same(test, JBatch.cat([JBatch(a=JBatch(), b=jnp.zeros((3, 3)), common=JBatch(c=c1)),
                           JBatch(a=JBatch(), b=jnp.ones((4, 3)), common=JBatch(c=c2))]))


def test_stack_incompatible_keys_union_zero_fill():
    d, jd = both(lambda B: B.stack([B(a=1, b=2, c=3), B(a=4, b=5, d=6), B(c=7, b=6, d=9)]))
    same(d, jd)
    np.testing.assert_allclose(np.asarray(d.a), [1, 4, 0])
    np.testing.assert_allclose(np.asarray(d.b), [2, 5, 6])
    np.testing.assert_allclose(np.asarray(d.c), [3, 0, 7])
    np.testing.assert_allclose(np.asarray(d.d), [0, 6, 9])
    e = Batch.stack([Batch(a=1, e=Batch()), Batch(a=2, e=Batch())])
    assert len(e.e.get_keys()) == 0
    assert len(Batch.stack([Batch(), Batch()]).get_keys()) == 0
    assert len(Batch.stack([]).get_keys()) == 0
    assert len(Batch.cat([]).get_keys()) == 0


def test_stack_mixed_np_torch():
    rng = np.random.default_rng(3)
    a, c1, c2 = rng.random((4, 4)), rng.random((4, 5)), rng.random((4, 5))
    test = Batch.stack([Batch(a=a, common=Batch(c=c1)), Batch(b=torch.ones((4, 6)), common=Batch(c=c2))])
    np.testing.assert_allclose(np.asarray(test.a), np.stack([a, np.zeros((4, 4))]))
    np.testing.assert_allclose(np.asarray(test.b), np.stack([np.zeros((4, 6)), np.ones((4, 6))]))
    np.testing.assert_allclose(np.asarray(test.common.c), np.stack([c1, c2]))
    same(test, JBatch.stack([JBatch(a=a, common=JBatch(c=c1)), JBatch(b=jnp.ones((4, 6)), common=JBatch(c=c2))]))


def test_cat_stack_error_cases():
    for B in (Batch, JBatch):
        with pytest.raises(ValueError):
            B.cat([[B(a=1)], [B(a=1)]])
        with pytest.raises(ValueError):
            B.stack([[B(a=1)], [B(a=1)]])
        b1 = B(e=np.array([4.0, 5.0]), d=6)
        b2 = B(e=np.array([4.0, 6.0]))
        with pytest.raises(ValueError):
            B.cat([b1, b2])  # 0-d `d` cannot be padded
        with pytest.raises(ValueError):
            B.stack([b1, b2], axis=1)  # missing key at axis != 0


def test_stack_axis1_and_inplace():
    def run(B, ones):
        b3 = B(a=np.zeros((3, 4)), b=ones((2, 5)), c=B(d=np.array([[1], [2]])))
        b4 = B(a=np.ones((3, 4)), b=ones((2, 5)), c=B(d=np.array([[0], [3]])))
        b34 = B.stack((b3, b4), axis=1)
        b3.stack_([b4])
        x = B(a=np.arange(3))
        x.cat_(B(a=np.arange(3)))
        return b34, b3, x

    t, j = run(Batch, torch.ones), run(JBatch, jnp.ones)
    for x, y in zip(t, j):
        same(x, y)
    b34, b3, x = t
    np.testing.assert_allclose(np.asarray(b34.a), np.stack((np.zeros((3, 4)), np.ones((3, 4))), axis=1))
    assert b3.a.shape == (2, 3, 4)
    assert len(x) == 6


def test_batch_from_array_of_dicts():
    d = np.array([{"a": False, "b": {"c": 2.0, "d": 1.0}}, {"a": True, "b": {"c": 3.0}}])
    b5, jb5 = both(lambda B: B(d))
    same(b5, jb5)
    assert bool(b5.a[0]) is False and bool(b5.a[1]) is True
    np.testing.assert_allclose(np.asarray(b5.b.c), [2.0, 3.0])
    assert float(b5.b.d[0]) == 1.0 and float(b5.b.d[1]) == 0.0


def test_batch_empty_and_empty_():
    def run(B, arr):
        data = B(a=np.array([False, True]), b=B(e=np.array([2.0, np.e])), c=np.array([1, 3], dtype=int),
                 t=arr([4.0, 5.0]))
        data[-1] = B.empty(data[1])
        first = copy.deepcopy(data)  # numpy leaves of the JAX Batch are written in place
        data.empty_(index=0)
        return first, data

    (first, data), (jfirst, jdata) = run(Batch, torch.tensor), run(JBatch, jnp.array)
    same(first, jfirst)
    same(data, jdata)
    np.testing.assert_allclose(np.asarray(first.a), [False, False])
    np.testing.assert_allclose(np.asarray(first.c), [1, 0])
    np.testing.assert_allclose(np.asarray(first.b.e), [2.0, 0.0])
    np.testing.assert_allclose(np.asarray(first.t), [4.0, 0.0])
    np.testing.assert_allclose(np.asarray(data.c), [0, 0])
    b0 = Batch()
    b0.empty_()
    assert b0.shape == []


def test_set_array_at_key():
    def run(B):
        batch = B(a=np.array([4, 5, 6]), b=np.array([7, 8, 9]), c={"d": np.array([1, 2, 3])})
        batch.set_array_at_key(np.array([1, 2, 3]), "a")
        batch.set_array_at_key(np.array([4, 5, 6]), "new_key")
        with pytest.raises(ValueError):
            batch.set_array_at_key(np.array([1, 2]), "a")
        batch.set_array_at_key(np.array([1, 2]), "a", index=[0, 1])
        batch.set_array_at_key(np.array([1, 2]), "a", index=[2, 0])
        with pytest.raises(IndexError):
            batch.set_array_at_key(np.array([1, 2]), "a", index=[10, 11])
        batch.set_array_at_key(np.array([1, 2]), "nk", index=[0, 1], default_value=0)
        batch.set_array_at_key(np.array([1.0, 2.0]), "nk2", index=[0, 1])
        return batch

    batch, jbatch = both(run)
    same(batch, jbatch)
    np.testing.assert_array_equal(batch.a, [2, 2, 1])
    np.testing.assert_array_equal(batch.new_key, [4, 5, 6])
    np.testing.assert_array_equal(batch.b, [7, 8, 9])
    np.testing.assert_array_equal(batch.nk, [1, 2, 0])
    assert np.isnan(batch.nk2[2])
    tb = Batch(a=torch.arange(3))  # a tensor target takes the functional path
    tb.set_array_at_key(np.array([7, 8]), "a", index=[0, 2])
    np.testing.assert_array_equal(np.asarray(tb.a), [7, 1, 8])


def test_row_iteration_and_to_list_of_dicts():
    b, jb = both(lambda B: B(a=np.arange(3), n=B(x=np.arange(6).reshape(3, 2))))
    rows = list(b)
    assert len(rows) == 3
    for r, jr in zip(rows, jb):
        same(r, jr)
    assert float(rows[1].a) == 1.0
    np.testing.assert_array_equal(rows[2].n.x, [4, 5])
    lod = b.to_list_of_dicts()
    assert isinstance(lod, list) and len(lod) == 3 and float(lod[0]["a"]) == 0.0
    for d, jd in zip(lod, jb.to_list_of_dicts()):
        _same_tree(_np(d), _np(jd))


def test_batch_arithmetic():
    def run(B, arr):
        b = B(a=np.array([1.0, 2.0]), n=B(x=arr([3.0, 4.0])))
        s, m, d = b + b, b * 2.0, b / 2.0
        b += b
        b *= 0.5
        b /= 1.0
        return s, m, d, b

    t, j = run(Batch, torch.tensor), run(JBatch, jnp.array)
    for x, y in zip(t, j):
        same(x, y)
    s, m, d, b = t
    np.testing.assert_allclose(np.asarray(s.a), [2.0, 4.0])
    np.testing.assert_allclose(np.asarray(s.n.x), [6.0, 8.0])
    np.testing.assert_allclose(np.asarray(m.a), [2.0, 4.0])
    np.testing.assert_allclose(np.asarray(d.n.x), [1.5, 2.0])
    np.testing.assert_allclose(np.asarray(b.a), [1.0, 2.0])
    with pytest.raises(ValueError):
        Batch(a=np.ones(2)) + Batch(b=np.ones(2))
    with pytest.raises(TypeError):
        Batch(a=np.ones(2)) + "nope"


def test_mean_and_standard_compat():
    batch, jbatch = both(lambda B: B(a=np.array([[1.0, 2.0], [3.0, 4.0]]), b=B(), c=np.array([5.0, 6.0])))
    bm = np.mean(batch)
    assert isinstance(bm, Batch)
    same(bm, np.mean(jbatch))
    np.testing.assert_allclose(np.asarray(bm.a), np.mean(batch.a.numpy(), axis=0))
    assert float(bm.c) == 5.5


def test_to_at_least_2d_and_transform():
    def run(B, arr):
        b = B(a=np.array(1.0), n=B(x=arr([1.0, 2.0])))
        b2 = b.to_at_least_2d()
        tr = b.apply_values_transform(lambda x: x * 0)
        b.apply_values_transform(lambda x: x + 1, inplace=True)
        return b2, tr, b

    t, j = run(Batch, torch.tensor), run(JBatch, jnp.array)
    for x, y in zip(t, j):
        same(x, y)
    b2, tr, b = t
    assert b2.a.shape == (1, 1)
    assert b2.n.x.shape == (1, 2)
    assert float(np.asarray(tr.n.x).sum()) == 0.0
    assert float(b.a) == 2.0


def test_to_numpy_and_to_torch_inplace():
    b = Batch(a=torch.ones(3))
    b.to_numpy_()
    assert isinstance(b.a, np.ndarray)
    b.to_torch_()
    assert isinstance(b.a, torch.Tensor)
    b.to_torch_(dtype_map={torch.float32: torch.float64})
    assert b.a.dtype == torch.float64


PROTOCOLS = ["ObsBatchProtocol", "RolloutBatchProtocol", "BatchWithReturnsProtocol", "PrioBatchProtocol",
             "RecurrentStateBatch", "ActBatchProtocol", "ActStateBatchProtocol", "ModelOutputBatchProtocol",
             "FQFBatchProtocol", "BatchWithAdvantagesProtocol", "DistBatchProtocol", "DistLogProbBatchProtocol",
             "LogpOldProtocol", "QuantileRegressionBatchProtocol", "ImitationBatchProtocol"]


def _keys(cls) -> set:
    """Every key a protocol declares, its bases' included."""
    return {k for c in cls.__mro__ for k in getattr(c, "__annotations__", {})}


@pytest.mark.parametrize("name", PROTOCOLS)
def test_typed_protocols_declare_the_jax_packages_keys(name):
    from tianshou_tpu.data import types as jtypes
    from tianshou_tpu_torch.data import types as ttypes

    t, j = getattr(ttypes, name), getattr(jtypes, name)
    assert _keys(t) == _keys(j) and _keys(t)
    assert [c.__name__ for c in t.__mro__ if c.__name__ in PROTOCOLS] == \
        [c.__name__ for c in j.__mro__ if c.__name__ in PROTOCOLS]  # the same inheritance


def test_key_contracts_and_the_runtime_check_match_jax():
    from tianshou_tpu.data import types as jtypes
    from tianshou_tpu_torch.data import types as ttypes

    for name in ("ROLLOUT_KEYS", "RETURNS_KEYS", "ADVANTAGE_KEYS", "PRIO_KEYS", "LOGP_OLD_KEYS", "TRANSITION_EXAMPLE_KEYS"):
        assert getattr(ttypes, name) == getattr(jtypes, name), name
    # a runtime check of the protocol reads attributes statically, so neither package's Batch passes it
    assert isinstance(Batch(obs=torch.zeros(2)), ttypes.ObsBatchProtocol) == \
        isinstance(JBatch(obs=jnp.zeros(2)), jtypes.ObsBatchProtocol)
    with pytest.raises(KeyError):
        ttypes.validate_keys(Batch(obs=torch.zeros(2)), ttypes.ROLLOUT_KEYS)
