"""``tests/test_batch_reference_parity.py`` (46 cases) run on the port's
Batch (tianshou_tpu_torch/data/batch.py): equality, ``to_dict``, assignment,
slicing, batch over batch and standard compatibility. Where a case is about
values the port's Batch is also held equal to JAX's, ``to_dict()`` as numpy;
where a case is about jnp leaves it uses tensors. Values are compared exactly.
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
    np.testing.assert_array_equal(a, b)


def same(t, j):
    """The port's Batch holds JAX's values: ``to_dict()`` as numpy, key for key."""
    assert isinstance(t, Batch) and isinstance(j, JBatch)
    _same_tree(_np(t.to_dict()), _np(j.to_dict()))


# ---------------------------------------------------------------- equality
class TestEquality:
    def test_keys_different(self):
        assert Batch(a=np.zeros(3), b=np.ones(3)) != Batch(a=np.zeros(3), c=np.ones(3))

    def test_keys_missing(self):
        a = Batch(a=np.zeros(3), b=np.ones(3))
        b = Batch(a=np.zeros(3))
        assert a != b
        assert b != a

    def test_value_node_types_different(self):
        assert Batch(a=Batch(x=np.zeros(3))) != Batch(a=np.zeros(3))

    def test_array_dtypes_different(self):
        assert Batch(a=np.zeros(3, dtype=np.float32)) != Batch(a=np.zeros(3, dtype=np.float64))

    def test_nested_values_different(self):
        assert Batch(n=Batch(x=np.arange(3))) != Batch(n=Batch(x=np.arange(3) + 1))

    def test_nested_shapes_different(self):
        assert Batch(n=Batch(x=np.zeros((3, 2)))) != Batch(n=Batch(x=np.zeros((3, 3))))

    def test_equal_mixed_backends(self):
        # numpy-made and torch-made leaves with the same values, dtype and shape compare equal
        assert Batch(a=np.arange(4, dtype=np.float32)) == Batch(a=torch.arange(4, dtype=torch.float32))

    def test_nan_equal(self):
        assert Batch(a=np.array([1.0, np.nan])) == Batch(a=np.array([1.0, np.nan]))

    def test_slice_equal(self):
        base = Batch(a=np.arange(10), n=Batch(x=np.arange(20).reshape(10, 2)))
        assert base[2:5] == base[2:5]
        assert base[2:5] != base[3:6]
        same(base[2:5], JBatch(a=np.arange(10), n=JBatch(x=np.arange(20).reshape(10, 2)))[2:5])

    def test_slice_ellipsis_equal(self):
        base = Batch(a=np.arange(12).reshape(3, 4))
        assert base[..., 1:] == base[..., 1:]
        same(base[..., 1:], JBatch(a=np.arange(12).reshape(3, 4))[..., 1:])

    def test_empty_batches_equal(self):
        assert Batch() == Batch()

    def test_different_key_order_equal(self):
        assert Batch(x=np.zeros(2), y=np.ones(2)) == Batch(y=np.ones(2), x=np.zeros(2))

    def test_tuple_and_list_value_types_equal(self):
        a, b = Batch(a=[1, 2, 3]), Batch(a=(1, 2, 3))
        assert a == b
        same(a, JBatch(a=(1, 2, 3)))

    def test_subbatch_dict_and_batch_types_equal(self):
        assert Batch(n={"x": np.zeros(3)}) == Batch(n=Batch(x=np.zeros(3)))

    def test_non_batch_rhs(self):
        assert Batch(a=np.zeros(3)) != {"a": np.zeros(3)}
        assert Batch(a=np.zeros(3)) != 0


# ---------------------------------------------------------------- to_dict
class TestToDict:
    def test_empty(self):
        assert Batch().to_dict() == {}
        assert Batch().to_dict(recurse=False) == {}

    def test_simple_values(self):
        b = Batch(a=np.arange(3))
        d = b.to_dict()
        assert set(d) == {"a"}
        assert isinstance(d["a"], torch.Tensor)  # the port's leaves are tensors
        np.testing.assert_array_equal(d["a"], np.arange(3))

    def test_nested_no_recurse_keeps_batches(self):
        d = Batch(n=Batch(x=np.zeros(2)), a=np.ones(2)).to_dict(recurse=False)
        assert isinstance(d["n"], Batch)
        assert isinstance(d["a"], torch.Tensor)

    def test_nested_recurse_all_dicts(self):
        b = Batch(n=Batch(m=Batch(x=np.zeros(2)), y=np.ones(2)))
        d = b.to_dict()
        assert isinstance(d["n"], dict)
        assert isinstance(d["n"]["m"], dict)
        np.testing.assert_array_equal(d["n"]["m"]["x"], np.zeros(2))
        _same_tree(_np(d), _np(JBatch(n=JBatch(m=JBatch(x=np.zeros(2)), y=np.ones(2))).to_dict()))

    def test_arrays_not_copied(self):
        b = Batch(a=np.arange(5))
        assert b.to_dict()["a"] is b._d["a"]

    def test_roundtrip_through_constructor(self):
        b = Batch(n=Batch(x=np.arange(3)), a=np.ones(3))
        assert Batch(b.to_dict()) == b


# ------------------------------------------------------------- assignment
class TestAssignment:
    def test_assign_full_length_array(self):
        b = Batch(a=np.zeros(4))
        b.a = np.arange(4)
        np.testing.assert_array_equal(b.a, np.arange(4))

    def test_assign_subarray_existing_key(self):
        def run(B):
            b = B(a=np.zeros(4), n=B(x=np.zeros((4, 2))))
            b[1:3] = B(a=np.ones(2), n=B(x=np.ones((2, 2))))
            return b

        b, jb = run(Batch), run(JBatch)
        np.testing.assert_array_equal(b.a, [0, 1, 1, 0])
        np.testing.assert_array_equal(b.n.x[1], [1, 1])
        np.testing.assert_array_equal(b.n.x[3], [0, 0])
        same(b, jb)

    def test_assign_subarray_tensor_leaf_functional(self):
        b = Batch(a=torch.zeros(4))
        leaf = b.a
        b[2] = Batch(a=5.0)
        np.testing.assert_array_equal(np.asarray(b.a), [0, 0, 5, 0])
        assert b.a is not leaf and not leaf.any()  # a new tensor; the old one untouched
        jb = JBatch(a=jnp.zeros(4))
        jb[2] = JBatch(a=5.0)
        same(b, jb)

    def test_assign_new_key_at_index_raises(self):
        b = Batch(a=np.zeros(4))
        with pytest.raises(KeyError):
            b[1:3] = Batch(zzz=np.ones(2))

    def test_sliced_assignment_requires_mapping(self):
        b = Batch(a=np.zeros(4))
        with pytest.raises(TypeError):
            b[1:3] = np.ones(2)

    def test_string_setitem_converts(self):
        b = Batch(a=np.zeros(2))
        b["c"] = [1, 2]
        assert isinstance(b.c, torch.Tensor)
        np.testing.assert_array_equal(b.c, [1, 2])

    def test_delitem_and_delattr(self):
        b = Batch(a=np.zeros(2), c=np.ones(2))
        del b["a"]
        assert "a" not in b
        del b.c
        assert "c" not in b


# ---------------------------------------------------------------- slicing
class TestSlicing:
    def test_getitem_with_int_gives_scalar_leaves(self):
        b = Batch(a=np.arange(4, dtype=np.float32), n=Batch(x=np.arange(8).reshape(4, 2)))
        row = b[1]
        assert np.ndim(row.a) == 0
        assert float(row.a) == 1.0
        assert row.n.x.shape == (2,)

    @pytest.mark.parametrize(
        "index",
        [slice(0, 2), np.array([0, 2]), [0, 2], np.array([True, False, True, False])],
    )
    def test_getitem_with_fancy_index(self, index):
        b = Batch(a=np.arange(4), n=Batch(x=np.arange(8).reshape(4, 2)))
        sub = b[index]
        np.testing.assert_array_equal(np.asarray(sub.a), np.arange(4)[index])
        np.testing.assert_array_equal(np.asarray(sub.n.x), np.arange(8).reshape(4, 2)[index])
        same(sub, JBatch(a=np.arange(4), n=JBatch(x=np.arange(8).reshape(4, 2)))[index])

    def test_negative_index(self):
        assert float(Batch(a=np.arange(4))[-1].a) == 3.0

    def test_index_empty_batch_raises(self):
        with pytest.raises(IndexError):
            Batch()[0]


# ----------------------------------------------------- batch over batch
class TestBatchOverBatch:
    def test_nested_construction_and_access(self):
        b = Batch(info=Batch(env=Batch(t=np.arange(3))), obs=np.zeros((3, 2)))
        np.testing.assert_array_equal(b.info.env.t, np.arange(3))
        assert b["info"]["env"]["t"] is b.info.env.t

    def test_len_ignores_recursively_empty_subbatch(self):
        assert len(Batch(obs=np.zeros(5), info=Batch(empty=Batch()))) == 5

    def test_len_is_min_over_leaves(self):
        assert len(Batch(a=np.zeros(5), n=Batch(x=np.zeros(3)))) == 3

    def test_len_raises_on_scalar_leaf(self):
        with pytest.raises(TypeError):
            len(Batch(a=np.float32(1.0)))

    def test_update_merges_nested(self):
        b = Batch(n=Batch(x=np.zeros(2)))
        b.update(Batch(n=Batch(x=np.ones(2)), y=np.arange(2)))
        np.testing.assert_array_equal(b.n.x, np.ones(2))
        np.testing.assert_array_equal(b.y, np.arange(2))

    def test_nested_arithmetic(self):
        b = Batch(n=Batch(x=np.ones(3)), a=np.full(3, 2.0))
        c = (b + b) * 2
        np.testing.assert_array_equal(c.n.x, np.full(3, 4.0))
        np.testing.assert_array_equal(c.a, np.full(3, 8.0))
        assert np.all(np.asarray((b / 2).a) == 1.0)
        jb = JBatch(n=JBatch(x=np.ones(3)), a=np.full(3, 2.0))
        same(c, (jb + jb) * 2)

    def test_repr_of_deep_nesting(self):
        r = repr(Batch(n=Batch(m=Batch(x=np.zeros((2, 2))))))
        assert "n" in r and "m" in r and "x" in r

    def test_deepcopy_independent(self):
        b = Batch(n=Batch(x=np.zeros(3)))
        c = copy.deepcopy(b)
        c.n.x[0] = 7
        assert float(b.n.x[0]) == 0.0

    def test_pickle_deep_nested_mixed_backends(self):
        b = Batch(n=Batch(x=torch.arange(3), m=Batch(y=np.ones(3))), a=np.zeros(3))
        assert pickle.loads(pickle.dumps(b)) == b


# -------------------------------------------------- standard compatibility
class TestStandardCompatibility:
    def test_row_iteration_matches_len(self):
        b = Batch(a=np.arange(4), n=Batch(x=np.zeros((4, 2))))
        rows = list(b)
        assert len(rows) == len(b) == 4
        assert float(rows[2].a) == 2.0

    def test_keys_values_items_views(self):
        b = Batch(a=np.zeros(2), c=np.ones(2))
        assert list(b.keys()) == ["a", "c"]
        assert len(list(b.values())) == 2
        assert dict(b.items()).keys() == {"a", "c"}

    def test_dict_unpacking(self):
        assert set(dict(**Batch(a=np.zeros(2), c=np.ones(2)).to_dict())) == {"a", "c"}

    def test_get_and_pop(self):
        b = Batch(a=np.zeros(2))
        assert b.get("missing") is None
        assert b.get("missing", 3) == 3
        v = b.pop("a")
        assert isinstance(v, torch.Tensor) and "a" not in b
        with pytest.raises(KeyError):
            b.pop("a")
        assert b.pop("a", None) is None

    def test_contains(self):
        b = Batch(a=np.zeros(2))
        assert "a" in b and "z" not in b
