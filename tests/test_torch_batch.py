"""The port's Batch (tianshou_tpu_torch/data/batch.py) against the JAX
package's (tianshou_tpu/data/batch.py) on the subset the port implements:
construction from kwargs and dicts, attribute and item access, dict
protocol, get/pop/copy, ``in``, leaf-wise map and indexing. Values are
compared exactly (no arithmetic happens)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JBatch
from tianshou_tpu_torch.data.batch import Batch
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)


def _pair():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.integers(0, 9, 5).astype(np.int64)
    c = rng.integers(0, 255, (5, 2, 2), dtype=np.uint8)
    j = JBatch({"a": jnp.asarray(a), "nested": {"b": jnp.asarray(b), "c": jnp.asarray(c)}}, d=jnp.asarray(a[:, 0]))
    t = Batch({"a": torch.from_numpy(a), "nested": {"b": torch.from_numpy(b), "c": torch.from_numpy(c)}},
              d=torch.from_numpy(a[:, 0]))
    return j, t


def _assert_same(t, j):
    if isinstance(j, JBatch):
        assert isinstance(t, Batch)
        assert list(t.keys()) == list(j.keys())
        for k in j.keys():
            _assert_same(t[k], j[k])
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_construction_and_access_match_jax():
    j, t = _pair()
    _assert_same(t, j)
    _assert_same(t.nested, j.nested)
    assert ("a" in t) == ("a" in j) and ("zz" in t) == ("zz" in j)
    assert len(t) == len(j) == 5
    assert t.get("zz", 7) == 7 and t.get("d") is t["d"]


@pytest.mark.parametrize("index", [2, slice(1, 4), np.array([4, 0, 0])])
def test_indexing_every_leaf_matches_jax(index):
    j, t = _pair()
    tindex = torch.from_numpy(index) if isinstance(index, np.ndarray) else index
    _assert_same(t[tindex], j[index])


def test_map_copy_pop_and_setters():
    j, t = _pair()
    _assert_same(t.map(lambda x: x[:2]), JBatch({k: v for k, v in j[:2].items()}))
    c = t.copy()
    c.e = np.zeros(5, np.float32)  # numpy converts to a tensor
    c.nested.f = {"g": torch.ones(5)}
    assert "e" not in t and "f" not in t.nested and isinstance(c.e, torch.Tensor)
    assert isinstance(c.nested.f, Batch)
    assert c.pop("e").shape == (5,) and "e" not in c
    del c.d
    assert "d" not in c and "d" in t
    with pytest.raises(AttributeError):
        _ = t.missing
    # a value no tensor can hold stays a numpy array, as the JAX package keeps it
    s = Batch(x="not a tensor").x
    assert isinstance(s, np.ndarray) and not isinstance(s, torch.Tensor)
    assert s == np.asarray(JBatch(x="not a tensor").x)


def test_to_device_moves_every_leaf():
    _, t = _pair()
    moved = t.to("cpu")
    assert moved is not t
    assert all(v.device.type == "cpu" for v in (moved.a, moved.nested.b, moved.nested.c, moved.d))
