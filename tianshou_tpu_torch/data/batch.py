"""Batch: a recursive dict of tensors with attribute access.

Port of ``tianshou_tpu/data/batch.py`` (reference ``tianshou/data/batch.py:625``).
Values are ``torch.Tensor``s, nested ``Batch``es, or numpy arrays where a
tensor cannot hold the value (object and string arrays: gym ``info``
payloads). Numeric numpy arrays, numpy and Python scalars and lists of
numbers become tensors on assignment (``torch.as_tensor``: on the CPU they
share the array's memory); a list or an object array of dicts becomes a
stacked ``Batch`` over the union of their keys, zero-filled.

API parity with the JAX package (its file:line): attribute and nested key
access, row iteration (:140), ``shape`` / ``is_empty`` (:209-226), sliced
assignment (:165), ``cat`` / ``stack`` / ``split`` / ``empty`` and their
in-place forms with the reference's handling of missing keys and empty
sub-batches (:269-476), ``set_array_at_key`` (:479), value transforms and
``mean`` (:530-550), arithmetic (:552-594), ``hasnull`` / ``isnull`` /
``dropnull`` (:596-630), ``__eq__``, ``to_numpy`` / ``to_torch`` (the JAX
package's ``to_jax``) with their in-place forms, ``to_dict``,
``to_list_of_dicts``, pickling, ``create_value`` / ``alloc_by_keys_diff``
(:677-709), and the port's own leaf-wise :meth:`Batch.map` and
:meth:`Batch.to`.

Value semantics of a sliced write: the JAX package writes a device leaf
functionally (``tgt.at[index].set(v)``), so the write never reaches another
``Batch`` that shares the array, such as a :meth:`Batch.copy`. Here a tensor
leaf is written the same way: a new tensor with the rows replaced, cast to
the leaf's dtype. A numpy leaf is written in place, as in the JAX package.
"""

from __future__ import annotations

import copy
import pprint
from collections.abc import Callable, ItemsView, Iterator, KeysView, Sequence, ValuesView
from typing import Any

import numpy as np
import torch

__all__ = ["Batch", "alloc_by_keys_diff", "create_value"]


def _from_numpy(arr: np.ndarray) -> Any:
    """A tensor of a numeric or bool array; any other array stays numpy."""
    if arr.dtype.kind in "biufc":
        return torch.as_tensor(arr)
    return arr


def _convert_value(v: Any) -> Any:
    """Normalize an input value into a tensor, a nested Batch or a numpy array."""
    if isinstance(v, (Batch, torch.Tensor)):
        return v
    if isinstance(v, dict):
        return Batch(v)
    if isinstance(v, np.ndarray):
        # an object array of dicts (vectorized gym infos) -> a stacked Batch over the union of keys
        if v.dtype == object and v.ndim == 1 and len(v) > 0 and all(isinstance(e, (dict, Batch)) for e in v):
            return Batch.stack([Batch(e) if isinstance(e, dict) else e for e in v])
        return _from_numpy(v)
    if isinstance(v, (np.generic, bool, int, float, complex)):
        return torch.as_tensor(np.asarray(v))
    if isinstance(v, (list, tuple)):
        if len(v) > 0 and all(isinstance(e, (dict, Batch)) for e in v):
            return Batch.stack([Batch(e) if isinstance(e, dict) else e for e in v])
        if len(v) > 0 and all(isinstance(e, torch.Tensor) for e in v):
            return torch.stack(list(v))
        return _from_numpy(np.asarray(v))
    if v is None or isinstance(v, str):
        return np.asarray(v) if isinstance(v, str) else np.asarray(None, dtype=object)
    arr = np.empty((), dtype=object)  # any other payload: a 0-d object array, host only
    arr[()] = v
    return arr


def _index_for(leaf: Any, index: Any) -> Any:
    """``index`` in a form ``leaf`` takes: numpy index arrays on a tensor's
    device, tensor indices as numpy for a numpy leaf."""
    if isinstance(leaf, torch.Tensor) and isinstance(index, np.ndarray):
        return torch.as_tensor(index, device=leaf.device)
    if isinstance(leaf, np.ndarray) and isinstance(index, torch.Tensor):
        return index.cpu().numpy()
    return index


def _as_numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _zeros_like_proto(proto: Any, shape: tuple) -> Any:
    if isinstance(proto, torch.Tensor):
        return torch.zeros(shape, dtype=proto.dtype, device=proto.device)
    return np.zeros(shape, proto.dtype)


def _join(parts: list, axis: int, stack: bool) -> Any:
    """Concatenate or stack leaves: tensors if any part is a tensor (numpy
    parts are converted), else numpy."""
    if any(isinstance(p, torch.Tensor) for p in parts):
        device = next(p.device for p in parts if isinstance(p, torch.Tensor))
        ts = [p if isinstance(p, torch.Tensor) else torch.as_tensor(p, device=device) for p in parts]
        return torch.stack(ts, dim=axis) if stack else torch.cat(ts, dim=axis)
    return np.stack(parts, axis=axis) if stack else np.concatenate(parts, axis=axis)


class Batch:
    """Recursive dict of tensors with attribute access."""

    __slots__ = ("_d",)

    def __init__(self, _input: dict | Batch | Sequence | np.ndarray | None = None, **kwargs: Any) -> None:
        d: dict[str, Any] = {}
        object.__setattr__(self, "_d", d)
        if _input is not None:
            if isinstance(_input, Batch):
                d.update(_input._d)
            elif isinstance(_input, dict):
                for k, v in _input.items():
                    d[k] = _convert_value(v)
            elif isinstance(_input, (list, tuple, np.ndarray)):
                rows = list(_input.ravel()) if isinstance(_input, np.ndarray) else list(_input)
                b = _convert_value(rows)
                if not isinstance(b, Batch):
                    raise TypeError(f"cannot construct Batch from {type(_input)}")
                d.update(b._d)
            else:
                raise TypeError(f"cannot construct Batch from {type(_input)}")
        for k, v in kwargs.items():
            d[k] = _convert_value(v)

    # ---------------- dict protocol ----------------
    def keys(self) -> KeysView:
        return self._d.keys()

    def get_keys(self) -> KeysView:
        """Alias of the reference API (batch.py:524)."""
        return self._d.keys()

    def values(self) -> ValuesView:
        return self._d.values()

    def items(self) -> ItemsView:
        return self._d.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def pop(self, key: str, *default: Any) -> Any:
        return self._d.pop(key, *default)

    def update(self, other: Batch | dict | None = None, **kwargs: Any) -> None:
        if other is not None:
            for k, v in (other.items() if isinstance(other, (Batch, dict)) else other):
                self._d[k] = _convert_value(v)
        for k, v in kwargs.items():
            self._d[k] = _convert_value(v)

    def __contains__(self, key: str) -> bool:
        return key in self._d

    def __iter__(self) -> Iterator[Batch]:
        """Iterate over ROWS (leading-axis slices), as the reference does
        (batch.py:761), not over keys as a dict does."""
        for i in range(len(self)):
            yield self[i]

    # ---------------- attribute access ----------------
    def __getattr__(self, key: str) -> Any:
        try:
            return object.__getattribute__(self, "_d")[key]
        except KeyError:
            raise AttributeError(f"Batch has no key {key!r}") from None

    def __setattr__(self, key: str, value: Any) -> None:
        self._d[key] = _convert_value(value)

    def __delattr__(self, key: str) -> None:
        try:
            del self._d[key]
        except KeyError:
            raise AttributeError(key) from None

    # ---------------- item access ----------------
    def __getitem__(self, index: Any) -> Any:
        """A key for a ``str``; otherwise ``index`` applied to every leaf."""
        if isinstance(index, str):
            return self._d[index]
        if not self._d:
            raise IndexError("cannot index an empty Batch")
        out = Batch()
        for k, v in self._d.items():
            out._d[k] = v[index] if isinstance(v, Batch) else v[_index_for(v, index)]
        return out

    def __setitem__(self, index: Any, value: Any) -> None:
        """A key for a ``str``; otherwise the rows at ``index`` of every key of
        ``value`` (a Batch or dict whose keys this Batch has). A tensor leaf
        is replaced by a written copy, a numpy leaf is written in place."""
        if isinstance(index, str):
            self._d[index] = _convert_value(value)
            return
        if not isinstance(value, (Batch, dict)):
            raise TypeError("sliced assignment requires a Batch/dict value")
        value = Batch(value) if isinstance(value, dict) else value
        for k, v in value.items():
            tgt = self._d[k]
            if isinstance(tgt, Batch):
                tgt[index] = v
            elif isinstance(tgt, np.ndarray):
                tgt[_index_for(tgt, index)] = _as_numpy(v) if isinstance(v, torch.Tensor) else v
            else:
                new = tgt.clone()
                new[_index_for(tgt, index)] = torch.as_tensor(v).to(device=tgt.device, dtype=tgt.dtype)
                self._d[k] = new

    def __delitem__(self, key: str) -> None:
        del self._d[key]

    # ---------------- shape / len ----------------
    def __len__(self) -> int:
        lens = []
        for v in self._d.values():
            if isinstance(v, Batch):
                if v.is_empty(recurse=True):
                    continue  # recursively empty sub-batches carry no length
                lens.append(len(v))
            elif hasattr(v, "shape") and len(v.shape) > 0:
                lens.append(v.shape[0])
            else:
                raise TypeError(f"0-d entry prevents len(): {v!r}")
        if not lens:
            raise TypeError("empty Batch has no len()")
        return min(lens)

    @property
    def shape(self) -> list[int]:
        """The elementwise minimum over the leaves' shapes, truncated to the
        shortest rank (reference batch.py:1185)."""
        shapes = []
        for v in self._d.values():
            if isinstance(v, Batch):
                if v._d:
                    shapes.append(v.shape)
            else:
                shapes.append(list(v.shape))
        if not shapes:
            return []
        n = min(len(s) for s in shapes)
        return [min(s[i] for s in shapes) for i in range(n)]

    def is_empty(self, recurse: bool = False) -> bool:
        if not self._d:
            return True
        if not recurse:
            return False
        return all(isinstance(v, Batch) and v.is_empty(True) for v in self._d.values())

    def __repr__(self) -> str:
        items = []
        for k, v in self._d.items():
            if isinstance(v, Batch):
                items.append(f"{k}: {v!r}")
            else:
                items.append(f"{k}: {type(v).__name__}{tuple(v.shape)}:{v.dtype}")
        inner = ",\n    ".join(items)
        return f"Batch(\n    {inner},\n)" if items else "Batch()"

    def pprint(self) -> None:
        pprint.pprint(self.to_dict())

    # ---------------- leaf-wise ops ----------------
    def map(self, fn: Callable[[Any], Any]) -> Batch:
        """A new Batch with ``fn`` applied to every leaf."""
        out = Batch()
        for k, v in self._d.items():
            out._d[k] = v.map(fn) if isinstance(v, Batch) else fn(v)
        return out

    def to(self, device: str | torch.device) -> Batch:
        return self.map(lambda x: x.to(device))

    def copy(self) -> Batch:
        """Shallow copy: a new (nested) key structure sharing the leaves."""
        return self.map(lambda x: x)

    def __deepcopy__(self, memo: dict) -> Batch:
        out = Batch()
        for k, v in self._d.items():
            out._d[k] = copy.deepcopy(v, memo)
        return out

    def __getstate__(self) -> dict:
        return {"_d": self.to_dict(recurse=True)}

    def __setstate__(self, state: dict) -> None:
        object.__setattr__(self, "_d", {})
        self.update(state["_d"])

    # ---------------- conversion ----------------
    def to_numpy(self) -> Batch:
        """Every tensor leaf as a numpy array on the host."""
        return self.map(_as_numpy)

    def to_numpy_(self) -> None:
        """In place (reference batch.py:385)."""
        conv = self.to_numpy()
        self._d.clear()
        self._d.update(conv._d)

    def to_torch(self, dtype_map: dict | None = None, device: str | torch.device | None = None) -> Batch:
        """Every leaf as a tensor (the JAX package's ``to_jax``): ``dtype_map``
        maps a tensor dtype to the one to cast to; object arrays raise."""
        def conv(x: Any) -> torch.Tensor:
            if isinstance(x, np.ndarray) and x.dtype.kind not in "biufc":
                raise TypeError(f"{x.dtype} arrays cannot be tensors")
            t = torch.as_tensor(x)
            if dtype_map is not None and t.dtype in dtype_map:
                t = t.to(dtype_map[t.dtype])
            return t.to(device) if device is not None else t
        return self.map(conv)

    def to_torch_(self, dtype_map: dict | None = None, device: str | torch.device | None = None) -> None:
        """In place (reference ``to_torch_``)."""
        conv = self.to_torch(dtype_map=dtype_map, device=device)
        self._d.clear()
        self._d.update(conv._d)

    def to_dict(self, recurse: bool = True) -> dict:
        return {k: (v.to_dict() if recurse and isinstance(v, Batch) else v) for k, v in self._d.items()}

    def to_list_of_dicts(self) -> list[dict]:
        """Row-wise dicts (reference batch.py:521)."""
        return [row.to_dict() for row in self]

    # ---------------- composition ----------------
    @staticmethod
    def _as_batches(batches: Sequence) -> list[Batch]:
        out = []
        for b in batches:
            if isinstance(b, dict):
                out.append(Batch(b))
            elif isinstance(b, Batch):
                out.append(b)
            else:
                raise ValueError(f"cat/stack elements must be Batch or dict, got {type(b)}")
        return out

    @staticmethod
    def _try_len(b: Batch) -> int:
        """Length for cat's zero padding: 0 for a recursively empty batch (it
        contributes nothing), -1 where it cannot be inferred (0-d values)."""
        try:
            return len(b)
        except TypeError:
            return 0 if b.is_empty(recurse=True) else -1

    @staticmethod
    def _is_empty_val(v: Any) -> bool:
        return isinstance(v, Batch) and not v._d

    @staticmethod
    def _union_keys(batches: list[Batch]) -> list[str]:
        keys: list[str] = []
        for b in batches:
            keys += [k for k in b._d if k not in keys]
        return keys

    @staticmethod
    def cat(batches: Sequence[Batch], axis: int = 0) -> Batch:
        """Concatenate along ``axis`` (reference batch.py:976). Keys missing
        in some inputs (or empty ``Batch()`` there) are zero-padded with that
        input's inferred length; ValueError where it cannot be inferred."""
        batches = [b for b in Batch._as_batches(batches) if b._d]
        if not batches:
            return Batch()
        return Batch._cat_lens(batches, [Batch._try_len(b) for b in batches], axis)

    @staticmethod
    def _cat_lens(batches: list[Batch], lens: list[int], axis: int) -> Batch:
        out = Batch()
        for k in Batch._union_keys(batches):
            vals = [b._d.get(k) for b in batches]
            present = [v for v in vals if v is not None and not Batch._is_empty_val(v)]
            if not present:
                out._d[k] = Batch()
                continue
            if isinstance(present[0], Batch):
                if any(not isinstance(v, Batch) for v in present):
                    raise ValueError(f"cat: key {k!r} mixes Batch and array values")
                out._d[k] = Batch._cat_lens([v if isinstance(v, Batch) else Batch() for v in vals], lens, axis)
                continue
            proto = present[0]
            if proto.ndim == 0:
                raise ValueError(f"cat: key {k!r} holds 0-d values; cannot concatenate")
            parts = []
            for v, n in zip(vals, lens):
                if v is not None and not Batch._is_empty_val(v):
                    parts.append(v)
                    continue
                if n < 0:
                    raise ValueError(f"cat: key {k!r} is missing in a batch whose length cannot be inferred; "
                                     "cannot zero-pad")
                if n > 0 and axis != 0:
                    raise ValueError(f"cat: missing-key zero-padding is only defined for axis=0, got axis={axis} "
                                     f"for key {k!r}")
                if n > 0:
                    parts.append(_zeros_like_proto(proto, (n,) + tuple(proto.shape[1:])))
            out._d[k] = _join(parts, axis, stack=False)
        return out

    def cat_(self, other: Batch | Sequence[Batch]) -> None:
        others = [other] if isinstance(other, (Batch, dict)) else list(other)
        merged = Batch.cat([self, *others])
        self._d.clear()
        self._d.update(merged._d)

    @staticmethod
    def stack(batches: Sequence[Batch], axis: int = 0) -> Batch:
        """Stack along a new ``axis`` (reference batch.py:1041). Keys missing
        in some inputs (or empty ``Batch()`` there) are zero-filled, at
        ``axis=0`` only."""
        batches = [b for b in Batch._as_batches(batches) if b._d]
        if not batches:
            return Batch()
        out = Batch()
        for k in Batch._union_keys(batches):
            vals = [b._d.get(k) for b in batches]
            present = [v for v in vals if v is not None and not Batch._is_empty_val(v)]
            if not present:
                out._d[k] = Batch()
                continue
            if isinstance(present[0], Batch):
                if any(not isinstance(v, Batch) for v in present):
                    raise ValueError(f"stack: key {k!r} mixes Batch and array values")
                out._d[k] = Batch.stack([v if isinstance(v, Batch) else Batch() for v in vals], axis=axis)
                continue
            if len(present) < len(vals):
                if axis != 0:
                    raise ValueError(f"stack: key {k!r} is missing in some inputs; zero-fill is only supported "
                                     "at axis=0")
                zero = _zeros_like_proto(present[0], tuple(present[0].shape))
                vals = [zero if v is None or Batch._is_empty_val(v) else v for v in vals]
            out._d[k] = _join(vals, axis, stack=True)
        return out

    def stack_(self, others: Sequence[Batch], axis: int = 0) -> None:
        """In place (reference batch.py:429)."""
        merged = Batch.stack([self, *others], axis=axis)
        self._d.clear()
        self._d.update(merged._d)

    def split(self, size: int, shuffle: bool = True, merge_last: bool = False,
              rng: np.random.Generator | None = None) -> Iterator[Batch]:
        """Mini-batches of at most ``size`` rows (reference batch.py:1199)."""
        length = len(self)
        if size == 0:
            size = length
        assert size > 0
        indices = np.arange(length)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(indices)
        merge_last = merge_last and length % size > 0
        for idx in range(0, length, size):
            if merge_last and idx + size + size >= length:
                yield self[indices[idx:]]
                break
            yield self[indices[idx:idx + size]]

    # ---------------- row clearing (reference batch.py:458-492) ----------
    def empty_(self, index: Any = None) -> Batch:
        """Zero the rows at ``index`` (all rows if None) in place: numbers to 0,
        bools to False, objects to None (reference batch.py:458). A tensor leaf
        is replaced by a zeroed copy, as a sliced write replaces it."""
        for k, v in self._d.items():
            if isinstance(v, Batch):
                v.empty_(index)
            elif isinstance(v, np.ndarray):
                v[... if index is None else _index_for(v, index)] = None if v.dtype == object else 0
            elif index is None:
                self._d[k] = torch.zeros_like(v)
            else:
                new = v.clone()
                new[_index_for(v, np.asarray(index) if isinstance(index, (list, tuple)) else index)] = 0
                self._d[k] = new
        return self

    @staticmethod
    def empty(batch: Batch, index: Any = None) -> Batch:
        """A copy of ``batch`` with the rows at ``index`` zeroed (batch.py:486)."""
        return copy.deepcopy(batch).empty_(index)

    # ---------------- keyed array assignment (reference batch.py:527) ----
    def set_array_at_key(self, seq: Any, key: str, index: Any = None, default_value: Any = None) -> None:
        """Assign ``seq`` at ``key``, or only at the rows ``index``. A missing
        key is made full-length first, filled with ``default_value`` (NaN for
        a float ``seq`` when None, else 0; reference batch.py:527-549)."""
        seq = _convert_value(seq)
        if index is None:
            cur = self._d.get(key)
            if cur is not None and hasattr(cur, "shape") and len(cur.shape) > 0 and len(seq) != cur.shape[0]:
                raise ValueError(f"set_array_at_key: length {len(seq)} != existing {cur.shape[0]}")
            self._d[key] = seq
            return
        n = len(self)
        idx_arr = _as_numpy(index)
        if idx_arr.dtype != bool and idx_arr.size and int(np.max(idx_arr)) >= n:
            raise IndexError(f"set_array_at_key: index out of bounds for length {n}")
        if key not in self._d:
            floating = seq.dtype.is_floating_point if isinstance(seq, torch.Tensor) else \
                np.issubdtype(seq.dtype, np.floating)
            fill = np.nan if default_value is None and floating else (0 if default_value is None else default_value)
            shape = (n,) + tuple(seq.shape[1:])
            self._d[key] = torch.full(shape, fill, dtype=seq.dtype, device=seq.device) \
                if isinstance(seq, torch.Tensor) else np.full(shape, fill, seq.dtype)
        self[np.asarray(index) if isinstance(index, (list, tuple)) else index] = Batch({key: seq})

    # ---------------- value transforms (reference batch.py:578-628) ------
    def apply_values_transform(self, values_transform: Callable[[Any], Any], inplace: bool = False) -> Batch | None:
        """``values_transform`` applied to every leaf, nested Batches
        included (reference batch.py:578); in place with ``inplace``."""
        if not inplace:
            return self.map(values_transform)
        for k, v in self._d.items():
            if isinstance(v, Batch):
                v.apply_values_transform(values_transform, inplace=True)
            else:
                self._d[k] = values_transform(v)
        return None

    def to_at_least_2d(self) -> Batch:
        """Every leaf with at least 2 dims (reference batch.py:616)."""
        return self.map(lambda x: torch.atleast_2d(x) if isinstance(x, torch.Tensor) else np.atleast_2d(x))

    def mean(self, axis: Any = None, dtype: Any = None, out: Any = None, **kw: Any) -> Batch:
        """The per-leaf mean over the leading axis; ``np.mean(batch)`` calls
        it and returns a Batch, as in the reference (test_batch.py:489-497)."""
        def leaf_mean(x: Any) -> Any:
            if not isinstance(x, torch.Tensor):
                return x.mean(axis=0)
            return (x if x.is_floating_point() else x.to(torch.get_default_dtype())).mean(0)
        return self.map(leaf_mean)

    # ---------------- arithmetic (reference batch.py:795-844) ------------
    def _binary_op(self, other: Any, op: Callable[[Any, Any], Any]) -> Batch:
        out = Batch()
        if isinstance(other, Batch):
            if set(self._d) != set(other._d):
                raise ValueError("arithmetic requires identical keys")
            for k, v in self._d.items():
                w = other._d[k]
                out._d[k] = v._binary_op(w, op) if isinstance(v, Batch) else op(v, w)
            return out
        if not np.isscalar(other) and not isinstance(other, np.number):
            raise TypeError(f"unsupported operand type {type(other)}")
        for k, v in self._d.items():
            out._d[k] = v._binary_op(other, op) if isinstance(v, Batch) else op(v, other)
        return out

    def _inplace(self, res: Batch) -> Batch:
        self._d.clear()
        self._d.update(res._d)
        return self

    def __add__(self, other: Any) -> Batch:
        return self._binary_op(other, lambda a, b: a + b)

    def __iadd__(self, other: Any) -> Batch:
        return self._inplace(self + other)

    def __mul__(self, value: Any) -> Batch:
        return self._binary_op(value, lambda a, b: a * b)

    def __imul__(self, value: Any) -> Batch:
        return self._inplace(self * value)

    def __truediv__(self, value: Any) -> Batch:
        return self._binary_op(value, lambda a, b: a / b)

    def __itruediv__(self, value: Any) -> Batch:
        return self._inplace(self / value)

    # ---------------- null handling (reference batch.py:1294-1325) --------
    @staticmethod
    def _leaf_nan_mask(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return torch.isnan(x) if x.dtype.is_floating_point or x.dtype.is_complex else None
        if np.issubdtype(x.dtype, np.floating):
            return np.isnan(x)
        return None

    def _leaves(self) -> list:
        out = []
        for v in self._d.values():
            out += v._leaves() if isinstance(v, Batch) else [v]
        return out

    def hasnull(self) -> bool:
        masks = (self._leaf_nan_mask(x) for x in self._leaves())
        return any(m is not None and bool(m.any()) for m in masks)

    def isnull(self) -> Batch:
        """The elementwise NaN mask of every leaf (reference batch.py:1294)."""
        def f(x: Any) -> Any:
            m = self._leaf_nan_mask(x)
            if m is not None:
                return m
            return torch.zeros(x.shape, dtype=torch.bool, device=x.device) if isinstance(x, torch.Tensor) \
                else np.zeros(x.shape, bool)
        return self.map(f)

    def dropnull(self) -> Batch:
        """The rows where no leaf holds a NaN (reference batch.py:1325)."""
        n = len(self)
        bad = np.zeros(n, bool)
        for x in self._leaves():
            m = self._leaf_nan_mask(x)
            if m is not None:
                bad |= _as_numpy(m).reshape(n, -1).any(axis=1)
        return self[np.where(~bad)[0]]

    # ---------------- equality ----------------
    def __eq__(self, other: Any) -> bool:
        """Same keys, and at each key the same kind of node and, for leaves,
        the same shape, dtype and values (NaN equal to NaN)."""
        if not isinstance(other, Batch) or set(self._d) != set(other._d):
            return False
        for k, v in self._d.items():
            w = other._d[k]
            if isinstance(v, Batch) != isinstance(w, Batch):
                return False
            if isinstance(v, Batch):
                if v != w:
                    return False
                continue
            va, wa = _as_numpy(v), _as_numpy(w)
            if va.shape != wa.shape or va.dtype != wa.dtype:
                return False
            if va.dtype == object:
                if not all(x == y for x, y in zip(va.flat, wa.flat)):
                    return False
            elif va.dtype.kind in "fc":
                if not np.allclose(va, wa, equal_nan=True):
                    return False
            elif not np.array_equal(va, wa):
                return False
        return True


def create_value(inst: Any, size: int, stack: bool = True) -> Any:
    """A zeroed container for ``size`` rows of ``inst`` (reference batch.py
    ``create_value``:147), a tensor (numeric ``inst``) or a numpy array of
    objects: ``(size, *inst.shape)`` with ``stack=True``;
    with ``stack=False`` ``inst`` already carries a leading batch dim that
    ``size`` replaces. A Batch recurses per key."""
    if isinstance(inst, Batch):
        out = Batch()
        for k, v in inst.items():
            out[k] = create_value(v, size, stack)
        return out
    arr = _convert_value(inst)  # a tensor, or a numpy array of objects
    shape = (size, *arr.shape) if stack else (size, *arr.shape[1:])
    if isinstance(arr, torch.Tensor):
        return torch.zeros(shape, dtype=arr.dtype, device=arr.device)
    return np.zeros(shape, arr.dtype if arr.dtype != object else None)


def alloc_by_keys_diff(meta: Batch, batch: Batch, size: int, stack: bool = True) -> None:
    """Placeholders in ``meta`` for the keys ``batch`` has and ``meta`` lacks
    (reference batch.py ``alloc_by_keys_diff``:230)."""
    for key in batch.keys():
        if key in meta.keys():
            mv, bv = meta[key], batch[key]
            if isinstance(mv, Batch) and isinstance(bv, Batch):
                if not mv.keys():
                    meta[key] = create_value(bv, size, stack)
                else:
                    alloc_by_keys_diff(mv, bv, size, stack)
        else:
            meta[key] = create_value(batch[key], size, stack)
