"""Batch: a recursive dict of tensors with attribute access.

Port of the subset of ``tianshou_tpu/data/batch.py`` (reference
``tianshou/data/batch.py:625``) that the replay, collect and update path
uses: construction from kwargs and dicts, attribute and item access,
``keys``/``items``/``values``, ``get``/``pop``/``copy``, ``in``, a leaf-wise
:meth:`Batch.map` and :meth:`Batch.to`. Values are ``torch.Tensor``s or
nested ``Batch``es; numpy arrays and Python scalars are converted to tensors
on assignment.
"""

from __future__ import annotations

import copy
from collections.abc import Callable, ItemsView, KeysView, ValuesView
from typing import Any

import numpy as np
import torch

__all__ = ["Batch"]


def _convert_value(v: Any) -> Any:
    if isinstance(v, (Batch, torch.Tensor)):
        return v
    if isinstance(v, dict):
        return Batch(v)
    if isinstance(v, (np.ndarray, np.generic, bool, int, float)):
        return torch.as_tensor(v)
    raise TypeError(f"Batch values are tensors, arrays, scalars or dicts; got {type(v)}")


class Batch:
    """Recursive dict of tensors with attribute access."""

    __slots__ = ("_d",)

    def __init__(self, _input: dict | Batch | None = None, **kwargs: Any) -> None:
        d: dict[str, Any] = {}
        object.__setattr__(self, "_d", d)
        if _input is not None:
            if not isinstance(_input, (dict, Batch)):
                raise TypeError(f"cannot construct Batch from {type(_input)}")
            for k, v in _input.items():
                d[k] = _convert_value(v)
        for k, v in kwargs.items():
            d[k] = _convert_value(v)

    # ---------------- dict protocol ----------------
    def keys(self) -> KeysView:
        return self._d.keys()

    def values(self) -> ValuesView:
        return self._d.values()

    def items(self) -> ItemsView:
        return self._d.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._d.get(key, default)

    def pop(self, key: str, *default: Any) -> Any:
        return self._d.pop(key, *default)

    def __contains__(self, key: str) -> bool:
        return key in self._d

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
            out._d[k] = v[index]
        return out

    def __setitem__(self, key: str, value: Any) -> None:
        if not isinstance(key, str):
            raise TypeError("Batch item assignment takes a str key")
        self._d[key] = _convert_value(value)

    def __delitem__(self, key: str) -> None:
        del self._d[key]

    def __len__(self) -> int:
        lens = [len(v) for v in self._d.values() if not (isinstance(v, torch.Tensor) and v.dim() == 0)]
        if not lens:
            raise TypeError("Batch without a batched entry has no len()")
        return min(lens)

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k}={tuple(v.shape)}:{v.dtype}" if isinstance(v, torch.Tensor) else f"{k}={v!r}"
            for k, v in self._d.items()
        )
        return f"Batch({inner})"

    # ---------------- leaf-wise ops ----------------
    def copy(self) -> Batch:
        """Shallow copy: a new (nested) key structure sharing the tensors."""
        return self.map(lambda x: x)

    def __deepcopy__(self, memo: dict) -> Batch:
        out = Batch()
        for k, v in self._d.items():
            out._d[k] = copy.deepcopy(v, memo)
        return out

    def map(self, fn: Callable[[torch.Tensor], Any]) -> Batch:
        """A new Batch with ``fn`` applied to every tensor leaf."""
        out = Batch()
        for k, v in self._d.items():
            out._d[k] = v.map(fn) if isinstance(v, Batch) else fn(v)
        return out

    def to(self, device: str | torch.device) -> Batch:
        return self.map(lambda x: x.to(device))
