"""Truncated Taylor arithmetic on batched tensors, the port's stand-in for the
``jvp``/``jacfwd`` calls of ``tianshou_tpu/env/physics/dynamics.py``.

Every derivative the dynamics need is a derivative of forward kinematics. FK
is written once over :class:`Jet` values and evaluated three ways:

- order 0, ``Jet(v)``: the plain value;
- order 1, ``Jet(v, t)``: the value and ``K`` tangents at once (``jacfwd``);
- order 2, ``Jet(v, d, dd)``: value, first and second derivative along one
  direction (``jvp`` of ``jvp``).

Every component has shape ``[E, K or 1, *s]``: axis 0 is the env batch, axis
1 holds the ``K`` tangents of an order-1 jet (size 1 otherwise) and ``*s`` is
the structure of the quantity (``[3]``, ``[3, 3]``, ``[nb, 3]`` ...), so that
the product rule is plain broadcasting. Indexing, sums and stacking address
the trailing structure axes only (negative dims).
"""

from __future__ import annotations

import torch

__all__ = ["Jet", "stack"]


class Jet:
    __slots__ = ("c",)

    def __init__(self, *components: torch.Tensor) -> None:
        self.c = components

    @property
    def v(self) -> torch.Tensor:
        return self.c[0]

    def _map(self, fn) -> Jet:
        return Jet(*(fn(x) for x in self.c))

    # -- structure ---------------------------------------------------------
    def __getitem__(self, idx) -> Jet:
        return self._map(lambda x: x[idx])

    def sum(self, dim: int) -> Jet:
        if dim >= 0:
            raise ValueError("a Jet sums over trailing (negative) dims only")
        return self._map(lambda x: x.sum(dim))

    # -- linear ops ----------------------------------------------------------
    def __add__(self, other) -> Jet:
        if isinstance(other, Jet):
            return Jet(*(a + b for a, b in zip(self.c, other.c, strict=True)))
        return Jet(self.c[0] + other, *self.c[1:])


    def __neg__(self) -> Jet:
        return self._map(lambda x: -x)

    def __sub__(self, other) -> Jet:
        return self + (-other)

    def __rsub__(self, other) -> Jet:
        return (-self) + other

    # -- products ------------------------------------------------------------
    def __mul__(self, other) -> Jet:
        if not isinstance(other, Jet):
            return self._map(lambda x: x * other)
        a, b = self.c, other.c
        if len(a) != len(b):
            raise ValueError("product of jets of different order")
        out = [a[0] * b[0]]
        if len(a) > 1:
            out.append(a[1] * b[0] + a[0] * b[1])
        if len(a) > 2:
            out.append(a[2] * b[0] + 2.0 * (a[1] * b[1]) + a[0] * b[2])
        return Jet(*out)


    def apply(self, f: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor | None = None) -> Jet:
        """Compose with a scalar function whose value and derivatives at
        ``self.v`` are ``f``, ``f1`` and (for order 2) ``f2``."""
        c = self.c
        out = [f]
        if len(c) > 1:
            out.append(f1 * c[1])
        if len(c) > 2:
            out.append(f2 * (c[1] * c[1]) + f1 * c[2])
        return Jet(*out)

    def sin(self) -> Jet:
        s, c = torch.sin(self.v), torch.cos(self.v)
        return self.apply(s, c, -s)

    def cos(self) -> Jet:
        s, c = torch.sin(self.v), torch.cos(self.v)
        return self.apply(c, -s, -c)

    def sqrt(self) -> Jet:
        r = torch.sqrt(self.v)
        return self.apply(r, 0.5 / r, -0.25 / (r * self.v))

    def reciprocal(self) -> Jet:
        r = 1.0 / self.v
        return self.apply(r, -r * r, 2.0 * r * r * r)

    def __truediv__(self, other) -> Jet:
        if isinstance(other, Jet):
            return self * other.reciprocal()
        return self._map(lambda x: x / other)


def stack(items, dim: int):
    """``torch.stack`` of tensors or of jets of one order along a trailing dim."""
    if dim >= 0:
        raise ValueError("jets are stacked along trailing (negative) dims only")
    if not isinstance(items[0], Jet):
        return torch.stack(list(items), dim)
    n = len(items[0].c)
    # components of one jet may differ in their broadcast axes 0 and 1
    return Jet(*(torch.stack(list(torch.broadcast_tensors(*(it.c[k] for it in items))), dim) for k in range(n)))
