"""Small-matrix linear algebra on batched tensors, the counterpart of
``tianshou_tpu/env/physics/linalg.py``.

The JAX package unrolls its Cholesky because the TPU's library path is slow
for tiny matrices. This is the plain version of the physics, so it calls
``torch.linalg``; the fused step kernel carries its own unrolled factor and
solves (``ops/kernels/csrc/physics_fused.cu``). All functions act on the last
two axes and broadcast over leading batch axes.
"""

from __future__ import annotations

import torch

__all__ = ["chol", "chol_solve", "spd_solve", "mv", "mm", "inv3"]


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Matrix-vector ``A @ x`` over the last two/one axes."""
    return (A * x[..., None, :]).sum(-1)


def mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Matrix-matrix ``A @ B`` over the last two axes."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of ``[..., 3, 3]`` via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack([torch.stack([co00, co01, co02], -1), torch.stack([co10, co11, co12], -1),
                       torch.stack([co20, co21, co22], -1)], -2)
    return adj / det[..., None, None]


def chol(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``M [..., n, n]``. ``cholesky_ex`` does not read its error
    code back to the host, so a CUDA graph can capture it."""
    return torch.linalg.cholesky_ex(M)[0]


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b`` with ``b`` ``[..., n]`` or ``[..., n, m]``: the two triangular solves
    that LAPACK's ``potrs`` makes (the same bits as ``torch.cholesky_solve`` on the CPU), each a
    batched triangular solve that a CUDA graph can capture."""
    x = b[..., None] if b.dim() == L.dim() - 1 else b
    x = torch.linalg.solve_triangular(L, x, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), x, upper=True)
    return x[..., 0] if b.dim() == L.dim() - 1 else x


def spd_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``M x = b``."""
    return chol_solve(chol(M), b)
