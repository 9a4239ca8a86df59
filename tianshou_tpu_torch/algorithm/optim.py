"""Optimizer factories (port of ``tianshou_tpu/algorithm/optim.py``; reference
tianshou/algorithm/optim.py).

A factory builds a ``torch.optim`` optimizer over a module's parameters and
steps it with the reference's ordering (algorithm_base.py:484-500): clip the
gradients by their global norm, then take the optimizer step. The clip
matches ``optax.clip_by_global_norm``: gradients are scaled by
``max_norm / norm`` only where ``norm >= max_norm``, with no epsilon.

On CUDA parameters Adam is built with ``capturable=True``: its step count and
bias corrections live on the device, so that a CUDA graph can capture the
step. Capturable Adam does not take CPU parameters, and on the CPU it is
built as before.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import torch

__all__ = ["AdamOptimizerFactory", "OptimizerFactory", "clip_by_global_norm_"]


def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the ``.grad`` of ``params`` in place so that their global L2
    norm is at most ``max_norm``, without a host sync. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@dataclasses.dataclass
class OptimizerFactory:
    """Base: ``create(params)`` builds the optimizer, ``step(opt)`` clips and steps."""

    max_grad_norm: float | None = dataclasses.field(default=None, kw_only=True)

    def create(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        raise NotImplementedError

    def step(self, opt: torch.optim.Optimizer) -> None:
        if self.max_grad_norm is not None:
            clip_by_global_norm_(
                [p for group in opt.param_groups for p in group["params"]], self.max_grad_norm
            )
        opt.step()


@dataclasses.dataclass
class AdamOptimizerFactory(OptimizerFactory):
    """``torch.optim.Adam``, reference optim.py:89."""

    lr: float = 1e-3
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8

    def create(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        capturable = any(p.is_cuda for p in params)
        return torch.optim.Adam(params, lr=self.lr, betas=self.betas, eps=self.eps, capturable=capturable)
