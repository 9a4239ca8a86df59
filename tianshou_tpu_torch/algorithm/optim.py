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

The learning rate may be a schedule (:func:`linear_lr_schedule`, the
reference's ``LRSchedulerFactoryLinear``, optim.py:22), evaluated, as optax
evaluates it, at the optimizer's update count before the update. The rate is
then a 0-d float32 tensor in the param group, on the parameters' device,
rewritten in place from the optimizer's step count before every step, so
that a captured step reads the rate of its own count (a host float in a
graph would be a constant).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Iterable

import torch

__all__ = ["AdamOptimizerFactory", "LinearLRSchedule", "OptimizerFactory", "clip_by_global_norm_", "init_adam_state",
           "linear_lr_schedule"]

#: a learning rate as a function of the update count (a 0-d float32 tensor) -> 0-d float32 tensor
Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LinearLRSchedule:
    """``lr * (1 - min(count, total) / total)`` in float32:
    ``optax.linear_schedule(lr, 0, total)``."""

    lr: float
    total_updates: int

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        frac = 1.0 - count.to(torch.float32).clamp(0, self.total_updates) / self.total_updates
        return torch.full((), self.lr, dtype=torch.float32, device=count.device) * frac


def linear_lr_schedule(lr: float, total_updates: int) -> LinearLRSchedule:
    """lr * (1 - t/total): reference LRSchedulerFactoryLinear (optim.py:22)."""
    return LinearLRSchedule(lr, total_updates)


def init_adam_state(opt: torch.optim.Optimizer) -> None:
    """Make Adam's state (step count and both moments, zero) for every
    parameter now, as its first step would (``Adam._init_group``), so that
    the state exists before that step: the KL guard of
    :class:`tianshou_tpu_torch.algorithm.modelfree.ppo.PPO` snapshots it
    and a schedule reads its count."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            if state:
                continue
            on_device = group["capturable"] or group.get("fused")
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device if on_device else "cpu")
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            if group["amsgrad"]:
                state["max_exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


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
    """``torch.optim.Adam``, reference optim.py:89. ``lr`` is a float or a
    schedule of the update count (:func:`linear_lr_schedule`)."""

    lr: float | Schedule = 1e-3
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8

    def create(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        capturable = any(p.is_cuda for p in params)
        lr = self.lr(torch.zeros((), dtype=torch.float32, device=params[0].device)) if callable(self.lr) else self.lr
        opt = torch.optim.Adam(params, lr=lr, betas=self.betas, eps=self.eps, capturable=capturable)
        if callable(self.lr):
            init_adam_state(opt)
        return opt

    def step(self, opt: torch.optim.Optimizer) -> None:
        """With a schedule, first write the rate of the coming update (that of
        the count before it) into the param groups."""
        if callable(self.lr):
            lr = self.lr(opt.state[opt.param_groups[0]["params"][0]]["step"])
            for group in opt.param_groups:
                group["lr"].copy_(lr)
        super().step(opt)
