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
built as before. RMSprop and SGD are the port's own optimizers
(:class:`RMSprop`, :class:`SGD`): multi-tensor steps whose state (the step
count, the second moment or the momentum trace) is made with the optimizer
on the parameters' device, so that they are capturable on any device.
RMSprop follows optax, not ``torch.optim.RMSprop``: it scales by
``rsqrt(nu + eps)`` (optax's ``eps_in_sqrt=True``), where torch divides by
``sqrt(nu) + eps``.

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

__all__ = ["RMSprop", "SGD", "AdamOptimizerFactory", "LinearLRSchedule", "OptimizerFactory", "RMSpropOptimizerFactory",
           "SGDOptimizerFactory", "clip_by_global_norm_", "init_adam_state", "linear_lr_schedule"]

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


class _ForeachOptimizer(torch.optim.Optimizer):
    """Base of the port's multi-tensor optimizers: every parameter's state
    (``step``, a 0-d float32 count on its device, and the buffers of
    :meth:`_buffers`) is made at construction, so that a step reads and
    writes only device tensors; ``lr`` is a float or a 0-d tensor."""

    def __init__(self, params: Iterable[torch.Tensor], defaults: dict) -> None:
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                for name in self._buffers(group):
                    self.state[p][name] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _buffers(self, group: dict) -> tuple[str, ...]:
        raise NotImplementedError

    def _update(self, group: dict, grads: list[torch.Tensor], states: list[dict]) -> list[torch.Tensor]:
        """The step's update direction before the learning rate, per parameter."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            upd = self._update(group, [p.grad for p in params], states)
            # optax: updates * (-lr), then params + updates
            lr = group["lr"]
            torch._foreach_mul_(upd, -lr if not torch.is_tensor(lr) else lr.neg())
            torch._foreach_add_(params, upd)
            torch._foreach_add_([s["step"] for s in states], 1.0)


class RMSprop(_ForeachOptimizer):
    """optax's ``rmsprop(lr, decay=alpha, eps)``: ``nu <- (1 - alpha) g^2 +
    alpha nu``, ``p <- p - lr * g * rsqrt(nu + eps)``."""

    def __init__(self, params, lr: float | torch.Tensor = 1e-2, alpha: float = 0.99, eps: float = 1e-8) -> None:
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps))

    def _buffers(self, group):
        return ("square_avg",)

    def _update(self, group, grads, states):
        nu = [s["square_avg"] for s in states]
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - group["alpha"])
        torch._foreach_add_(sq, torch._foreach_mul(nu, group["alpha"]))
        torch._foreach_copy_(nu, sq)
        scale = torch._foreach_add(nu, group["eps"])
        torch._foreach_rsqrt_(scale)
        return torch._foreach_mul(scale, grads)


class SGD(_ForeachOptimizer):
    """optax's ``sgd(lr, momentum)``: the trace ``t <- g + momentum t``
    (no trace at momentum 0, where it equals ``g``), ``p <- p - lr t``."""

    def __init__(self, params, lr: float | torch.Tensor = 1e-2, momentum: float = 0.0) -> None:
        super().__init__(params, dict(lr=lr, momentum=momentum))

    def _buffers(self, group):
        return ("momentum_buffer",) if group["momentum"] else ()

    def _update(self, group, grads, states):
        if not group["momentum"]:
            return [g.clone() for g in grads]
        trace = [s["momentum_buffer"] for s in states]
        torch._foreach_mul_(trace, group["momentum"])
        torch._foreach_add_(trace, grads)
        return [b.clone() for b in trace]


@dataclasses.dataclass
class OptimizerFactory:
    """Base: ``create(params)`` builds the optimizer, ``step(opt)`` clips and
    steps. ``lr`` is a float or a schedule of the update count
    (:func:`linear_lr_schedule`); with a schedule the rate is a 0-d tensor in
    the param groups, rewritten before every step from the optimizer's count
    (that of the update before it), as optax evaluates a schedule."""

    lr: float | Schedule = 1e-3
    max_grad_norm: float | None = dataclasses.field(default=None, kw_only=True)

    def create(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        raise NotImplementedError

    def _initial_lr(self, params: list[torch.Tensor]) -> float | torch.Tensor:
        lr = self.lr
        return lr(torch.zeros((), dtype=torch.float32, device=params[0].device)) if callable(lr) else lr

    def step(self, opt: torch.optim.Optimizer) -> None:
        if callable(self.lr):
            lr = self.lr(opt.state[opt.param_groups[0]["params"][0]]["step"])
            for group in opt.param_groups:
                group["lr"].copy_(lr)
        if self.max_grad_norm is not None:
            clip_by_global_norm_(
                [p for group in opt.param_groups for p in group["params"]], self.max_grad_norm
            )
        opt.step()


@dataclasses.dataclass
class AdamOptimizerFactory(OptimizerFactory):
    """``torch.optim.Adam``, reference optim.py:89."""

    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8

    def create(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        capturable = any(p.is_cuda for p in params)
        opt = torch.optim.Adam(params, lr=self._initial_lr(params), betas=self.betas, eps=self.eps,
                               capturable=capturable)
        if callable(self.lr):
            init_adam_state(opt)
        return opt


@dataclasses.dataclass
class RMSpropOptimizerFactory(OptimizerFactory):
    """:class:`RMSprop`, reference optim.py:113 with optax's placement of
    ``eps`` (``tianshou_tpu/algorithm/optim.py:44``)."""

    lr: float | Schedule = 1e-2
    alpha: float = 0.99
    eps: float = 1e-8

    def create(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        return RMSprop(params, lr=self._initial_lr(params), alpha=self.alpha, eps=self.eps)


@dataclasses.dataclass
class SGDOptimizerFactory(OptimizerFactory):
    """:class:`SGD` (``tianshou_tpu/algorithm/optim.py:54``)."""

    lr: float | Schedule = 1e-2
    momentum: float = 0.0

    def create(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        params = list(params)
        return SGD(params, lr=self._initial_lr(params), momentum=self.momentum)
