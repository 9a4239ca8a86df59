"""Loggers (port of ``tianshou_tpu/utils/logger``): the scoped base, a no-op
and an in-memory curve logger; TensorBoard and wandb live in their own
modules, which import their libraries only when a logger is made."""

from tianshou_tpu_torch.utils.logger.base import BaseLogger, CurveLogger, DataScope, LazyLogger

__all__ = ["BaseLogger", "CurveLogger", "DataScope", "LazyLogger"]
