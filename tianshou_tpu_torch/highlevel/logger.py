"""High-level logger factory (port of ``tianshou_tpu/highlevel/logger.py``;
reference highlevel/logger.py:36 ``LoggerFactoryDefault``): pick tensorboard
or wandb by name, rooted at the experiment's persistence directory. Each
logger module imports its library only when a logger is made."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Literal

__all__ = ["LoggerFactory", "LoggerFactoryDefault"]


class LoggerFactory:
    """Callable protocol: ``factory(run_name) -> BaseLogger``."""

    def __call__(self, run_name: str) -> Any:  # pragma: no cover - interface
        raise NotImplementedError


@dataclass
class LoggerFactoryDefault(LoggerFactory):
    logger_type: Literal["tensorboard", "wandb"] = "tensorboard"
    log_dir: str = "log"
    wandb_project: str | None = None

    def __call__(self, run_name: str) -> Any:
        log_dir = os.path.join(self.log_dir, run_name)
        if self.logger_type == "wandb":
            from tianshou_tpu_torch.utils.logger.wandb import WandbLogger

            return WandbLogger(project=self.wandb_project, name=run_name)
        from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger

        return TensorboardLogger(log_dir=log_dir)
