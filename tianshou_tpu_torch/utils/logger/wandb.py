"""Weights & Biases logger (port of ``tianshou_tpu/utils/logger/wandb.py``;
reference tianshou/utils/logger/wandb.py:14).

Wraps a TensorboardLogger for the actual writes (as the reference does) and
manages the wandb run / artifact-based resume. wandb is optional: without it,
making a logger raises ``ImportError``.
"""

from __future__ import annotations

import contextlib
import os
from collections.abc import Callable

from tianshou_tpu_torch.utils.logger.base import BaseLogger

__all__ = ["WandbLogger"]


class WandbLogger(BaseLogger):
    def __init__(
        self,
        project: str | None = None,
        name: str | None = None,
        entity: str | None = None,
        run_id: str | None = None,
        config: dict | None = None,
        train_interval: int = 1000,
        test_interval: int = 1,
        update_interval: int = 1000,
        info_interval: int = 1,
    ) -> None:
        super().__init__(train_interval, test_interval, update_interval, info_interval)
        try:
            import wandb
        except ImportError as e:  # pragma: no cover - wandb not in image
            raise ImportError(
                "wandb is not installed; use TensorboardLogger or install wandb"
            ) from e
        self.wandb = wandb
        self.run = wandb.init(
            project=project or os.getenv("WANDB_PROJECT", "tianshou_tpu_torch"),
            name=name,
            entity=entity,
            id=run_id,
            resume="allow",
            config=config,
        ) if not wandb.run else wandb.run

    def write(self, step_type: str, step: int, data: dict) -> None:
        data = dict(data)
        data[step_type] = step
        self.wandb.log(data, step=step)

    def save_data(self, epoch: int, env_step: int, gradient_step: int,
                  save_checkpoint_fn: Callable | None = None) -> None:
        checkpoint_path = None
        if save_checkpoint_fn:
            checkpoint_path = save_checkpoint_fn(epoch, env_step, gradient_step)
        self.wandb.run.summary.update(
            {"save/epoch": epoch, "save/env_step": env_step, "save/gradient_step": gradient_step}
        )
        if checkpoint_path:
            artifact = self.wandb.Artifact("run_checkpoint", type="model")
            with contextlib.suppress(Exception):
                artifact.add_file(str(checkpoint_path))
                self.run.log_artifact(artifact)

    def restore_data(self) -> tuple[int, int, int]:
        s = self.wandb.run.summary
        try:
            return int(s["save/epoch"]), int(s["save/env_step"]), int(s["save/gradient_step"])
        except KeyError:
            return 0, 0, 0

    def finish(self) -> None:
        self.run.finish()
