"""High-level trainer callbacks (port of ``tianshou_tpu/highlevel/trainer.py``;
reference highlevel/trainer.py:25-150).

The reference's callbacks set the policy's attributes at epoch boundaries
(e.g. ``policy.set_eps``); here, as in the JAX package, a train or test
callback returns a dict of hyper-parameter overrides, which the trainer
writes into the train state's ``hparams`` device scalars before the phase
(the low-level ``train_fn`` / ``test_fn``, trainer/trainer.py).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = [
    "TrainingContext",
    "EpochTrainCallback",
    "EpochTestCallback",
    "EpochStopCallback",
    "TrainerCallbacks",
    "EpochTrainCallbackDQNSetEps",
    "EpochTrainCallbackDQNEpsLinearDecay",
    "EpochTestCallbackDQNSetEps",
    "EpochStopCallbackRewardThreshold",
]


class TrainingContext:
    """What a callback may inspect (reference highlevel/trainer.py:18)."""

    def __init__(self, algorithm: Any, env: Any, logger: Any) -> None:
        self.algorithm = algorithm
        self.env = env
        self.logger = logger


class EpochTrainCallback(ABC):
    """Called at the start of each epoch's collection phase; returns hparam
    overrides (reference highlevel/trainer.py:25)."""

    @abstractmethod
    def callback(self, epoch: int, env_step: int, context: TrainingContext) -> dict | None:
        ...

    def get_trainer_fn(self, context: TrainingContext) -> Callable[[int, int], dict | None]:
        return lambda epoch, env_step: self.callback(epoch, env_step, context)


class EpochTestCallback(ABC):
    """Called at the start of each epoch's test phase (reference :41)."""

    @abstractmethod
    def callback(self, epoch: int, env_step: int | None, context: TrainingContext) -> dict | None:
        ...

    def get_trainer_fn(self, context: TrainingContext) -> Callable[[int, int], dict | None]:
        return lambda epoch, env_step: self.callback(epoch, env_step, context)


class EpochStopCallback(ABC):
    """Decides early stop from the test score (reference :55)."""

    @abstractmethod
    def should_stop(self, mean_rewards: float, context: TrainingContext) -> bool:
        ...

    def get_trainer_fn(self, context: TrainingContext) -> Callable[[float], bool]:
        return lambda mean_rewards: self.should_stop(mean_rewards, context)


@dataclass
class TrainerCallbacks:
    """Bundle (reference highlevel/trainer.py:77)."""

    epoch_train_callback: EpochTrainCallback | None = None
    epoch_test_callback: EpochTestCallback | None = None
    epoch_stop_callback: EpochStopCallback | None = None


@dataclass
class EpochTrainCallbackDQNSetEps(EpochTrainCallback):
    """Constant training epsilon (reference :85)."""

    eps: float = 0.1

    def callback(self, epoch: int, env_step: int, context: TrainingContext) -> dict:
        return {"eps_training": self.eps}


@dataclass
class EpochTrainCallbackDQNEpsLinearDecay(EpochTrainCallback):
    """Linear epsilon decay over ``decay_steps`` (reference :99)."""

    eps_train: float = 1.0
    eps_final: float = 0.05
    decay_steps: int = 1_000_000

    def callback(self, epoch: int, env_step: int, context: TrainingContext) -> dict:
        frac = min(env_step / self.decay_steps, 1.0)
        return {"eps_training": self.eps_train + frac * (self.eps_final - self.eps_train)}


@dataclass
class EpochTestCallbackDQNSetEps(EpochTestCallback):
    """Evaluation epsilon (reference :123)."""

    eps: float = 0.0

    def callback(self, epoch: int, env_step: int | None, context: TrainingContext) -> dict:
        return {"eps_inference": self.eps}


@dataclass
class EpochStopCallbackRewardThreshold(EpochStopCallback):
    """Stop when the test score reaches a threshold; None resolves from the
    env's ``reward_threshold`` if it has one (reference :137)."""

    threshold: float | None = None

    def should_stop(self, mean_rewards: float, context: TrainingContext) -> bool:
        t = self.threshold
        if t is None:
            t = getattr(context.env, "reward_threshold", None)
        return t is not None and mean_rewards >= t
