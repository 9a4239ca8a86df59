"""High-level config dataclasses (port of ``tianshou_tpu/highlevel/config.py``;
reference highlevel/config.py:12
``TrainingConfig`` and experiment.py:126 ``ExperimentConfig``)."""

from __future__ import annotations

import dataclasses

__all__ = [
    "ExperimentConfig",
    "TrainingConfig",
    "OnPolicyTrainingConfig",
    "OffPolicyTrainingConfig",
    "OfflineTrainingConfig",
]


@dataclasses.dataclass
class ExperimentConfig:
    seed: int = 0
    persistence_base_dir: str = "log"
    persistence_enabled: bool = True
    watch: bool = False            # replay the best policy after training
    watch_num_episodes: int = 10


@dataclasses.dataclass
class TrainingConfig:
    max_epochs: int = 10
    epoch_num_steps: int = 10000
    num_train_envs: int = 16
    num_test_envs: int = 10
    test_step_num_episodes: int = 10
    buffer_size: int = 20000
    start_timesteps: int = 0
    start_timesteps_random: bool = True
    replay_buffer_stack_num: int = 1
    stop_threshold: float | None = None


@dataclasses.dataclass
class OnPolicyTrainingConfig(TrainingConfig):
    batch_size: int = 256
    collection_step_num_env_steps: int = 128
    update_step_num_repetitions: int = 10


@dataclasses.dataclass
class OffPolicyTrainingConfig(TrainingConfig):
    batch_size: int = 64
    collection_step_num_env_steps: int = 10
    update_step_num_gradient_steps_per_sample: float = 0.1


@dataclasses.dataclass
class OfflineTrainingConfig(TrainingConfig):
    batch_size: int = 128
    update_step_num_gradient_steps_per_epoch: int = 500
