"""tianshou_tpu_torch: the PyTorch/CUDA port of ``tianshou_tpu``.

It keeps the JAX package's module layout and names, so that every module has
an obvious counterpart, and uses PyTorch idiom inside: ``nn.Module``s, plain
functions on tensors, an explicit ``device`` and explicit
``torch.Generator``s. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Kernels that the JAX package wrote in Pallas for the TPU
are hand-written CUDA kernels here (``ops/kernels``).
"""

__version__ = "0.1.0"

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import ReplayBuffer, VectorReplayBuffer
from tianshou_tpu_torch.data.buffer.her import HERReplayBuffer, HERVectorReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedReplayBuffer, PrioritizedVectorReplayBuffer
from tianshou_tpu_torch.data.collector import CollectStats, DeviceCollector
from tianshou_tpu_torch.env.core import Box, Discrete, Env, MultiDiscrete, VectorDeviceEnv
from tianshou_tpu_torch.trainer.trainer import (
    OfflineTrainer,
    OfflineTrainerParams,
    OffPolicyTrainer,
    OffPolicyTrainerParams,
    OnPolicyTrainer,
    OnPolicyTrainerParams,
)

__all__ = [
    "Batch",
    "Box",
    "CollectStats",
    "DeviceCollector",
    "Discrete",
    "Env",
    "HERReplayBuffer",
    "HERVectorReplayBuffer",
    "MultiDiscrete",
    "OfflineTrainer",
    "OfflineTrainerParams",
    "OffPolicyTrainer",
    "OffPolicyTrainerParams",
    "OnPolicyTrainer",
    "OnPolicyTrainerParams",
    "PrioritizedReplayBuffer",
    "PrioritizedVectorReplayBuffer",
    "ReplayBuffer",
    "VectorDeviceEnv",
    "VectorReplayBuffer",
    "__version__",
]
