"""Device MuJoCo-class benchmark environments (port of ``tianshou_tpu/env/mujoco``)."""

from tianshou_tpu_torch.env.mujoco.base import MujocoEnv, PhysState
from tianshou_tpu_torch.env.mujoco.locomotion import Ant, HalfCheetah, Hopper, Humanoid, Reacher, Swimmer, Walker2d

__all__ = [
    "MujocoEnv", "PhysState", "HalfCheetah", "Hopper", "Walker2d", "Ant", "Swimmer", "Reacher", "Humanoid", "REGISTRY",
    "make",
]

REGISTRY = {
    "HalfCheetah": HalfCheetah,
    "Hopper": Hopper,
    "Walker2d": Walker2d,
    "Ant": Ant,
    "Swimmer": Swimmer,
    "Reacher": Reacher,
    "Humanoid": Humanoid,
}


def make(task: str, **kwargs) -> MujocoEnv:
    """Create a device env by task name; accepts gym-style suffixes
    ("HalfCheetah-v4" -> HalfCheetah)."""
    base = task.split("-")[0]
    if base not in REGISTRY:
        raise KeyError(f"unknown or unported task {task!r}; ported: {sorted(REGISTRY)}")
    return REGISTRY[base](**kwargs)
