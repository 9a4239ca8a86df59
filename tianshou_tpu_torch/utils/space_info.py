"""Space introspection helpers (port of ``tianshou_tpu/utils/space_info.py``;
reference utils/space_info.py:11):
shape/bounds extraction working over BOTH the device Space descriptors and
Gymnasium spaces, so high-level factories accept either."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["ActionSpaceInfo", "ObservationSpaceInfo", "SpaceInfo"]


def _is_discrete(space: Any) -> bool:
    return hasattr(space, "n")


@dataclasses.dataclass
class ActionSpaceInfo:
    action_shape: tuple
    action_dim: int
    min_action: float | None = None
    max_action: float | None = None

    @classmethod
    def from_space(cls, space: Any) -> "ActionSpaceInfo":
        if _is_discrete(space):
            return cls(action_shape=(), action_dim=int(space.n))
        shape = tuple(space.shape)
        low = getattr(space, "low_arr", getattr(space, "low", None))
        high = getattr(space, "high_arr", getattr(space, "high", None))
        return cls(
            action_shape=shape,
            action_dim=int(np.prod(shape)),
            min_action=float(np.min(low)) if low is not None else None,
            max_action=float(np.max(high)) if high is not None else None,
        )


@dataclasses.dataclass
class ObservationSpaceInfo:
    obs_shape: tuple
    obs_dim: int

    @classmethod
    def from_space(cls, space: Any) -> "ObservationSpaceInfo":
        if _is_discrete(space):
            return cls(obs_shape=(), obs_dim=int(space.n))
        shape = tuple(space.shape)
        return cls(obs_shape=shape, obs_dim=int(np.prod(shape)))


@dataclasses.dataclass
class SpaceInfo:
    action_info: ActionSpaceInfo
    observation_info: ObservationSpaceInfo

    @classmethod
    def from_env(cls, env: Any) -> "SpaceInfo":
        return cls(
            action_info=ActionSpaceInfo.from_space(env.action_space),
            observation_info=ObservationSpaceInfo.from_space(env.observation_space),
        )
