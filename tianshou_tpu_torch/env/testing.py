"""Deterministic test environments (port of ``tianshou_tpu/env/testing.py``),
mirroring the reference's fixtures (test/base/env.py): ``MoveToRightEnv``
makes collector and buffer behavior exactly predictable (obs == position)
and its episodes draw nothing from the generator."""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep

__all__ = ["MoveState", "MoveToRightEnv"]


class MoveState(NamedTuple):
    index: torch.Tensor  # [E] int32
    t: torch.Tensor      # [E] int32


class MoveToRightEnv(Env):
    """1-D walk: action 1 moves right, action 0 stays; the episode ends at
    ``size`` with reward 1 (reference test/base/env.py:12)."""

    def __init__(self, size: int = 5, max_episode_steps: int = 100) -> None:
        self.size = size
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=[0.0], high=[float(size)])
        self.action_space = Discrete(2)

    @staticmethod
    def _obs(s: MoveState) -> torch.Tensor:
        return s.index.to(torch.float32)[:, None]

    def reset(self, num_envs, generator, device):
        z = torch.zeros(num_envs, dtype=torch.int32, device=device)
        s = MoveState(z, z.clone())
        return s, self._obs(s)

    def step(self, state: MoveState, action: torch.Tensor, generator) -> EnvStep:
        index = torch.clamp(state.index + (action > 0).to(torch.int32), max=self.size)
        t = state.t + 1
        terminated = index >= self.size
        new = MoveState(index, t)
        return EnvStep(
            state=new,
            obs=self._obs(new),
            reward=terminated.to(torch.float32),
            terminated=terminated,
            truncated=(t >= self.max_episode_steps) & ~terminated,
            info=Batch(),
        )
