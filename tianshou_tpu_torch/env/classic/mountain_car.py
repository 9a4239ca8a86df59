"""MountainCar, discrete and continuous (port of
``tianshou_tpu/env/classic/mountain_car.py``): Moore's car in a valley with
Gymnasium MountainCar-v0's and MountainCarContinuous-v0's constants.

Batched as the port's envs are: the state is a :class:`MountainCarState` of
``[E]`` tensors; reset draws one uniform per env from the generator (the
position in [-0.6, -0.4), the velocity 0), :meth:`reset_from` takes it as
given; an episode terminates at the goal and is truncated at
``max_episode_steps``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.classic.acrobot import _uniform_in
from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep

__all__ = ["MountainCar", "MountainCarContinuous", "MountainCarState"]


class MountainCarState(NamedTuple):
    position: torch.Tensor  # [E] float32
    velocity: torch.Tensor
    t: torch.Tensor         # [E] int32 step counter, for truncation


class _MountainCarBase(Env):
    def _setup(self, max_episode_steps: int, goal_position: float) -> None:
        self.max_episode_steps = max_episode_steps
        self.min_position, self.max_position = -1.2, 0.6
        self.max_speed = 0.07
        self.goal_position = goal_position
        self.observation_space = Box(low=[self.min_position, -self.max_speed], high=[self.max_position, self.max_speed])

    @staticmethod
    def _obs(s: MountainCarState) -> torch.Tensor:
        return torch.stack([s.position, s.velocity], dim=-1)

    def reset_from(self, uniform: torch.Tensor) -> tuple[MountainCarState, torch.Tensor]:
        """The reset state from ``[E]`` uniforms in [0, 1)."""
        pos = _uniform_in(uniform, -0.6, -0.4)
        s = MountainCarState(pos, torch.zeros_like(pos), torch.zeros(pos.shape[0], dtype=torch.int32, device=pos.device))
        return s, self._obs(s)

    def reset(self, num_envs, generator, device):
        return self.reset_from(torch.rand(num_envs, generator=generator, device=device))

    def _move(self, state: MountainCarState, velocity: torch.Tensor) -> tuple[MountainCarState, torch.Tensor]:
        """Clip the new velocity, move, stop at the left wall; (new state, terminated)."""
        velocity = velocity.clamp(-self.max_speed, self.max_speed)
        position = (state.position + velocity).clamp(self.min_position, self.max_position)
        velocity = torch.where((position == self.min_position) & (velocity < 0), 0.0, velocity)
        return MountainCarState(position, velocity, state.t + 1), position >= self.goal_position

    def _env_step(self, new: MountainCarState, terminated: torch.Tensor, reward: torch.Tensor) -> EnvStep:
        return EnvStep(
            state=new,
            obs=self._obs(new),
            reward=reward,
            terminated=terminated,
            truncated=(new.t >= self.max_episode_steps) & ~terminated,
            info=Batch(),
        )


class MountainCar(_MountainCarBase):
    max_episode_steps = 200

    def __init__(self, max_episode_steps: int = 200) -> None:
        self._setup(max_episode_steps, goal_position=0.5)
        self.force = 0.001
        self.gravity = 0.0025
        self.action_space = Discrete(3)

    def step(self, state: MountainCarState, action: torch.Tensor, generator) -> EnvStep:
        velocity = state.velocity + (action.reshape(-1) - 1) * self.force + torch.cos(3 * state.position) * (-self.gravity)
        new, terminated = self._move(state, velocity)
        return self._env_step(new, terminated, torch.full_like(new.position, -1.0))


class MountainCarContinuous(_MountainCarBase):
    max_episode_steps = 999

    def __init__(self, max_episode_steps: int = 999) -> None:
        self._setup(max_episode_steps, goal_position=0.45)
        self.power = 0.0015
        self.action_space = Box(low=[-1.0], high=[1.0])

    def step(self, state: MountainCarState, action: torch.Tensor, generator) -> EnvStep:
        force = action.reshape(-1).clamp(-1.0, 1.0)
        velocity = state.velocity + force * self.power - 0.0025 * torch.cos(3 * state.position)
        new, terminated = self._move(state, velocity)
        return self._env_step(new, terminated, torch.where(terminated, 100.0, 0.0) - 0.1 * force**2)
