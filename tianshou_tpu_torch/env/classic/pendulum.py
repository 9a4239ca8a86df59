"""Pendulum (port of ``tianshou_tpu/env/classic/pendulum.py``): the swing-up
task with Gymnasium Pendulum-v1's constants, so that the reference's
continuous-control threshold (-250, test/continuous/test_sac_with_il.py:86)
applies.

Batched as the port's envs are: the state is a :class:`PendulumState` of
``[E]`` tensors; reset draws two uniforms per env from the generator
(``theta`` in [-pi, pi), ``theta_dot`` in [-1, 1)), :meth:`Pendulum.reset_from`
takes them as given; episodes never terminate and are truncated at
``max_episode_steps``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Env, EnvStep

__all__ = ["Pendulum", "PendulumState"]


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return ((x + math.pi) % (2 * math.pi)) - math.pi


class PendulumState(NamedTuple):
    theta: torch.Tensor      # [E] float32
    theta_dot: torch.Tensor  # [E] float32
    t: torch.Tensor          # [E] int32 step counter, for truncation


class Pendulum(Env):
    max_episode_steps = 200

    def __init__(self, max_episode_steps: int = 200, g: float = 10.0) -> None:
        self.max_episode_steps = max_episode_steps
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = g
        self.m = 1.0
        self.l = 1.0
        self.observation_space = Box(low=[-1.0, -1.0, -self.max_speed], high=[1.0, 1.0, self.max_speed])
        self.action_space = Box(low=[-self.max_torque], high=[self.max_torque])

    @staticmethod
    def _obs(s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)

    def reset_from(self, uniform: torch.Tensor) -> tuple[PendulumState, torch.Tensor]:
        """The reset state from ``[E, 2]`` uniforms in [0, 1)."""
        theta = uniform[:, 0] * 2 * math.pi - math.pi
        theta_dot = uniform[:, 1] * 2.0 - 1.0
        s = PendulumState(theta, theta_dot, torch.zeros(uniform.shape[0], dtype=torch.int32, device=uniform.device))
        return s, self._obs(s)

    def reset(self, num_envs, generator, device):
        return self.reset_from(torch.rand((num_envs, 2), generator=generator, device=device))

    def step(self, state: PendulumState, action: torch.Tensor, generator) -> EnvStep:
        u = action.reshape(-1).clamp(-self.max_torque, self.max_torque)
        th, thdot = state.theta, state.theta_dot
        cost = _angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * u**2
        newthdot = thdot + (3 * self.g / (2 * self.l) * torch.sin(th) + 3.0 / (self.m * self.l**2) * u) * self.dt
        newthdot = newthdot.clamp(-self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        t = state.t + 1
        new = PendulumState(newth, newthdot, t)
        return EnvStep(
            state=new,
            obs=self._obs(new),
            reward=-cost,
            terminated=torch.zeros_like(t, dtype=torch.bool),
            truncated=t >= self.max_episode_steps,
            info=Batch(),
        )
