"""CartPole (port of ``tianshou_tpu/env/classic/cartpole.py``): the classic
cart-pole balancing task (Barto, Sutton and Anderson) with Gymnasium
CartPole-v1's constants and its Euler step, kinematics first, so that the
reference's reward thresholds apply (test/discrete/test_dqn.py:69, 195).

Batched as the port's envs are: the state is a :class:`CartPoleState` of
``[E]`` tensors, reset draws ``U(-0.05, 0.05)`` for each of the four
coordinates from the generator, the reward is float32 ones, and an episode is
truncated at ``max_episode_steps``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep

__all__ = ["CartPole", "CartPoleState"]


class CartPoleState(NamedTuple):
    x: torch.Tensor          # [E] float32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor          # [E] int32 step counter, for truncation


class CartPole(Env):
    max_episode_steps = 500

    def __init__(self, max_episode_steps: int = 500) -> None:
        self.max_episode_steps = max_episode_steps
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masscart + self.masspole
        self.length = 0.5  # half the pole's length
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = [self.x_threshold * 2, 3.4e38, self.theta_threshold * 2, 3.4e38]
        self.observation_space = Box(low=[-h for h in high], high=high)
        self.action_space = Discrete(2)

    @staticmethod
    def _obs(s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def reset(self, num_envs, generator, device):
        init = torch.rand((num_envs, 4), generator=generator, device=device) * 0.1 - 0.05
        s = CartPoleState(*init.unbind(-1), torch.zeros(num_envs, dtype=torch.int32, device=device))
        return s, self._obs(s)

    def step(self, state: CartPoleState, action: torch.Tensor, generator) -> EnvStep:
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        temp = (force + self.polemass_length * state.theta_dot**2 * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        # Euler integration, kinematics first ("euler" mode in gymnasium)
        x = state.x + self.tau * state.x_dot
        x_dot = state.x_dot + self.tau * xacc
        theta = state.theta + self.tau * state.theta_dot
        theta_dot = state.theta_dot + self.tau * thetaacc
        t = state.t + 1
        new = CartPoleState(x, x_dot, theta, theta_dot, t)
        terminated = (x.abs() > self.x_threshold) | (theta.abs() > self.theta_threshold)
        return EnvStep(
            state=new,
            obs=self._obs(new),
            reward=torch.ones_like(x),
            terminated=terminated,
            truncated=(t >= self.max_episode_steps) & ~terminated,
            info=Batch(),
        )
