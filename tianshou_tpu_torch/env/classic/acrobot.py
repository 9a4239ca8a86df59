"""Acrobot (port of ``tianshou_tpu/env/classic/acrobot.py``): the two-link
underactuated swing-up with Sutton's "book" dynamics, Gymnasium Acrobot-v1's
constants and its RK4 step.

Batched as the port's envs are: the state is an :class:`AcrobotState` of
``[E]`` tensors; reset draws four uniforms per env from the generator
(angles and velocities in [-0.1, 0.1)), :meth:`Acrobot.reset_from` takes them
as given; the action is the torque index in {0, 1, 2} (-1, 0, +1); an
episode terminates when the tip rises above the bar and is truncated at
``max_episode_steps``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep

__all__ = ["Acrobot", "AcrobotState"]


class AcrobotState(NamedTuple):
    theta1: torch.Tensor   # [E] float32
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor
    t: torch.Tensor        # [E] int32 step counter, for truncation


def _wrap(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return lo + (x - lo) % (hi - lo)


def _uniform_in(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``u`` in [0, 1) onto [lo, hi) in float32, as ``jax.random.uniform``
    scales its bits: ``max(lo, u * (hi - lo) + lo)`` with the bounds and their
    difference rounded to float32 (host numbers: a CUDA graph captures a
    collect chunk's resets)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return (u * float(hi32 - lo32) + float(lo32)).clamp_(min=float(lo32))


class Acrobot(Env):
    max_episode_steps = 500

    LINK_LENGTH_1 = 1.0
    LINK_MASS_1 = 1.0
    LINK_MASS_2 = 1.0
    LINK_COM_POS_1 = 0.5
    LINK_COM_POS_2 = 0.5
    LINK_MOI = 1.0
    MAX_VEL_1 = 4 * math.pi
    MAX_VEL_2 = 9 * math.pi
    dt = 0.2
    g = 9.8

    def __init__(self, max_episode_steps: int = 500) -> None:
        self.max_episode_steps = max_episode_steps
        high = [1.0, 1.0, 1.0, 1.0, float(self.MAX_VEL_1), float(self.MAX_VEL_2)]
        self.observation_space = Box(low=[-h for h in high], high=high)
        self.action_space = Discrete(3)

    @staticmethod
    def _obs(s: AcrobotState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta1), torch.sin(s.theta1), torch.cos(s.theta2), torch.sin(s.theta2),
                            s.dtheta1, s.dtheta2], dim=-1)

    def reset_from(self, uniform: torch.Tensor) -> tuple[AcrobotState, torch.Tensor]:
        """The reset state from ``[E, 4]`` uniforms in [0, 1)."""
        init = _uniform_in(uniform, -0.1, 0.1)
        s = AcrobotState(*init.unbind(-1), torch.zeros(uniform.shape[0], dtype=torch.int32, device=uniform.device))
        return s, self._obs(s)

    def reset(self, num_envs, generator, device):
        return self.reset_from(torch.rand((num_envs, 4), generator=generator, device=device))

    def _dsdt(self, s_aug: torch.Tensor) -> torch.Tensor:
        """The time derivative of ``[5, E]`` (angles, velocities, torque)."""
        m1, m2 = self.LINK_MASS_1, self.LINK_MASS_2
        l1 = self.LINK_LENGTH_1
        lc1, lc2 = self.LINK_COM_POS_1, self.LINK_COM_POS_2
        I1 = I2 = self.LINK_MOI
        g = self.g
        theta1, theta2, dtheta1, dtheta2, a = s_aug.unbind(0)
        d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * torch.cos(theta2)) + I1 + I2
        d2 = m2 * (lc2**2 + l1 * lc2 * torch.cos(theta2)) + I2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (
            -m2 * l1 * lc2 * dtheta2**2 * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2)
            + phi2
        )
        # the "book" dynamics (Gymnasium's default)
        ddtheta2 = (a + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1**2 * torch.sin(theta2) - phi2) / (
            m2 * lc2**2 + I2 - d2**2 / d1
        )
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2, torch.zeros_like(a)])

    def step(self, state: AcrobotState, action: torch.Tensor, generator) -> EnvStep:
        torque = (action.reshape(-1) - 1).to(torch.float32)  # {-1, 0, +1}
        s_aug = torch.stack([state.theta1, state.theta2, state.dtheta1, state.dtheta2, torque])
        dt = self.dt
        k1 = self._dsdt(s_aug)
        k2 = self._dsdt(s_aug + dt / 2 * k1)
        k3 = self._dsdt(s_aug + dt / 2 * k2)
        k4 = self._dsdt(s_aug + dt * k3)
        ns = s_aug + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        theta1 = _wrap(ns[0], -math.pi, math.pi)
        theta2 = _wrap(ns[1], -math.pi, math.pi)
        dtheta1 = ns[2].clamp(-self.MAX_VEL_1, self.MAX_VEL_1)
        dtheta2 = ns[3].clamp(-self.MAX_VEL_2, self.MAX_VEL_2)
        t = state.t + 1
        new = AcrobotState(theta1, theta2, dtheta1, dtheta2, t)
        terminated = (-torch.cos(theta1) - torch.cos(theta2 + theta1)) > 1.0
        return EnvStep(
            state=new,
            obs=self._obs(new),
            reward=torch.where(terminated, 0.0, -1.0),
            terminated=terminated,
            truncated=(t >= self.max_episode_steps) & ~terminated,
            info=Batch(),
        )
