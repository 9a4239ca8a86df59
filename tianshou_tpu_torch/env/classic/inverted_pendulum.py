"""InvertedPendulum and InvertedDoublePendulum (port of
``tianshou_tpu/env/classic/inverted_pendulum.py``): balance tasks with the
MuJoCo task structure (reward, termination, horizon), so that the reference's
table rows apply (InvertedPendulum 1000.0 for every continuous algorithm,
InvertedDoublePendulum ~9350).

The dynamics are cart-pole and cart-double-pole Lagrangian mechanics stepped
by semi-implicit Euler substeps, not the MuJoCo soft-constraint solver, as in
the JAX package. Batched as the port's envs are: the state is a
:class:`PendState` of ``[E, n]`` tensors. A reset draws ``2n`` uniforms in
[-0.01, 0.01) per env from the generator; :meth:`reset_from_noise` takes them
as given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Env, EnvStep

__all__ = ["InvertedPendulum", "InvertedDoublePendulum", "PendState"]


class PendState(NamedTuple):
    q: torch.Tensor   # [E, n] generalized coordinates: x, th1 (, th2)
    qd: torch.Tensor  # [E, n]
    t: torch.Tensor   # [E] int32 step counter, for truncation


class _Balance(Env):
    """What both tasks share: the reset and the time limit."""

    max_episode_steps = 1000
    n = 2  # generalized coordinates

    def reset_noise(self, num_envs: int, generator: torch.Generator, device) -> torch.Tensor:
        """``[E, 2n]`` uniforms in [-0.01, 0.01): the initial ``q`` and ``qd``."""
        return (torch.rand((num_envs, 2 * self.n), generator=generator, device=device) * 2.0 - 1.0) * 0.01

    def reset_from_noise(self, init: torch.Tensor) -> tuple[PendState, torch.Tensor]:
        """The reset state from ``init [E, 2n]`` (as :meth:`reset_noise` draws it)."""
        init = init.to(torch.float32)
        s = PendState(init[:, :self.n], init[:, self.n:],
                      torch.zeros(init.shape[0], dtype=torch.int32, device=init.device))
        return s, self._obs(s)

    def reset(self, num_envs: int, generator: torch.Generator, device):
        return self.reset_from_noise(self.reset_noise(num_envs, generator, device))

    def _obs(self, s: PendState) -> torch.Tensor:
        raise NotImplementedError

    def _step(self, state: PendState, q, qd, reward, terminated) -> EnvStep:
        t = state.t + 1
        new = PendState(q, qd, t)
        return EnvStep(state=new, obs=self._obs(new), reward=reward.to(torch.float32), terminated=terminated,
                       truncated=(t >= self.max_episode_steps) & ~terminated, info=Batch())


class InvertedPendulum(_Balance):
    """Continuous-force cart-pole: reward 1 per step, terminate at |theta| > 0.2,
    horizon 1000 (MuJoCo InvertedPendulum-v4 task structure)."""

    def __init__(self, max_episode_steps: int = 1000) -> None:
        self.max_episode_steps = max_episode_steps
        self.force_mag = 10.0
        self.dt = 0.02
        self.masscart, self.masspole, self.length, self.g = 1.0, 0.1, 0.5, 9.8
        self.observation_space = Box(low=[-10, -10, -10, -10], high=[10, 10, 10, 10])
        self.action_space = Box(low=[-1.0], high=[1.0])

    def _obs(self, s: PendState) -> torch.Tensor:
        return torch.cat([s.q, s.qd], -1).to(torch.float32)

    def step(self, state: PendState, action: torch.Tensor, generator=None) -> EnvStep:
        force = torch.clamp(action.reshape(-1), -1.0, 1.0) * self.force_mag
        x, th = state.q[:, 0], state.q[:, 1]
        xd, thd = state.qd[:, 0], state.qd[:, 1]
        mc, mp, l, g = self.masscart, self.masspole, self.length, self.g
        total = mc + mp
        for _ in range(2):  # two half-steps of semi-implicit Euler
            dt = self.dt / 2
            sin, cos = torch.sin(th), torch.cos(th)
            temp = (force + mp * l * thd**2 * sin) / total
            thacc = (g * sin - cos * temp) / (l * (4.0 / 3.0 - mp * cos**2 / total))
            xacc = temp - mp * l * thacc * cos / total
            xd = xd + dt * xacc
            thd = thd + dt * thacc
            x = x + dt * xd
            th = th + dt * thd
            # the rail is a physical stop, not a failure (MuJoCo's slide limit)
            at_wall = x.abs() >= 1.0
            x = torch.clamp(x, -1.0, 1.0)
            xd = torch.where(at_wall, torch.zeros_like(xd), xd)
        return self._step(state, torch.stack([x, th], -1), torch.stack([xd, thd], -1), torch.ones_like(x),
                          th.abs() > 0.2)


class InvertedDoublePendulum(_Balance):
    """Cart with a two-link pole: alive bonus 10 per step less tip-distance and
    velocity penalties, terminate when the tip's height falls to 0.6
    (MuJoCo InvertedDoublePendulum-v4 task structure; solved ~9350)."""

    n = 3

    def __init__(self, max_episode_steps: int = 1000) -> None:
        self.max_episode_steps = max_episode_steps
        self.force_mag = 40.0
        self.dt = 0.01
        self.m0, self.m1, self.m2 = 1.0, 0.1, 0.1   # cart, link 1, link 2
        self.l1, self.l2 = 0.6, 0.6
        self.g = 9.81
        high = [10.0] * 9
        self.observation_space = Box(low=[-h for h in high], high=high)
        self.action_space = Box(low=[-1.0], high=[1.0])

    def _obs(self, s: PendState) -> torch.Tensor:
        t1, t2 = s.q[:, 1], s.q[:, 2]
        return torch.stack([s.q[:, 0], torch.sin(t1), torch.sin(t2), torch.cos(t1), torch.cos(t2),
                            s.qd[:, 0], s.qd[:, 1], s.qd[:, 2], torch.zeros_like(t1)], -1).to(torch.float32)

    def _accel(self, q: torch.Tensor, qd: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
        """The mass-matrix form of the cart + two-link pendulum Lagrangian (point masses at the links' ends)."""
        t1, t2 = q[:, 1], q[:, 2]
        w1, w2 = qd[:, 1], qd[:, 2]
        m0, m1, m2, l1, l2, g = self.m0, self.m1, self.m2, self.l1, self.l2, self.g
        a = m0 + m1 + m2
        b = (m1 + m2) * l1
        c = m2 * l2
        s1, c1 = torch.sin(t1), torch.cos(t1)
        s2, c2 = torch.sin(t2), torch.cos(t2)
        s12, c12 = torch.sin(t1 - t2), torch.cos(t1 - t2)
        full = torch.full_like
        M = torch.stack([
            torch.stack([full(t1, a), b * c1, c * c2], -1),
            torch.stack([b * c1, full(t1, (m1 + m2) * l1**2), c * l1 * c12], -1),
            torch.stack([c * c2, c * l1 * c12, full(t1, m2 * l2**2)], -1),
        ], -2)
        rhs = torch.stack([
            force + b * s1 * w1**2 + c * s2 * w2**2,
            (m1 + m2) * g * l1 * s1 - c * l1 * s12 * w2**2,
            m2 * g * l2 * s2 + c * l1 * s12 * w1**2,
        ], -1)
        # light joint damping keeps the integrator stable
        rhs = rhs - torch.stack([torch.zeros_like(w1), 0.05 * w1, 0.05 * w2], -1)
        return torch.linalg.solve(M, rhs)

    def step(self, state: PendState, action: torch.Tensor, generator=None) -> EnvStep:
        force = torch.clamp(action.reshape(-1), -1.0, 1.0) * self.force_mag
        q, qd = state.q, state.qd
        for _ in range(2):  # semi-implicit Euler substeps
            qd = qd + self.dt * self._accel(q, qd, force)
            q = q + self.dt * qd
        q = torch.cat([torch.clamp(q[:, :1], -2.4, 2.4), q[:, 1:]], -1)
        # the tip's height above the cart's pivot (1.2 when upright)
        y_tip = self.l1 * torch.cos(q[:, 1]) + self.l2 * torch.cos(q[:, 2])
        x_tip = q[:, 0] + self.l1 * torch.sin(q[:, 1]) + self.l2 * torch.sin(q[:, 2])
        dist_pen = 0.01 * x_tip**2 + (y_tip - 1.2) ** 2 * 5.0
        vel_pen = 1e-3 * qd[:, 1] ** 2 + 5e-3 * qd[:, 2] ** 2
        return self._step(state, q, qd, 10.0 - dist_pen - vel_pen, y_tip <= 0.6)
