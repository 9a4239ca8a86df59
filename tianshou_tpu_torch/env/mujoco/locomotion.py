"""Device MuJoCo-class benchmark environments (port of
``tianshou_tpu/env/mujoco/locomotion.py`` without Humanoid).

Observation layouts, reward terms, healthy ranges, control costs, horizons
and reset noise follow the Gymnasium v4 envs. Ant exposes a quaternion in
its observation (converted from the internal rotation-vector coordinates) so
the 27-dim layout matches. All hooks take ``[E, ...]`` tensors.
"""

from __future__ import annotations

import math

import torch

from tianshou_tpu_torch.env.mujoco.base import MujocoEnv, PhysState
from tianshou_tpu_torch.env.physics.algebra import rotvec_to_mat, rotvec_to_quat
from tianshou_tpu_torch.env.physics.dynamics import _rotvec_jacobian, forward_kinematics
from tianshou_tpu_torch.env.physics.linalg import mv

__all__ = ["HalfCheetah", "Hopper", "Walker2d", "Ant", "Swimmer", "Reacher"]


class _Forward(MujocoEnv):
    """Shared reward of the forward-running tasks:
    ``healthy_reward + x_velocity - ctrl_cost_weight * ||a||^2``."""

    ctrl_cost_weight = 0.0
    healthy_reward = 0.0

    def _reward(self, q0, qd0, q1, qd1, action):
        x_vel = (q1[:, 0] - q0[:, 0]) / self.dt
        return x_vel + self.healthy_reward - self.ctrl_cost_weight * (action * action).sum(-1)


class HalfCheetah(_Forward):
    """HalfCheetah-v4 task: obs = (qpos[1:], qvel) [17], reward =
    x-velocity - 0.1*||a||^2, no termination, 1000-step horizon."""

    xml = "half_cheetah.xml"
    frame_skip = 5
    reset_noise_scale = 0.1
    ctrl_cost_weight = 0.1

    def _obs(self, q, qd):
        return torch.cat([q[:, 1:], qd], -1).to(torch.float32)


class Hopper(_Forward):
    """Hopper-v4: obs = (qpos[1:], clip(qvel, +-10)) [11]; healthy z>0.7,
    |angle|<0.2, |state|<100; reward = 1 + x_vel - 1e-3*||a||^2."""

    xml = "hopper.xml"
    frame_skip = 4
    reset_noise_scale = 5e-3
    reset_noise_kind = "both_uniform"
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0

    def _obs(self, q, qd):
        return torch.cat([q[:, 1:], torch.clamp(qd, -10.0, 10.0)], -1).to(torch.float32)

    def _terminated(self, q, qd):
        state = torch.cat([q[:, 2:], qd], -1)
        healthy = (state.abs() < 100.0).all(-1) & (q[:, 1] > 0.7) & (q[:, 2].abs() < 0.2)
        return ~healthy


class Walker2d(_Forward):
    """Walker2d-v4: obs [17]; healthy 0.8<z<2.0, |angle|<1.0;
    reward = 1 + x_vel - 1e-3*||a||^2."""

    xml = "walker2d.xml"
    frame_skip = 4
    reset_noise_scale = 5e-3
    reset_noise_kind = "both_uniform"
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0

    def _obs(self, q, qd):
        return torch.cat([q[:, 1:], torch.clamp(qd, -10.0, 10.0)], -1).to(torch.float32)

    def _terminated(self, q, qd):
        return ~((q[:, 1] > 0.8) & (q[:, 1] < 2.0) & (q[:, 2].abs() < 1.0))


class Ant(_Forward):
    """Ant-v4: obs [27] = (z, quat, joint angles, qvel with body-frame
    angular velocity); healthy 0.2<z<1.0 and all finite;
    reward = 1 + x_vel - 0.5*||a||^2."""

    xml = "ant.xml"
    frame_skip = 5
    contact_iterations = 30
    reset_noise_scale = 0.1
    ctrl_cost_weight = 0.5
    healthy_reward = 1.0

    def _obs(self, q, qd):
        # internal coords: q = (pos3, rotvec3, 8 joints); gym layout is
        # qpos[2:] = (z, quat4, joints8) and qvel = (v3, omega3, joints8)
        r = q[:, 3:6]
        omega_world = mv(_rotvec_jacobian(r), qd[:, 3:6])
        omega_body = mv(rotvec_to_mat(r).transpose(-1, -2), omega_world)
        return torch.cat([q[:, 2:3], rotvec_to_quat(r), q[:, 6:], qd[:, :3], omega_body, qd[:, 6:]], -1).to(torch.float32)

    def _terminated(self, q, qd):
        healthy = torch.isfinite(q).all(-1) & torch.isfinite(qd).all(-1) & (q[:, 2] > 0.2) & (q[:, 2] < 1.0)
        return ~healthy


class Swimmer(_Forward):
    """Swimmer-v4: obs [8] = (qpos[2:], qvel); reward = x_vel - 1e-4*||a||^2;
    no termination. Propulsion comes from the anisotropic fluid drag
    (option density/viscosity in the model)."""

    xml = "swimmer.xml"
    frame_skip = 4
    reset_noise_scale = 0.1
    reset_noise_kind = "both_uniform"
    ctrl_cost_weight = 1e-4

    def _obs(self, q, qd):
        return torch.cat([q[:, 2:], qd], -1).to(torch.float32)


class Reacher(MujocoEnv):
    """Reacher-v4: two-link arm reaching a random target; obs [11];
    reward = -(dist + ||a||^2); 50-step horizon, no termination."""

    xml = "reacher.xml"
    frame_skip = 2
    max_episode_steps = 50
    reset_noise_scale = 0.1

    def _to_target(self, q):
        tip = forward_kinematics(self.model, q)[0][:, 3]  # fingertip body
        target = torch.cat([q[:, 2:4], torch.full_like(q[:, :1], 0.01)], -1)
        return tip - target

    def _obs(self, q, qd):
        return torch.cat([torch.cos(q[:, :2]), torch.sin(q[:, :2]), q[:, 2:4], qd[:, :2], self._to_target(q)],
                         -1).to(torch.float32)

    def reset_noise(self, num_envs, generator, device):
        """``(arm [E, 2] in +-0.1, u [E, 2] in [0, 1) for the target, dqd [E, nq] in +-0.005)``."""
        arm = (torch.rand((num_envs, 2), generator=generator, device=device) * 2.0 - 1.0) * 0.1
        u = torch.rand((num_envs, 2), generator=generator, device=device)
        dqd = (torch.rand((num_envs, self.model.nq), generator=generator, device=device) * 2.0 - 1.0) * 0.005
        return arm, u, dqd

    def reset_from_noise(self, arm, u, dqd):
        q0 = self.qpos0(arm.device).expand(arm.shape[0], -1)
        # target uniform in the radius-0.2 disk (gym resamples a square)
        r = 0.2 * torch.sqrt(u[:, 0])
        th = 2 * math.pi * u[:, 1]
        q = torch.cat([q0[:, :2] + arm, (r * torch.cos(th))[:, None], (r * torch.sin(th))[:, None], q0[:, 4:]], -1)
        qd = torch.cat([dqd[:, :2], torch.zeros_like(dqd[:, 2:4]), dqd[:, 4:]], -1).to(torch.float32)
        st = PhysState(q.to(torch.float32), qd, torch.zeros(q.shape[0], dtype=torch.int32, device=q.device))
        return st, self._obs(st.q, st.qd)

    def _reward(self, q0, qd0, q1, qd1, action):
        return -torch.linalg.norm(self._to_target(q0), dim=-1) - (action * action).sum(-1)
