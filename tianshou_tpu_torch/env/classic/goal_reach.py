"""GoalReach (port of ``tianshou_tpu/env/classic/goal_reach.py``): a sparse
reward 2-D goal-conditioned env in the style of FetchReach, the device
counterpart of the reference's MyGoalEnv HER fixture (test/base/env.py:209).
The reward is -1 until the agent is within ``eps`` of the goal, which a
random walk almost never reaches at long horizons without HER's relabelling.

Batched as the port's envs are: ``reset`` draws the position and the goal,
each ``U(-size, size)`` per coordinate, from two ``[E, 2]`` uniforms
(:meth:`GoalReach.reset_from` takes them, for tests that hand JAX's over).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Env, EnvStep

__all__ = ["GoalReach", "GoalReachState"]


class GoalReachState(NamedTuple):
    pos: torch.Tensor   # [E, 2]
    goal: torch.Tensor  # [E, 2]
    t: torch.Tensor     # [E] int32


class GoalReach(Env):
    max_episode_steps = 40

    def __init__(self, size: float = 1.0, step_size: float = 0.1, eps: float = 0.1,
                 max_episode_steps: int = 40) -> None:
        self.size = size
        self.step_size = step_size
        self.eps = eps
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=[-size] * 2, high=[size] * 2)  # of 'observation'
        self.action_space = Box(low=[-1.0, -1.0], high=[1.0, 1.0])

    def compute_reward(self, achieved: torch.Tensor, desired: torch.Tensor) -> torch.Tensor:
        """0 where ``|achieved - desired| < eps``, else -1 (float32); the norm
        as ``jnp.linalg.norm`` computes it, the root of the summed squares."""
        diff = achieved - desired
        d = torch.sqrt((diff * diff).sum(-1))
        return torch.where(d < self.eps, 0.0, -1.0).to(torch.float32)

    @staticmethod
    def _obs(s: GoalReachState) -> Batch:
        return Batch(observation=s.pos, achieved_goal=s.pos, desired_goal=s.goal)

    def reset_from(self, u_pos: torch.Tensor, u_goal: torch.Tensor) -> tuple[GoalReachState, Batch]:
        """The reset state of uniforms ``u_pos``, ``u_goal`` in ``[0, 1)``, ``[E, 2]``
        each, scaled as ``jax.random.uniform(minval=-size, maxval=size)`` scales them."""
        lo, hi = -self.size, self.size

        def scale(u: torch.Tensor) -> torch.Tensor:
            return torch.clamp(u * (hi - lo) + lo, min=lo)

        s = GoalReachState(scale(u_pos), scale(u_goal),
                           torch.zeros(u_pos.shape[0], dtype=torch.int32, device=u_pos.device))
        return s, self._obs(s)

    def reset(self, num_envs: int, generator: torch.Generator, device: torch.device):
        u = torch.rand((2, num_envs, 2), generator=generator, device=device)
        return self.reset_from(u[0], u[1])

    def step(self, state: GoalReachState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        act = action.clamp(-1.0, 1.0) * self.step_size
        pos = (state.pos + act).clamp(-self.size, self.size)
        t = state.t + 1
        new = GoalReachState(pos, state.goal, t)
        rew = self.compute_reward(pos, state.goal)
        reached = rew >= 0.0
        return EnvStep(state=new, obs=self._obs(new), reward=rew, terminated=reached,
                       truncated=(t >= self.max_episode_steps) & ~reached, info=Batch())
