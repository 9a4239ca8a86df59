"""NChain (port of ``tianshou_tpu/env/classic/nchain.py``): the classic
exploration chain (Strens 2000) with the state index as its observation, the
PSRL test env (reference examples/modelbased/psrl uses NChain-v0).

Action 0 moves one state forward (reward ``large`` at the chain's end,
where the agent stays), action 1 returns to the start (reward ``small``);
with probability ``slip`` the other action is taken. Batched as the port's
envs are: ``[E]`` int32 positions and step counts; episodes never terminate
and are truncated at ``max_episode_steps``. :meth:`NChain.step_from` takes
the slip's uniforms, so that tests can hand the JAX env's draws over.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Discrete, Env, EnvStep

__all__ = ["NChain", "NChainState"]


class NChainState(NamedTuple):
    pos: torch.Tensor  # [E] int32
    t: torch.Tensor    # [E] int32


class NChain(Env):
    max_episode_steps = 100

    def __init__(self, n: int = 5, slip: float = 0.2, small: float = 2.0, large: float = 10.0,
                 max_episode_steps: int = 100) -> None:
        self.n = n
        self.slip = slip
        self.small = small
        self.large = large
        self.max_episode_steps = max_episode_steps
        self.observation_space = Box(low=[0.0], high=[float(n - 1)])
        self.action_space = Discrete(2)

    @staticmethod
    def _obs(s: NChainState) -> torch.Tensor:
        return s.pos.to(torch.float32)[:, None]

    def reset(self, num_envs, generator, device):
        zeros = torch.zeros(num_envs, dtype=torch.int32, device=device)
        s = NChainState(zeros, zeros.clone())
        return s, self._obs(s)

    def step(self, state: NChainState, action: torch.Tensor, generator) -> EnvStep:
        return self.step_from(state, action, torch.rand(state.pos.shape, generator=generator, device=state.pos.device))

    def step_from(self, state: NChainState, action: torch.Tensor, uniform: torch.Tensor) -> EnvStep:
        """One step with the slip decided by ``uniform < slip`` (``[E]`` in ``[0, 1)``)."""
        act = torch.where(uniform < self.slip, 1 - action, action)
        forward = act == 0
        pos = torch.where(forward, torch.clamp(state.pos + 1, max=self.n - 1), 0).to(torch.int32)
        reward = torch.where(forward, torch.where(state.pos == self.n - 1, self.large, 0.0), self.small)
        t = state.t + 1
        new = NChainState(pos, t)
        return EnvStep(state=new, obs=self._obs(new), reward=reward.to(torch.float32),
                       terminated=torch.zeros_like(t, dtype=torch.bool), truncated=t >= self.max_episode_steps,
                       info=Batch())
