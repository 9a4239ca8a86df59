"""Device env wrappers (port of ``tianshou_tpu/env/wrappers.py``; only
``FrameStack`` so far)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from tianshou_tpu_torch.env.core import Box, Env

__all__ = ["FrameStack", "FrameStackState"]


class FrameStackState(NamedTuple):
    inner: Any
    frames: torch.Tensor  # [E, n_frames, ...obs]


class FrameStack(Env):
    """Stack the last ``n_frames`` observations along a new axis after the
    env axis (device analogue of the Atari FrameStack wrapper,
    atari_wrapper.py:278). Pair with a buffer using ``save_only_last_obs=True``
    and ``stack_num`` so that frames are stored once and re-stacked at sample
    time."""

    def __init__(self, env: Env, n_frames: int = 4) -> None:
        self.env = env
        self.n_frames = n_frames
        self.action_space = env.action_space
        self.max_episode_steps = env.max_episode_steps
        self.observation_space = Box(
            low=0.0, high=1.0, shape=(n_frames,) + tuple(env.observation_space.shape)
        )

    def reset(self, num_envs, generator, device):
        s, obs = self.env.reset(num_envs, generator, device)
        frames = obs[:, None].repeat_interleave(self.n_frames, dim=1)
        return FrameStackState(s, frames), frames

    def step(self, state: FrameStackState, action, generator):
        s = self.env.step(state.inner, action, generator)
        frames = torch.cat([state.frames[:, 1:], s.obs[:, None]], dim=1)
        return s._replace(state=FrameStackState(s.state, frames), obs=frames)

