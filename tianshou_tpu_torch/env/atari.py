"""The DeepMind Atari wrapper stack (port of ``tianshou_tpu/env/atari.py``;
reference env/atari/atari_wrapper.py: NoopResetEnv:57, MaxAndSkipEnv:90,
EpisodicLifeEnv:134, FireResetEnv:193, WarpFrame:213, ScaledFloatFrame:238,
ClipRewardEnv:263, FrameStack:278, wrap_deepmind:335, make_atari_env:391).

Host numpy over the Gymnasium API (``reset(**kw) -> (obs, info)``, a
5-tuple ``step``), with a numpy grayscale and nearest-row resize (no cv2).
``make_atari_env`` imports gymnasium only when it is called.

Two departures from the JAX module, both the reference's behaviour:
- :class:`FrameStack` stacks the frames on a new leading axis, oldest first
  (``[n, 84, 84]``). The JAX module stacks them last (``[84, 84, n]``), where
  a buffer's ``save_only_last_obs``, which keeps index ``-1`` of the axis
  after the env axis, would keep a row of pixels instead of the newest frame.
- :class:`NoopResetEnv` draws its no-op count from a generator that a
  ``reset(seed=...)`` reseeds, so that seeded vector envs repeat themselves
  in any worker process.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["ClipRewardEnv", "EpisodicLifeEnv", "FireResetEnv", "FrameStack", "MaxAndSkipEnv", "NoopResetEnv",
           "ScaledFloatFrame", "WarpFrame", "make_atari_env", "wrap_deepmind"]


class _Wrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, a):
        return self.env.step(a)


class NoopResetEnv(_Wrapper):
    """After a reset, 1 to ``noop_max`` no-op steps (action 0)."""

    def __init__(self, env, noop_max: int = 30):
        super().__init__(env)
        self.noop_max = noop_max
        self._rng = np.random.default_rng()

    def reset(self, **kw):
        if kw.get("seed") is not None:
            self._rng = np.random.default_rng(kw["seed"])
        obs, info = self.env.reset(**kw)
        for _ in range(self._rng.integers(1, self.noop_max + 1)):
            obs, _, term, trunc, info = self.env.step(0)
            if term or trunc:
                obs, info = self.env.reset(**kw)
        return obs, info


class MaxAndSkipEnv(_Wrapper):
    """Repeat the action ``skip`` times; the reward summed, the last two
    frames max-pooled; stops early at an episode end."""

    def __init__(self, env, skip: int = 4):
        super().__init__(env)
        self.skip = skip

    def step(self, a):
        total = 0.0
        frames = deque(maxlen=2)
        term = trunc = False
        info = {}
        obs = None
        for _ in range(self.skip):
            obs, r, term, trunc, info = self.env.step(a)
            frames.append(obs)
            total += r
            if term or trunc:
                break
        out = np.max(np.stack(frames), axis=0) if len(frames) > 1 else obs
        return out, total, term, trunc, info


class EpisodicLifeEnv(_Wrapper):
    """A lost life ends the episode for the agent; the game resets only
    when it really ended."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, a):
        obs, r, term, trunc, info = self.env.step(a)
        self.was_real_done = term or trunc
        lives = self.env.unwrapped.ale.lives()
        if 0 < lives < self.lives:
            term = True
        self.lives = lives
        return obs, r, term, trunc, info

    def reset(self, **kw):
        if self.was_real_done:
            obs, info = self.env.reset(**kw)
        else:
            obs, _, _, _, info = self.env.step(0)
        self.lives = self.env.unwrapped.ale.lives()
        return obs, info


class FireResetEnv(_Wrapper):
    """Press FIRE (action 1) after every reset."""

    def reset(self, **kw):
        self.env.reset(**kw)
        obs, _, term, trunc, info = self.env.step(1)
        if term or trunc:
            self.env.reset(**kw)
        return obs, info


class WarpFrame(_Wrapper):
    """Grayscale (0.299, 0.587, 0.114) and a nearest-row resize to 84x84 uint8."""

    size = 84

    def _warp(self, frame: np.ndarray) -> np.ndarray:
        gray = (frame @ np.array([0.299, 0.587, 0.114])).astype(np.float32)
        h, w = gray.shape
        ys = (np.arange(self.size) * h // self.size).clip(0, h - 1)
        xs = (np.arange(self.size) * w // self.size).clip(0, w - 1)
        return gray[np.ix_(ys, xs)].astype(np.uint8)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        return self._warp(obs), info

    def step(self, a):
        obs, r, term, trunc, info = self.env.step(a)
        return self._warp(obs), r, term, trunc, info


class ScaledFloatFrame(_Wrapper):
    """uint8 [0, 255] -> float32 [0, 1] frames."""

    def _scale(self, obs):
        return np.asarray(obs, np.float32) / 255.0

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        return self._scale(obs), info

    def step(self, a):
        obs, r, term, trunc, info = self.env.step(a)
        return self._scale(obs), r, term, trunc, info


class ClipRewardEnv(_Wrapper):
    """Rewards clipped to their sign."""

    def step(self, a):
        obs, r, term, trunc, info = self.env.step(a)
        return obs, float(np.sign(r)), term, trunc, info


class FrameStack(_Wrapper):
    """The last ``n_frames`` frames, ``[n_frames, *frame]`` oldest first; a
    reset fills the stack with copies of its frame."""

    def __init__(self, env, n_frames: int = 4):
        super().__init__(env)
        self.n = n_frames
        self.frames: deque = deque(maxlen=n_frames)

    def _obs(self):
        return np.stack(list(self.frames), axis=0)

    def reset(self, **kw):
        obs, info = self.env.reset(**kw)
        for _ in range(self.n):
            self.frames.append(obs)
        return self._obs(), info

    def step(self, a):
        obs, r, term, trunc, info = self.env.step(a)
        self.frames.append(obs)
        return self._obs(), r, term, trunc, info


def wrap_deepmind(
    env,
    episode_life: bool = True,
    clip_rewards: bool = True,
    frame_stack: int = 4,
    warp_frame: bool = True,
    noop_max: int = 30,
    max_and_skip: int = 4,
):
    """The standard DeepMind preprocessing stack (reference atari_wrapper.py:335);
    ``FireResetEnv`` only where the game has a FIRE action."""
    if noop_max:
        env = NoopResetEnv(env, noop_max)
    if max_and_skip:
        env = MaxAndSkipEnv(env, max_and_skip)
    if episode_life:
        env = EpisodicLifeEnv(env)
    if "FIRE" in env.unwrapped.get_action_meanings():
        env = FireResetEnv(env)
    if warp_frame:
        env = WarpFrame(env)
    if clip_rewards:
        env = ClipRewardEnv(env)
    if frame_stack:
        env = FrameStack(env, frame_stack)
    return env


def make_atari_env(task: str, **kwargs):
    """A wrapped ALE env (reference make_atari_env:391). Needs gymnasium and
    ale-py with the ROMs, imported only here."""
    try:
        import gymnasium as gym

        env = gym.make(task, frameskip=1)
    except Exception as e:  # gymnasium, ale-py or the ROM namespace is missing
        raise ImportError(f"Atari env {task!r} unavailable (install ale-py and the ROMs): {e}") from e
    return wrap_deepmind(env, **kwargs)
