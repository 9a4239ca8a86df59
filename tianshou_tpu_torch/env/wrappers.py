"""Device env wrappers (port of ``tianshou_tpu/env/wrappers.py``):
``ContinuousToDiscrete``, ``MultiDiscreteToDiscrete`` and
``TruncatedAsTerminated`` (reference env/gym_wrappers.py:8, :37, :61),
``FrameStack``, and ``NormObs`` with its pooled statistics (``merge_rms``,
``extract_pooled_rms``, ``inject_rms``). Like the JAX wrappers, the first
three pass ``carry_through_reset`` on to nothing: they keep no state and
their inner env's persistent sub-state is not carried through them.

``NormObs`` keeps a running mean and variance per env (``[E, obs]``, counts
``[E]``) in the env state, as the JAX package's vmapped single-env statistics
are; the collector writes that state in place, so a captured collect chunk
updates them on every replay. ``inject_rms`` returns a new state, as in JAX;
:meth:`tianshou_tpu_torch.data.collector.DeviceCollector.collect_episodes`
copies it into its episode state."""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.env.core import Box, Discrete, Env, MultiDiscrete

__all__ = ["ContinuousToDiscrete", "FrameStack", "FrameStackState", "MultiDiscreteToDiscrete", "NormObs", "NormObsState",
           "RMSState", "TruncatedAsTerminated", "extract_pooled_rms", "inject_rms", "merge_rms"]


def _linspace(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """``[k, n]``: ``n`` points from ``lo`` to ``hi`` per row, as ``jnp.linspace``
    writes them in float32: ``lo * (1 - s) + hi * s`` with ``s = i / (n - 1)``,
    the last point ``hi`` exactly. XLA may fuse or reassociate these products,
    so a point can differ from the JAX package's by up to 2 ulp of the larger
    bound's magnitude."""
    if n == 1:
        return lo[:, None]
    s = torch.arange(n - 1, dtype=torch.float32) / torch.tensor(float(n - 1))
    return torch.cat([lo[:, None] * (1 - s) + hi[:, None] * s, hi[:, None]], dim=1)


class ContinuousToDiscrete(Env):
    """Each dim of a Box action as ``action_per_dim`` bins (reference
    gym_wrappers.py:8): the action space becomes ``MultiDiscrete`` and a
    sub-action ``i`` maps to the i-th of the dim's evenly spaced points from
    its low to its high bound. ``_mesh`` (``[k, action_per_dim]``) lives on
    the CPU and is copied to a device once."""

    def __init__(self, env: Env, action_per_dim: int) -> None:
        if not isinstance(env.action_space, Box):
            raise TypeError(f"ContinuousToDiscrete needs a Box action space, got {env.action_space}")
        self.env = env
        self.observation_space = env.observation_space
        self.max_episode_steps = env.max_episode_steps
        k = math.prod(env.action_space.shape)
        self.action_per_dim = action_per_dim
        self.action_space = MultiDiscrete([action_per_dim] * k)
        lo, hi = (torch.tensor(b, dtype=torch.float32) for b in (env.action_space.low, env.action_space.high))
        self._mesh = _linspace(lo, hi, action_per_dim)
        self._on_device: dict[torch.device, torch.Tensor] = {}

    def mesh(self, device: torch.device) -> torch.Tensor:
        if device not in self._on_device:
            self._on_device[device] = self._mesh.to(device)
        return self._on_device[device]

    def reset(self, num_envs, generator, device):
        return self.env.reset(num_envs, generator, device)

    def step(self, state, action, generator):
        mesh = self.mesh(action.device)
        cont = mesh[torch.arange(mesh.shape[0], device=action.device), action.reshape(action.shape[0], -1)]
        return self.env.step(state, cont.reshape(action.shape[0], *self.env.action_space.shape), generator)


class MultiDiscreteToDiscrete(Env):
    """``MultiDiscrete([n1 .. nk])`` flattened into ``Discrete(n1 * .. * nk)``,
    the first sub-action the most significant digit (reference gym_wrappers.py:37)."""

    def __init__(self, env: Env) -> None:
        if not isinstance(env.action_space, MultiDiscrete):
            raise TypeError(f"MultiDiscreteToDiscrete needs a MultiDiscrete action space, got {env.action_space}")
        self.env = env
        self.observation_space = env.observation_space
        self.max_episode_steps = env.max_episode_steps
        nvec = np.asarray(env.action_space.nvec)
        bases = np.concatenate([np.cumprod(nvec[::-1])[::-1][1:], [1]])
        self._digits = torch.tensor(np.stack([bases, nvec]), dtype=torch.int64)  # [2, k]: place values, radices
        self._on_device: dict[torch.device, torch.Tensor] = {}
        self.action_space = Discrete(int(np.prod(nvec)))

    def reset(self, num_envs, generator, device):
        return self.env.reset(num_envs, generator, device)

    def step(self, state, action, generator):
        if action.device not in self._on_device:
            self._on_device[action.device] = self._digits.to(action.device)
        bases, nvec = self._on_device[action.device]
        multi = torch.div(action.to(torch.int64)[:, None], bases, rounding_mode="floor") % nvec
        return self.env.step(state, multi, generator)


class TruncatedAsTerminated(Env):
    """Truncation reported as termination (reference gym_wrappers.py:61)."""

    def __init__(self, env: Env) -> None:
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.max_episode_steps = env.max_episode_steps

    def reset(self, num_envs, generator, device):
        return self.env.reset(num_envs, generator, device)

    def step(self, state, action, generator):
        s = self.env.step(state, action, generator)
        return s._replace(terminated=s.terminated | s.truncated, truncated=torch.zeros_like(s.truncated))


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



class RMSState(NamedTuple):
    mean: torch.Tensor   # [E, *obs] (pooled: [*obs])
    var: torch.Tensor    # [E, *obs] (pooled: [*obs])
    count: torch.Tensor  # [E] float32 (pooled: 0-d)


class NormObsState(NamedTuple):
    inner: Any
    rms: RMSState


def _per_env(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` of shape ``[E]`` broadcast against ``like`` of shape ``[E, ...]``."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


class NormObs(Env):
    """Observation normalization with a running mean and variance per env,
    carried in the env state (reference ``RunningMeanStd``,
    utils/statistics.py:69, updated one observation at a time). Set
    ``update_stats=False`` for test envs and hand them the train envs' pooled
    statistics (reference venv_wrappers.py:99; :func:`inject_rms`)."""

    def __init__(self, env: Env, clip: float = 10.0, update_stats: bool = True) -> None:
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.max_episode_steps = env.max_episode_steps
        self.clip = clip
        self.update_stats = update_stats

    def _norm(self, rms: RMSState, obs: torch.Tensor) -> torch.Tensor:
        return ((obs - rms.mean) / torch.sqrt(rms.var + 1e-8)).clamp(-self.clip, self.clip)

    @staticmethod
    def _update(rms: RMSState, obs: torch.Tensor) -> RMSState:
        """One Welford step per env with that env's observation."""
        delta = obs - rms.mean
        count = rms.count + 1.0
        new_mean = rms.mean + delta / _per_env(count, obs)
        m_a = rms.var * _per_env(rms.count, obs)
        new_var = (m_a + delta * (obs - new_mean)) / _per_env(count, obs)
        return RMSState(new_mean, new_var, count)

    def reset(self, num_envs, generator, device):
        s, obs = self.env.reset(num_envs, generator, device)
        rms = RMSState(torch.zeros_like(obs), torch.ones_like(obs),
                       torch.full((num_envs,), 1e-4, dtype=torch.float32, device=obs.device))
        if self.update_stats:
            rms = self._update(rms, obs)
        return NormObsState(s, rms), self._norm(rms, obs)

    def step(self, state: NormObsState, action, generator):
        s = self.env.step(state.inner, action, generator)
        rms = self._update(state.rms, s.obs) if self.update_stats else state.rms
        return s._replace(state=NormObsState(s.state, rms), obs=self._norm(rms, s.obs))

    def carry_through_reset(self, old_state: NormObsState, reset_state: NormObsState) -> NormObsState:
        # the statistics persist across episode boundaries
        return NormObsState(reset_state.inner, old_state.rms)


def merge_rms(rms: RMSState) -> RMSState:
    """Pool per-env statistics (leading env axis) into one: means weighted
    by count, and the variance within envs plus the variance of their means
    (the law of total variance). The reference updates one shared
    ``RunningMeanStd`` from every env's observations (venv_wrappers.py:99)."""
    counts = rms.count
    total = counts.sum()
    w = (counts / total)[:, None]
    mean_e = rms.mean.reshape(counts.shape[0], -1)
    mean = (w * mean_e).sum(0)
    var_within = (w * rms.var.reshape(counts.shape[0], -1)).sum(0)
    d = mean_e - mean[None]
    var_between = (w * d * d).sum(0)
    return RMSState(mean.reshape(rms.mean.shape[1:]), (var_within + var_between).reshape(rms.var.shape[1:]), total)


def _norm_obs_depth(env: Env) -> int | None:
    """How many wrappers sit above the ``NormObs`` of ``env``'s chain (None: none in it)."""
    depth = 0
    while not isinstance(env, NormObs):
        if not hasattr(env, "env"):
            return None
        env, depth = env.env, depth + 1
    return depth


def extract_pooled_rms(env: Env, env_state: Any) -> RMSState | None:
    """The pooled statistics of the ``NormObs`` in ``env``'s wrapper chain,
    from a batched env state; None without one."""
    depth = _norm_obs_depth(env)
    if depth is None:
        return None
    state = env_state
    for _ in range(depth):
        state = state.inner if hasattr(state, "inner") else state[0]
    assert isinstance(state, NormObsState), type(state)
    return merge_rms(state.rms)


def inject_rms(env: Env, env_state: Any, rms: RMSState) -> Any:
    """``env_state`` with the pooled ``rms`` broadcast into every env slot
    of its ``NormObs`` (the reference's frozen shared ``obs_rms`` handed to
    the test envs); unchanged without a ``NormObs``."""
    if _norm_obs_depth(env) is None:
        return env_state

    def walk(state: Any) -> Any:
        if isinstance(state, NormObsState):
            E = state.rms.count.shape[0]
            return NormObsState(state.inner, RMSState(rms.mean.expand(E, *rms.mean.shape),
                                                      rms.var.expand(E, *rms.var.shape), rms.count.expand(E)))
        if hasattr(state, "inner"):
            return state._replace(inner=walk(state.inner))
        return state

    return walk(env_state)
