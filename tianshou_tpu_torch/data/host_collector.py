"""Host collector: the rollout engine for host (Gymnasium-style) vector envs
(port of ``tianshou_tpu/data/host_collector.py``; reference ``Collector``,
data/collector.py:302-1067).

The reference's semantics: ``n_step`` XOR ``n_episode`` collection,
exploration noise, raw (pre ``map_action``) actions stored, per-env episode
returns and lengths, surplus envs deactivated in ``n_episode`` mode
(collector.py:1049), ``CollectStats`` out, ``random=True`` for uniform
actions from the envs' action space (``RandomActionPolicy``,
algorithm_base.py:1063), and a buffer whose ring count must equal the env
count (collector.py:371).

The envs are numpy on the host; everything else is on ``device``. Per step
the observations cross host to device once (the new observations; the
fresh observations of envs that just reset cross for those envs only) and
the actions device to host once, the one synchronisation of a step. The
collector keeps the current observations on the device, so the policy's
forward over the whole env batch and the buffer's insert read them there,
and the insert writes the rings in place (the JAX package jits it with a
donated state, ``host_collector.py:96-102``). ``step_hook(n)``, when set,
is called after each training step of ``n`` env steps: the host trainer's
``overlap_updates`` mode launches gradient steps from it.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algorithm.base import TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.collector import CollectStats
from tianshou_tpu_torch.utils.determinism import TraceLogger
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["HostCollector", "obs_to_device", "write_rows"]


def obs_to_device(obs: Any, device: torch.device) -> Any:
    """Host observations (a numpy array, or a ``Batch`` of them) as tensors on ``device``."""
    if isinstance(obs, Batch):
        return obs.map(lambda x: torch.as_tensor(np.asarray(x)).to(device))
    return torch.as_tensor(np.ascontiguousarray(obs)).to(device)


def write_rows(dst: Any, idx: torch.Tensor, src: Any) -> None:
    """``dst[idx] = src`` in place, leaf by leaf for a ``Batch``."""
    if isinstance(dst, Batch):
        for k, v in dst.items():
            write_rows(v, idx, src[k])
    else:
        dst[idx] = src.to(dst.dtype)


def _clone(x: Any) -> Any:
    return x.map(torch.clone) if isinstance(x, Batch) else x.clone()


class HostCollector:
    def __init__(self, venv, algo, buffer=None, return_reduction: Callable | None = None,
                 device: str | torch.device | None = None) -> None:
        if buffer is not None and getattr(buffer, "num_envs", len(venv)) != len(venv):
            raise ValueError(f"buffer.num_envs={buffer.num_envs} must equal the vector env count {len(venv)} "
                             f"(use VectorReplayBuffer(total, {len(venv)}))")
        self.venv = venv
        self.algo = algo
        self.buffer = buffer
        self.device = resolve_device(device)
        self.buf_state = None
        self._obs: Any = None       # host observations of every env
        self._obs_dev: Any = None   # the same on the device
        self._ep_rew: np.ndarray | None = None
        self._ep_len = np.zeros(len(venv), np.int64)
        #: called as ``step_hook(n_env_steps)`` after each training step (the host trainer's overlap mode)
        self.step_hook: Callable[[int], None] | None = None
        # vector (multi-agent) episode returns -> a scalar (reference trainer.py:81)
        self.return_reduction = return_reduction if return_reduction is not None else (
            lambda r: r if np.ndim(r) == 0 else r[0])

    # ------------------------------------------------------------------
    @staticmethod
    def _to_obs(raw) -> Any:
        """list-of-dict observations (multi-agent, dict spaces) -> a stacked ``Batch``."""
        if isinstance(raw, list) and raw and isinstance(raw[0], dict):
            return Batch(raw)
        return np.asarray(raw)

    def reset(self, seed: int | None = None) -> None:
        """Reset every env (``seed`` spread as ``seed + i``) and the episode counters."""
        obs, _ = self.venv.reset(seed=seed) if seed is not None else self.venv.reset()
        self._obs = self._to_obs(obs)
        self._obs_dev = obs_to_device(self._obs, self.device)
        self._ep_rew = None  # shaped on the first reward (a vector for MARL)
        self._ep_len = np.zeros(len(self.venv), np.int64)

    def reset_buffer(self, example: Batch) -> None:
        if self.buffer is None:
            raise ValueError("this collector has no buffer")
        self.buf_state = self.buffer.init(example, device=self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _forward(self, ts: TrainState, obs: Any, generator: torch.Generator, training: bool):
        """(raw action, env action) on the device for ``obs``."""
        out = self.algo.forward(ts, obs, generator, deterministic=not training)
        act = self.algo.exploration_noise(ts, out.act, obs, generator, training=training)
        return act, self.algo.map_action(act)

    def _act(self, ts, obs_dev: Any, n: int, generator: torch.Generator, training: bool, random: bool):
        """(raw actions on the device, env actions as numpy) for ``n`` envs."""
        if random:
            space = self.venv.action_space
            acts = np.stack([np.asarray(space.sample()) for _ in range(n)])
            raw = self.algo.map_action_inverse(torch.as_tensor(acts).to(self.device))
            return raw, acts
        raw, mapped = self._forward(ts, obs_dev, generator, training)
        return raw, mapped.cpu().numpy()  # the step's one device-to-host copy

    def _transition(self, obs_dev: Any, raw: torch.Tensor, rew: np.ndarray, term: np.ndarray, trunc: np.ndarray,
                    obs_next_dev: Any, ids: np.ndarray | None) -> Batch:
        """One full-width transition on the device; with ``ids`` (the active
        envs) the given rows are scattered into it and the other rows are
        whatever the current state holds (the buffer's mask drops them)."""
        dev = self.device
        if ids is None:
            return Batch(obs=obs_dev, act=raw, rew=torch.as_tensor(rew).to(dev), terminated=torch.as_tensor(term).to(dev),
                         truncated=torch.as_tensor(trunc).to(dev), obs_next=obs_next_dev)
        E = len(self.venv)

        def scatter(v: np.ndarray) -> torch.Tensor:
            full = np.zeros((E,) + v.shape[1:], v.dtype)
            full[ids] = v
            return torch.as_tensor(full).to(dev)

        ids_dev = torch.as_tensor(ids).to(dev)
        act = raw.new_zeros((E,) + tuple(raw.shape[1:]))
        act[ids_dev] = raw
        obs_next = _clone(obs_dev)
        write_rows(obs_next, ids_dev, obs_next_dev)
        return Batch(obs=obs_dev, act=act, rew=scatter(np.asarray(rew, np.float32)), terminated=scatter(term),
                     truncated=scatter(trunc), obs_next=obs_next)

    def _finish_episodes(self, done_ids: np.ndarray, ep_returns: list, ep_lens: list) -> None:
        for i in done_ids:
            ep_returns.append(float(self.return_reduction(self._ep_rew[i])))
            ep_lens.append(int(self._ep_len[i]))
            self._ep_rew[i] = 0.0
            self._ep_len[i] = 0

    def _after_reset(self, obs_next: Any, obs_next_dev: Any, done_pos: np.ndarray, done_ids: np.ndarray):
        """The observations to act on next: ``obs_next`` with the rows of the
        envs that finished replaced by their reset observations, on the host
        and (a copy, so that the stored ``obs_next`` stays the true terminal
        one) on the device."""
        reset_obs, _ = self.venv.reset(id=done_ids.tolist())
        reset_obs = self._to_obs(reset_obs)
        obs_next[done_pos.tolist() if isinstance(obs_next, Batch) else done_pos] = reset_obs
        obs_next_dev = _clone(obs_next_dev)
        write_rows(obs_next_dev, torch.as_tensor(done_pos).to(self.device), obs_to_device(reset_obs, self.device))
        return obs_next, obs_next_dev

    # ------------------------------------------------------------------
    def collect(
        self,
        ts,
        generator: torch.Generator,
        n_step: int | None = None,
        n_episode: int | None = None,
        random: bool = False,
        training: bool = True,
        reset_before_collect: bool = False,
    ) -> CollectStats:
        """At least ``n_step`` env steps, or exactly ``n_episode`` finished
        episodes, into the buffer (if any); ``generator`` (on the collector's
        device) draws the policy's randomness."""
        if (n_step is None) == (n_episode is None):
            raise ValueError("give exactly one of n_step and n_episode")
        if reset_before_collect or self._obs is None:
            self.reset()
        E = len(self.venv)
        step_count = 0
        ep_returns: list[float] = []
        ep_lens: list[int] = []
        active = np.ones(E, bool)
        if n_episode is not None:  # surplus-env masking (reference collector.py:1049)
            active = np.arange(E) < max(min(n_episode, E), 1)

        while True:
            # only active envs step: stepping a deactivated env without storing would leave a gap in its
            # ring that corrupts prev/next walks (frame stacks, n-step chains) in later collects
            ids = np.where(active)[0]
            all_active = len(ids) == E
            ids_dev = None if all_active else torch.as_tensor(ids).to(self.device)
            obs_act = self._obs_dev if all_active else self._obs_dev[ids_dev]
            raw, acts = self._act(ts, obs_act, len(ids), generator, training, random)
            obs_next, rew, term, trunc, _ = self.venv.step(acts) if all_active else self.venv.step(acts, id=ids.tolist())
            obs_next = self._to_obs(obs_next)
            obs_next_dev = obs_to_device(obs_next, self.device)  # the step's one host-to-device copy of observations
            rew, term, trunc = np.asarray(rew), np.asarray(term), np.asarray(trunc)
            done = np.logical_or(term, trunc)
            if self._ep_rew is None:
                self._ep_rew = np.zeros((E,) + rew.shape[1:])
            if self.buffer is not None:
                transition = self._transition(self._obs_dev, raw, rew, term, trunc, obs_next_dev,
                                              None if all_active else ids)
                mask = None if all_active else torch.as_tensor(active).to(self.device)
                self.buf_state, _ = self.buffer.add(self.buf_state, transition, mask)
            self._ep_rew[ids] += rew
            self._ep_len[ids] += 1
            step_count += len(ids)
            if self.step_hook is not None and training and not random:
                self.step_hook(len(ids))
            if done.any():
                done_pos = np.where(done)[0]
                done_ids = ids[done]
                self._finish_episodes(done_ids, ep_returns, ep_lens)
                obs_next, obs_next_dev = self._after_reset(obs_next, obs_next_dev, done_pos, done_ids)
                if n_episode is not None:  # deactivate surplus envs once enough episodes are running
                    remaining = n_episode - len(ep_returns)
                    n_active = int(active.sum())
                    for i in done_ids:
                        if n_active > remaining:
                            active[i] = False
                            n_active -= 1
            if all_active:
                self._obs, self._obs_dev = obs_next, obs_next_dev
            else:
                self._obs[ids.tolist() if isinstance(self._obs, Batch) else ids] = obs_next
                write_rows(self._obs_dev, ids_dev, obs_next_dev)
            if n_step is not None and step_count >= n_step:
                break
            if n_episode is not None and len(ep_returns) >= n_episode:
                break

        return self._stats(step_count, ep_returns, ep_lens)

    def _stats(self, step_count: int, ep_returns: list, ep_lens: list) -> CollectStats:
        TraceLogger.log("host_collector", lambda: f"steps={step_count} episodes={len(ep_returns)} "
                                                  f"ret_sum={float(np.sum(ep_returns)):.6f}")
        return CollectStats(n_collected_steps=step_count, n_collected_episodes=len(ep_returns),
                            returns=np.asarray(ep_returns), lens=np.asarray(ep_lens))

    # ------------------------------------------------------------------
    def collect_rollout(self, ts, generator: torch.Generator, n_step_per_env: int,
                        training: bool = True) -> tuple[Batch, CollectStats]:
        """A time-major rollout ``[T, E, ...]`` on the device for on-policy
        updates (the device collector's ``keep_rollout=True``): raw actions,
        the true pre-reset ``obs_next``, the episode bookkeeping of
        :meth:`collect`."""
        if self._obs is None:
            self.reset()
        E = len(self.venv)
        steps: list[Batch] = []
        ep_returns: list[float] = []
        ep_lens: list[int] = []
        for _ in range(n_step_per_env):
            raw, acts = self._act(ts, self._obs_dev, E, generator, training, False)
            obs_next, rew, term, trunc, _ = self.venv.step(acts)
            obs_next = self._to_obs(obs_next)
            obs_next_dev = obs_to_device(obs_next, self.device)
            rew = np.asarray(rew, np.float32)
            done = np.logical_or(term, trunc)
            steps.append(self._transition(self._obs_dev, raw, rew, np.asarray(term), np.asarray(trunc),
                                          obs_next_dev, None))
            if self._ep_rew is None:
                self._ep_rew = np.zeros(rew.shape)
            self._ep_rew += rew
            self._ep_len += 1
            if done.any():
                ids = np.where(done)[0]
                self._finish_episodes(ids, ep_returns, ep_lens)
                obs_next, obs_next_dev = self._after_reset(obs_next, obs_next_dev, ids, ids)
            self._obs, self._obs_dev = obs_next, obs_next_dev
        stats = CollectStats(n_collected_steps=n_step_per_env * E, n_collected_episodes=len(ep_returns),
                             returns=np.asarray(ep_returns), lens=np.asarray(ep_lens))
        return Batch.stack(steps, axis=0), stats
