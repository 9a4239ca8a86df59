"""Async host collector: steps only the envs that are ready (port of
``tianshou_tpu/data/async_collector.py``; reference ``AsyncCollector``,
data/collector.py:1119-1397).

It keeps the observations and episode counters of all E envs, steps the
ready subset through a ``wait_num`` / ``timeout`` vector env, recovers
which envs answered from ``info["env_id"]`` (:1299) and inserts their
transitions by global env id, so a slow env never blocks the fast ones. The
forward runs on the device over the ready envs; their actions are
remembered per env, since a result may come back many calls later
(:1152). Both ``n_step`` and ``n_episode`` stop once at least that many
steps or episodes arrived: the async mode over-delivers instead of masking
surplus envs (:1203).
"""

from __future__ import annotations

import numpy as np
import torch

from tianshou_tpu_torch.data.collector import CollectStats
from tianshou_tpu_torch.data.host_collector import HostCollector, obs_to_device

__all__ = ["AsyncHostCollector"]


class AsyncHostCollector(HostCollector):
    def __init__(self, venv, algo, buffer=None, device: str | torch.device | None = None) -> None:
        if not venv.is_async:
            raise ValueError("AsyncHostCollector needs a venv with wait_num or timeout")
        super().__init__(venv, algo, buffer, device=device)
        self._last_act: torch.Tensor | None = None

    def reset(self, seed: int | None = None) -> None:
        super().reset(seed)
        self._last_act = None

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
        if (n_step is None) == (n_episode is None):
            raise ValueError("give exactly one of n_step and n_episode")
        if reset_before_collect or self._obs is None:
            self.reset()
        E = len(self.venv)
        dev = self.device
        if self._ep_rew is None:
            self._ep_rew = np.zeros(E)
        step_count = 0
        ep_returns: list[float] = []
        ep_lens: list[int] = []
        ready = np.asarray(self.venv.ready_id)

        while (n_step is not None and step_count < n_step) or (n_episode is not None and len(ep_returns) < n_episode):
            ready_dev = torch.as_tensor(ready).to(dev)
            raw, acts = self._act(ts, self._obs_dev[ready_dev], len(ready), generator, training, random)
            if self._last_act is None:
                self._last_act = raw.new_zeros((E,) + tuple(raw.shape[1:]))
            self._last_act[ready_dev] = raw
            obs_next, rew, term, trunc, infos = self.venv.step(acts, id=ready.tolist())
            ids = np.array([i["env_id"] for i in infos])
            ids_dev = torch.as_tensor(ids).to(dev)
            obs_next = np.asarray(obs_next)
            obs_next_dev = obs_to_device(obs_next, dev)
            if self.buffer is not None:
                # the answering envs' rows in a full-width transition; the mask keeps the others' rings
                mask = np.zeros(E, bool)
                mask[ids] = True
                transition = self._transition(self._obs_dev, self._last_act[ids_dev], rew, term, trunc,
                                              obs_next_dev, ids)
                self.buf_state, _ = self.buffer.add(self.buf_state, transition, torch.as_tensor(mask).to(dev))
            done = np.logical_or(term, trunc)
            self._ep_rew[ids] += rew
            self._ep_len[ids] += 1
            step_count += len(ids)
            if done.any():
                done_pos = np.where(done)[0]
                self._finish_episodes(ids[done], ep_returns, ep_lens)
                obs_next, obs_next_dev = self._after_reset(obs_next, obs_next_dev, done_pos, ids[done])
            self._obs = np.asarray(self._obs)
            self._obs[ids] = obs_next
            self._obs_dev[ids_dev] = obs_next_dev
            ready = ids
        return self._stats(step_count, ep_returns, ep_lens)
