"""Finite (exhaustible) vector envs (port of ``tianshou_tpu/env/finite.py``):
the host path's adapter for envs backed by a finite data stream, such as a
sharded offline dataset replayed through the collector (reference
test/base/test_env_finite.py:77-198).

Contract: the underlying env's ``reset()`` returns ``(None, {})`` when its
stream is exhausted. :class:`FiniteVectorEnv` tracks which envs are still
alive, substitutes a cached default observation for exhausted ones (so the
stacked obs keeps a static shape for the policy), and raises
``StopIteration`` from ``reset`` once every env is exhausted — exactly the
reference's termination-accounting semantics for finite per-worker streams.
"""

from __future__ import annotations

import copy
import functools
from typing import Any

import numpy as np

from tianshou_tpu_torch.env.venvs import BaseVectorEnv, DummyEnvWorker, SubprocEnvWorker

__all__ = ["FiniteVectorEnv", "FiniteDummyVectorEnv", "FiniteSubprocVectorEnv"]


class FiniteVectorEnv(BaseVectorEnv):
    """Vector env over finite data-stream envs (reference
    test_env_finite.py:77 ``FiniteVectorEnv``)."""

    def __init__(self, env_fns, worker_fn, **kwargs) -> None:
        super().__init__(env_fns, worker_fn, **kwargs)
        self._alive_env_ids: set[int] = set()
        self._reset_alive_envs()
        self._default_obs: np.ndarray | None = None
        self._default_info: dict | None = None
        self.tracker: Any = None  # host-side metric hook (set by tests/users)

    def _reset_alive_envs(self) -> None:
        if not self._alive_env_ids:
            self._alive_env_ids = set(range(self.env_num))

    def _set_default_obs(self, obs) -> None:
        if obs is not None and self._default_obs is None:
            self._default_obs = copy.deepcopy(obs)

    def _set_default_info(self, info) -> None:
        if info is not None and self._default_info is None:
            self._default_info = copy.deepcopy(info)

    def reset(self, id=None, **kwargs):
        ids = self._wrap_id(id)
        self._reset_alive_envs()

        request = [i for i in ids if i in self._alive_env_ids]
        obs_list: list = [None] * len(ids)
        infos: list = [None] * len(ids)
        id2idx = {i: k for k, i in enumerate(ids)}
        if request:
            # per-env reset through the worker pool (cannot go through
            # super().reset: it stacks obs, and a dead env returns None)
            seed = kwargs.get("seed")
            for k, i in enumerate(request):
                kw = kwargs if seed is None or not np.isscalar(seed) else {**kwargs, "seed": int(seed) + k}
                self.workers[i].send(None, **kw)
            for i in request:
                o, info = self.workers[i].recv()
                obs_list[id2idx[i]] = o
                infos[id2idx[i]] = info
        for i in ids:
            if obs_list[id2idx[i]] is None and i in self._alive_env_ids:
                self._alive_env_ids.discard(i)

        for o in obs_list:
            self._set_default_obs(o)
        for k in range(len(obs_list)):
            if obs_list[k] is None:
                obs_list[k] = copy.deepcopy(self._default_obs)
            if infos[k] is None:
                infos[k] = copy.deepcopy(self._default_info) or {}

        if not self._alive_env_ids:
            # every stream exhausted: rearm for the next epoch, then signal
            self.reset()
            raise StopIteration

        obs = np.stack(obs_list) if not isinstance(obs_list[0], dict) else obs_list
        return obs, np.array(infos, dtype=object)

    def step(self, action, id=None):
        ids = self._wrap_id(id)
        id2idx = {i: k for k, i in enumerate(ids)}
        request = [i for i in ids if i in self._alive_env_ids]
        result: list[list] = [[None, 0.0, False, False, None] for _ in ids]

        if request:
            valid_act = np.stack([action[id2idx[i]] for i in request])
            out = super().step(valid_act, request)
            for i, (o, r, te, tr, inf) in zip(request, zip(*out)):
                result[id2idx[i]] = [o, r, te, tr, inf]

        if self.tracker is not None:
            for i, r in zip(ids, result):
                if i in self._alive_env_ids:
                    self.tracker.log(*r)

        for _, __, ___, ____, inf in result:
            self._set_default_info(inf)
        for k in range(len(result)):
            if result[k][0] is None:
                result[k][0] = copy.deepcopy(self._default_obs)
            if result[k][-1] is None:
                result[k][-1] = copy.deepcopy(self._default_info) or {}

        obs_list = [r[0] for r in result]
        obs = np.stack(obs_list) if not isinstance(obs_list[0], dict) else obs_list
        rew = np.array([r[1] for r in result], np.float32)
        term = np.array([r[2] for r in result], bool)
        trunc = np.array([r[3] for r in result], bool)
        info = np.array([r[4] for r in result], dtype=object)
        return obs, rew, term, trunc, info


class FiniteDummyVectorEnv(FiniteVectorEnv):
    def __init__(self, env_fns, **kwargs) -> None:
        super().__init__(env_fns, DummyEnvWorker, **kwargs)


class FiniteSubprocVectorEnv(FiniteVectorEnv):
    def __init__(self, env_fns, recv_timeout: float | None = None, **kwargs) -> None:
        super().__init__(env_fns, functools.partial(SubprocEnvWorker, recv_timeout=recv_timeout), **kwargs)
