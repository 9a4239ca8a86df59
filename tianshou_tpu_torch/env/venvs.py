"""Host vector environments for Gymnasium-style envs (port of
``tianshou_tpu/env/venvs.py``; reference ``tianshou/env/venvs.py:25-473``,
``env/worker/*``).

``DummyVectorEnv`` steps its envs one after another in this process;
``SubprocVectorEnv`` runs one process per env over a pipe
(reference subproc.py:77-140); both take the async partial-wait API
(``wait_num`` / ``timeout``, venvs.py:288-310) and tag every step's info
with ``env_id``. :class:`VectorEnvNormObs` normalizes observations with one
shared :class:`tianshou_tpu_torch.utils.statistics.RunningMeanStd`.

This is the path of envs that are not batched device code (Atari, Box2D,
Gymnasium MuJoCo): the envs are numpy on the host, and
:class:`tianshou_tpu_torch.data.host_collector.HostCollector` moves each
step's observations to the device once.

Worker processes are forked (the JAX package's context, ``venvs.py:160``),
so an env factory is inherited and never pickled: a lambda or a closure
serves. A forked worker only runs its env's numpy code; it never touches
CUDA, which a fork after CUDA's initialization would not survive, nor
torch's thread pools. ``recv_timeout`` bounds each wait for a worker's
reply (``TimeoutError``), so that a hung worker fails its caller instead of
stalling it; ``close`` never waits longer than that either.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import time
from collections.abc import Callable
from multiprocessing import connection
from typing import Any

import numpy as np

from tianshou_tpu_torch.utils.statistics import RunningMeanStd

__all__ = ["BaseVectorEnv", "DummyEnvWorker", "DummyVectorEnv", "EnvWorker", "SubprocEnvWorker", "SubprocVectorEnv",
           "VectorEnvNormObs"]

#: seconds ``close`` waits for a worker's goodbye before it terminates the process
CLOSE_WAIT_S = 5.0


class EnvWorker:
    """send/recv decoupled worker protocol (reference worker_base.py:11)."""

    def __init__(self, env_fn: Callable) -> None:
        self._env_fn = env_fn
        self.is_closed = False
        self.result: Any = None

    def send(self, action: Any, **kwargs: Any) -> None:
        raise NotImplementedError

    def recv(self) -> Any:
        return self.result

    def reset(self, **kwargs: Any) -> tuple:
        self.send(None, **kwargs)
        return self.recv()

    def step(self, action: Any) -> tuple:
        self.send(action)
        return self.recv()

    def get_env_attr(self, key: str) -> Any:
        raise NotImplementedError

    def set_env_attr(self, key: str, value: Any) -> None:
        raise NotImplementedError

    def seed(self, seed: int | None = None) -> Any:
        return None

    def render(self, **kwargs: Any) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        self.is_closed = True

    @staticmethod
    def wait(workers: list[EnvWorker], wait_num: int, timeout: float | None = None) -> list[EnvWorker]:
        raise NotImplementedError


class DummyEnvWorker(EnvWorker):
    """In-process worker (reference env/worker/dummy.py)."""

    def __init__(self, env_fn: Callable) -> None:
        super().__init__(env_fn)
        self.env = env_fn()

    def send(self, action: Any, **kwargs: Any) -> None:
        if action is None:
            self.result = self.env.reset(**kwargs)
        else:
            self.result = self.env.step(action)

    def get_env_attr(self, key: str) -> Any:
        return getattr(self.env, key)

    def set_env_attr(self, key: str, value: Any) -> None:
        setattr(self.env.unwrapped, key, value)

    def seed(self, seed: int | None = None) -> Any:
        try:
            return self.env.reset(seed=seed)
        except TypeError:
            return None

    def render(self, **kwargs: Any) -> Any:
        return self.env.render(**kwargs)

    def close(self) -> None:
        if not self.is_closed:
            self.env.close()
            self.is_closed = True

    @staticmethod
    def wait(workers, wait_num, timeout=None):
        return workers[:wait_num]


def _subproc_worker(parent, pipe, env_fn: Callable) -> None:
    parent.close()
    env = env_fn()
    try:
        while True:
            try:
                cmd, data = pipe.recv()
            except EOFError:
                pipe.close()
                break
            if cmd == "step":
                pipe.send(env.step(data))
            elif cmd == "reset":
                pipe.send(env.reset(**data))
            elif cmd == "close":
                pipe.send(env.close())
                pipe.close()
                break
            elif cmd == "render":
                pipe.send(env.render(**data) if hasattr(env, "render") else None)
            elif cmd == "getattr":
                pipe.send(getattr(env, data, None))
            elif cmd == "setattr":
                setattr(env.unwrapped, data["key"], data["value"])
            else:
                pipe.close()
                raise NotImplementedError(cmd)
    except KeyboardInterrupt:
        pipe.close()


def _start(target: Callable, env_fn: Callable):
    """A forked daemon process running ``target(parent, child, env_fn)``;
    returns (its process, the parent's end of the pipe)."""
    ctx = mp.get_context("fork")
    parent_remote, child_remote = ctx.Pipe()
    process = ctx.Process(target=target, args=(parent_remote, child_remote, env_fn), daemon=True)
    process.start()
    child_remote.close()
    return process, parent_remote


class SubprocEnvWorker(EnvWorker):
    """One OS process per env over a pipe (reference subproc.py:143)."""

    def __init__(self, env_fn: Callable, recv_timeout: float | None = None) -> None:
        super().__init__(env_fn)
        self.recv_timeout = recv_timeout
        self.process, self.parent_remote = _start(_subproc_worker, env_fn)

    def _recv_raw(self) -> Any:
        if self.recv_timeout is not None and not self.parent_remote.poll(self.recv_timeout):
            raise TimeoutError(f"env worker {self.process.pid} sent nothing for {self.recv_timeout} s")
        return self.parent_remote.recv()

    def send(self, action: Any, **kwargs: Any) -> None:
        if action is None:
            self.parent_remote.send(("reset", kwargs))
        else:
            self.parent_remote.send(("step", action))

    def recv(self) -> Any:
        return self._recv_raw()

    def get_env_attr(self, key: str) -> Any:
        self.parent_remote.send(("getattr", key))
        return self._recv_raw()

    def set_env_attr(self, key: str, value: Any) -> None:
        self.parent_remote.send(("setattr", {"key": key, "value": value}))

    def render(self, **kwargs: Any) -> Any:
        self.parent_remote.send(("render", kwargs))
        return self._recv_raw()

    def close(self) -> None:
        if not self.is_closed:
            wait = CLOSE_WAIT_S if self.recv_timeout is None else min(CLOSE_WAIT_S, self.recv_timeout)
            try:
                self.parent_remote.send(("close", None))
                if self.parent_remote.poll(wait):
                    self.parent_remote.recv()
                self.process.join(timeout=wait)
            except (BrokenPipeError, EOFError, ConnectionResetError):
                pass
            finally:
                self.process.terminate()
                self.process.join(timeout=wait)
                self.parent_remote.close()
                self.is_closed = True

    @staticmethod
    def wait(workers, wait_num, timeout=None):
        remain = list(workers)
        ready: list[EnvWorker] = []
        t0 = time.time()
        while len(ready) < wait_num:
            budget = None if timeout is None else max(timeout - (time.time() - t0), 0)
            conns = connection.wait([w.parent_remote for w in remain], timeout=budget)
            new = [w for w in remain if w.parent_remote in conns]
            ready.extend(new)
            remain = [w for w in remain if w not in new]
            if timeout is not None and time.time() - t0 > timeout:
                break
        return ready


def _stack_obs(obs_list: list) -> Any:
    """Stacked observations; dict observations stay a list of dicts."""
    return np.stack(obs_list) if not isinstance(obs_list[0], dict) else obs_list


class BaseVectorEnv:
    """Synchronous and async stepping over a worker pool (reference venvs.py:25)."""

    def __init__(
        self,
        env_fns: list[Callable],
        worker_fn: Callable[[Callable], EnvWorker],
        wait_num: int | None = None,
        timeout: float | None = None,
    ) -> None:
        self.workers = [worker_fn(fn) for fn in env_fns]
        self.env_num = len(env_fns)
        self.wait_num = wait_num or len(env_fns)
        self.timeout = timeout
        self.is_async = self.wait_num != len(env_fns) or timeout is not None
        self.waiting_conn: list[EnvWorker] = []
        self.waiting_id: list[int] = []
        self.ready_id = list(range(self.env_num))
        self.is_closed = False

    def __len__(self) -> int:
        return self.env_num

    def _wrap_id(self, id: int | list[int] | np.ndarray | None) -> list[int]:
        if id is None:
            return list(range(self.env_num))
        return [id] if np.isscalar(id) else list(id)

    def get_env_attr(self, key: str, id=None) -> list:
        return [self.workers[i].get_env_attr(key) for i in self._wrap_id(id)]

    def set_env_attr(self, key: str, value: Any, id=None) -> None:
        for i in self._wrap_id(id):
            self.workers[i].set_env_attr(key, value)

    @property
    def observation_space(self):
        return self.get_env_attr("observation_space", 0)[0]

    @property
    def action_space(self):
        return self.get_env_attr("action_space", 0)[0]

    def reset(self, id=None, **kwargs):
        """Reset the envs ``id`` (all by default); a scalar ``seed`` is spread
        as ``seed + i`` over the i-th env reset (reference venvs.py:324-328)."""
        ids = self._wrap_id(id)
        seed = kwargs.get("seed")
        for i in ids:
            kw = kwargs if seed is None or not np.isscalar(seed) else {**kwargs, "seed": int(seed) + i}
            self.workers[i].send(None, **kw)
        results = [self.workers[i].recv() for i in ids]
        return _stack_obs([r[0] for r in results]), np.array([r[1] for r in results], dtype=object)

    def step(self, action: np.ndarray, id=None):
        ids = self._wrap_id(id)
        if not self.is_async:
            if len(action) != len(ids):
                raise ValueError(f"{len(action)} actions for {len(ids)} envs")
            for i, j in enumerate(ids):
                self.workers[j].send(action[i])
            results = []
            for j in ids:
                obs, rew, term, trunc, info = self.workers[j].recv()
                info["env_id"] = j
                results.append((obs, rew, term, trunc, info))
        else:
            if action is not None:
                for act, env_id in zip(action, ids):
                    self.workers[env_id].send(act)
                    self.waiting_conn.append(self.workers[env_id])
                    self.waiting_id.append(env_id)
                self.ready_id = [x for x in self.ready_id if x not in ids]
            ready_workers: list[EnvWorker] = []
            while not ready_workers:
                ready_workers = type(self.workers[0]).wait(self.waiting_conn, self.wait_num, self.timeout)
            results = []
            for w in ready_workers:
                idx = self.waiting_conn.index(w)
                self.waiting_conn.pop(idx)
                env_id = self.waiting_id.pop(idx)
                obs, rew, term, trunc, info = w.recv()
                info["env_id"] = env_id
                results.append((obs, rew, term, trunc, info))
                self.ready_id.append(env_id)
        return (
            _stack_obs([r[0] for r in results]),
            np.array([r[1] for r in results], np.float32),
            np.array([r[2] for r in results], bool),
            np.array([r[3] for r in results], bool),
            np.array([r[4] for r in results], dtype=object),
        )

    def seed(self, seed: int | list[int] | None = None) -> None:
        """Seed every env; a scalar is spread as ``[seed, seed + 1, ...]``
        (reference venvs.py:324-328)."""
        if seed is None:
            seeds: list[int | None] = [None] * self.env_num
        elif np.isscalar(seed):
            seeds = [int(seed) + i for i in range(self.env_num)]
        else:
            seeds = list(seed)
        for w, s in zip(self.workers, seeds):
            w.seed(s)

    def render(self, **kwargs) -> list:
        return [w.render(**kwargs) for w in self.workers]

    def close(self) -> None:
        for w in self.workers:
            w.close()
        self.is_closed = True


class DummyVectorEnv(BaseVectorEnv):
    """Sequential in-process loop (reference venvs.py:365)."""

    def __init__(self, env_fns, **kwargs) -> None:
        super().__init__(env_fns, DummyEnvWorker, **kwargs)


class SubprocVectorEnv(BaseVectorEnv):
    """One subprocess per env (reference venvs.py:389); ``recv_timeout``
    bounds each wait for a worker (None: no bound)."""

    def __init__(self, env_fns, recv_timeout: float | None = None, **kwargs) -> None:
        super().__init__(env_fns, functools.partial(SubprocEnvWorker, recv_timeout=recv_timeout), **kwargs)


class VectorEnvNormObs:
    """Host venv wrapper that normalizes observations with ONE shared
    :class:`RunningMeanStd` (reference venv_wrappers.py:69): updated on every
    train reset and step, frozen for test envs with ``update_obs_rms=False``
    and ``set_obs_rms(train_venv.get_obs_rms())``."""

    def __init__(self, venv, update_obs_rms: bool = True) -> None:
        self.venv = venv
        self.update_obs_rms = update_obs_rms
        self.obs_rms = RunningMeanStd()

    def __len__(self) -> int:
        return len(self.venv)

    def __getattr__(self, key):
        return getattr(self.venv, key)

    def get_obs_rms(self) -> RunningMeanStd:
        return self.obs_rms

    def set_obs_rms(self, obs_rms: RunningMeanStd) -> None:
        self.obs_rms = obs_rms

    def _norm(self, obs):
        if isinstance(obs, np.ndarray) and obs.dtype != object:
            if self.update_obs_rms:
                self.obs_rms.update(obs)
            return self.obs_rms.norm(obs).astype(np.float32)
        return obs

    def reset(self, id=None, **kwargs):
        obs, info = self.venv.reset(id=id, **kwargs)
        return self._norm(obs), info

    def step(self, action, id=None):
        obs, rew, term, trunc, info = self.venv.step(action, id=id)
        return self._norm(obs), rew, term, trunc, info
