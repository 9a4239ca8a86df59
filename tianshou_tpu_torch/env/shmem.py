"""Shared-memory env workers: observations bypass the pipe (port of
``tianshou_tpu/env/shmem.py``; reference ``ShmemVectorEnv`` / ``ShArray``,
env/venvs.py:427-446, env/worker/subproc.py:18-74).

Each worker process writes its observation into a
``multiprocessing.shared_memory`` block and sends only the scalars through
the pipe, so that large (image) observations are not pickled. Workers are
forked as :mod:`tianshou_tpu_torch.env.venvs`' are, and ``recv_timeout``
bounds each wait for a worker in the same way.
"""

from __future__ import annotations

import functools
from multiprocessing import resource_tracker, shared_memory

import numpy as np

from tianshou_tpu_torch.env.venvs import CLOSE_WAIT_S, BaseVectorEnv, EnvWorker, SubprocEnvWorker, _start

__all__ = ["ShmemEnvWorker", "ShmemVectorEnv"]


def _shmem_worker(parent, pipe, env_fn) -> None:
    parent.close()
    env = env_fn()
    shm = None
    buf = None

    def put_obs(obs) -> None:
        nonlocal shm, buf
        obs = np.asarray(obs)
        if shm is None:
            shm = shared_memory.SharedMemory(create=True, size=max(obs.nbytes, 1))
            buf = np.ndarray(obs.shape, obs.dtype, buffer=shm.buf)
            pipe.send(("spec", (shm.name, obs.shape, str(obs.dtype))))
        buf[...] = obs

    try:
        while True:
            try:
                cmd, data = pipe.recv()
            except EOFError:
                break
            if cmd == "step":
                obs, rew, term, trunc, info = env.step(data)
                put_obs(obs)
                pipe.send(("step", (rew, term, trunc, info)))
            elif cmd == "reset":
                obs, info = env.reset(**data)
                put_obs(obs)
                pipe.send(("reset", (info,)))
            elif cmd == "getattr":
                pipe.send(("attr", getattr(env, data, None)))
            elif cmd == "close":
                pipe.send(("closed", None))
                break
    finally:
        if shm is not None:
            del buf
            shm.close()
            shm.unlink()
        pipe.close()


class ShmemEnvWorker(EnvWorker):
    def __init__(self, env_fn, recv_timeout: float | None = None) -> None:
        super().__init__(env_fn)
        self.recv_timeout = recv_timeout
        self.process, self.parent_remote = _start(_shmem_worker, env_fn)
        self._shm = None
        self._view: np.ndarray | None = None

    def _attach(self, name: str, shape, dtype) -> None:
        self._shm = shared_memory.SharedMemory(name=name)
        # the worker created the block and unlinks it; attaching registered it with the resource tracker
        # a second time, which would report it leaked at exit
        resource_tracker.unregister(self._shm._name, "shared_memory")
        self._view = np.ndarray(shape, np.dtype(dtype), buffer=self._shm.buf)

    def _recv_tagged(self):
        tag, payload = SubprocEnvWorker._recv_raw(self)
        if tag == "spec":
            self._attach(*payload)
            return self._recv_tagged()
        return tag, payload

    def send(self, action, **kwargs) -> None:
        if action is None:
            self.parent_remote.send(("reset", kwargs))
        else:
            self.parent_remote.send(("step", action))

    def recv(self):
        tag, payload = self._recv_tagged()
        obs = self._view.copy()
        if tag == "reset":
            return obs, payload[0]
        rew, term, trunc, info = payload
        return obs, rew, term, trunc, info

    def get_env_attr(self, key: str):
        self.parent_remote.send(("getattr", key))
        return self._recv_tagged()[1]

    def set_env_attr(self, key, value) -> None:
        raise NotImplementedError

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
                self._view = None
                if self._shm is not None:
                    self._shm.close()
                self.process.terminate()
                self.process.join(timeout=wait)
                self.parent_remote.close()
                self.is_closed = True

    wait = staticmethod(SubprocEnvWorker.wait)


class ShmemVectorEnv(BaseVectorEnv):
    """Vector env over shared-memory workers (reference venvs.py:427)."""

    def __init__(self, env_fns, recv_timeout: float | None = None, **kwargs) -> None:
        super().__init__(env_fns, functools.partial(ShmemEnvWorker, recv_timeout=recv_timeout), **kwargs)
