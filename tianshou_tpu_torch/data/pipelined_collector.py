"""Pipelined host collector: the device's policy forward overlapped with the
host's env steps (port of ``tianshou_tpu/data/pipelined_collector.py``).

:class:`HostCollector` runs each step in turn: forward on the device, then
``env.step`` on the host. Here the envs are split into two halves half a
step out of phase: while half A's workers step, the device computes half B's
actions, and the insert of the transitions of the half last received is
still queued on the device (CUDA launches return at once). Semantics are
:meth:`HostCollector.collect`'s in ``n_step`` mode: the same transitions,
raw actions, per-env episode bookkeeping and ``CollectStats``.

Where it synchronises: each half's actions are copied to the host before
they are sent to its workers (``.cpu()``). That copy waits for everything
queued before it on the device's stream, the previous half's insert and any
gradient steps the trainer's ``step_hook`` launched, as XLA's in-order
execution on one device makes the JAX version wait. Nothing else in the
loop reads the device.

``n_episode`` and random collection, fewer than two envs, and any venv that
is not a plain ``DummyVectorEnv`` or ``SubprocVectorEnv`` (a wrapper such as
``VectorEnvNormObs`` would be bypassed, since the pipeline drives the
workers itself) take :meth:`HostCollector.collect`.
"""

from __future__ import annotations

import numpy as np
import torch

from tianshou_tpu_torch.data.collector import CollectStats
from tianshou_tpu_torch.data.host_collector import HostCollector, obs_to_device, write_rows
from tianshou_tpu_torch.env.venvs import DummyVectorEnv, SubprocVectorEnv

__all__ = ["PipelinedHostCollector"]


class PipelinedHostCollector(HostCollector):
    def _send_group(self, ids: np.ndarray, acts: np.ndarray) -> None:
        for k, i in enumerate(ids):
            self.venv.workers[i].send(acts[k])

    def _recv_group(self, ids: np.ndarray):
        obs, rew, term, trunc = [], [], [], []
        for i in ids:
            o, r, te, tr, _ = self.venv.workers[i].recv()
            obs.append(o)
            rew.append(r)
            term.append(te)
            trunc.append(tr)
        return np.stack(obs), np.asarray(rew, np.float32), np.asarray(term, bool), np.asarray(trunc, bool)

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
        E = len(self.venv)
        if (n_step is None or random or E < 2 or type(self.venv) not in (DummyVectorEnv, SubprocVectorEnv)):
            return super().collect(ts, generator, n_step=n_step, n_episode=n_episode, random=random,
                                   training=training, reset_before_collect=reset_before_collect)
        if reset_before_collect or self._obs is None:
            self.reset()
        dev = self.device
        groups = [np.arange(E // 2), np.arange(E // 2, E)]
        groups_dev = [torch.as_tensor(g).to(dev) for g in groups]
        obs = np.asarray(self._obs)
        obs_dev = self._obs_dev
        if self._ep_rew is None:
            self._ep_rew = np.zeros(E)
        step_count = 0
        ep_returns: list[float] = []
        ep_lens: list[int] = []

        def launch(g: int) -> torch.Tensor:
            """The group's forward on the device, its actions sent to its workers."""
            raw, mapped = self._forward(ts, obs_dev[groups_dev[g]], generator, training)
            self._send_group(groups[g], mapped.cpu().numpy())
            return raw

        def absorb(g: int, raw: torch.Tensor) -> None:
            """Receive the group's results, insert them, keep the books."""
            nonlocal step_count
            ids, ids_dev = groups[g], groups_dev[g]
            o_next, rew, term, trunc = self._recv_group(ids)
            o_next_dev = obs_to_device(o_next, dev)
            if self.buffer is not None:
                # the group's rows in a full-width transition; the mask keeps the other group's rings as they are
                mask = np.zeros(E, bool)
                mask[ids] = True
                transition = self._transition(obs_dev, raw, rew, term, trunc, o_next_dev, ids)
                self.buf_state, _ = self.buffer.add(self.buf_state, transition, torch.as_tensor(mask).to(dev))
            done = term | trunc
            self._ep_rew[ids] += rew
            self._ep_len[ids] += 1
            step_count += len(ids)
            if done.any():
                done_pos = np.where(done)[0]
                self._finish_episodes(ids[done], ep_returns, ep_lens)
                o_next, o_next_dev = self._after_reset(o_next, o_next_dev, done_pos, ids[done])
            obs[ids] = o_next
            write_rows(obs_dev, ids_dev, o_next_dev)

        # prologue: launch group 0; steady state: LAUNCH the idle group (forward and send) BEFORE absorbing the
        # oldest group in flight, so that both halves step at once while the device works; the step hook fires
        # right after a send, when both halves are stepping
        raws = {0: launch(0)}
        in_flight = [0]
        next_g = 1
        while in_flight:
            launched = step_count + sum(len(groups[g]) for g in in_flight)
            if launched < n_step:
                raws[next_g] = launch(next_g)
                in_flight.append(next_g)
                if self.step_hook is not None and training:
                    self.step_hook(len(groups[next_g]))
                next_g = 1 - next_g
            g = in_flight.pop(0)
            absorb(g, raws[g])
        self._obs, self._obs_dev = obs, obs_dev
        return self._stats(step_count, ep_returns, ep_lens)
