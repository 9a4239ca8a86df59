"""Device collector (port of ``tianshou_tpu/data/collector.py``; reference
``Collector._collect``, data/collector.py:773-1067).

The JAX package runs a rollout as one jitted ``lax.scan``. Here it is a
Python loop over :meth:`DeviceCollector._step_fn` on the envs' device:
policy forward, env step, buffer insert, episode bookkeeping and auto-reset
stay on the device, and nothing is read back until
:meth:`DeviceCollector.stats_from`. :meth:`DeviceCollector.collect` writes
the :class:`CollectState` in place and the per-step output into ``[T, E]``
tensors it allocates once per call, so that the trainer can capture a whole
chunk as one CUDA graph (the counterpart of the jitted scan) and replay it.

Episode semantics match the reference:
- transitions store the raw policy action (pre ``map_action``), the true
  terminal ``obs_next`` (pre-reset), terminated/truncated separately;
- per-env episode return/length accumulators emit on done
  (reference collector.py:554-578);
- auto-reset replaces the carried obs with a fresh reset obs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.algorithm.base import ActOut
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.utils.tree import tree_map

__all__ = ["CollectState", "CollectStats", "DeviceCollector"]


class CollectState(NamedTuple):
    env_state: Any
    obs: Any
    policy_state: Any      # recurrent carry (None for stateless policies)
    ep_rew: torch.Tensor   # [E] running episode return
    ep_len: torch.Tensor   # [E] running episode length


@dataclasses.dataclass
class CollectStats:
    """Host-side summary, mirroring reference CollectStats (collector.py:117)."""

    n_collected_steps: int
    n_collected_episodes: int
    returns: np.ndarray
    lens: np.ndarray


class DeviceCollector:
    """Collects rollouts from a :class:`VectorDeviceEnv` into ``buffer``
    (which may be ``None`` when the rollout is consumed directly)."""

    def __init__(self, venv: VectorDeviceEnv, algo, buffer=None) -> None:
        self.venv = venv
        self.algo = algo
        self.buffer = buffer

    # ------------------------------------------------------------------
    def reset(self, generator: torch.Generator, into: CollectState | None = None) -> CollectState:
        """A fresh state, every leaf its own tensor (an env may hand back one
        tensor as both a state leaf and the observation, and :meth:`collect`
        writes each leaf in place). With ``into``, the fresh values are
        written into its tensors and ``into`` is returned."""
        env_state, obs = tree_map(torch.clone, self.venv.reset(generator))
        E, dev = self.venv.num_envs, self.venv.device
        fresh = CollectState(
            env_state, obs, self.algo.init_policy_state(E),
            torch.zeros(E, dtype=torch.float32, device=dev),
            torch.zeros(E, dtype=torch.int64, device=dev),
        )
        if into is None:
            return fresh
        tree_map(torch.Tensor.copy_, into, fresh)
        return into

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _step_fn(self, ts, cstate: CollectState, buf_state, generator: torch.Generator,
                 training: bool, store: bool, keep_rollout: bool, random: bool = False):
        """One env step of every env. Returns ``(cstate, buf_state, per_step)``;
        ``buf_state`` is written in place when ``store``."""
        E = self.venv.num_envs
        if random:
            # uniform action-space sampling for warmup prefill (reference
            # RandomActionPolicy / start_timesteps, collector.py:724)
            env_act = self.venv.action_space.sample(E, generator, self.venv.device)
            act = self.algo.map_action_inverse(env_act)
            out = ActOut(act=act, state=cstate.policy_state, info=Batch())
        else:
            out = self.algo.forward(ts, cstate.obs, generator, state=cstate.policy_state,
                                    deterministic=not training)
            # applied in both modes: eps-greedy uses eps_inference at eval time
            act = self.algo.exploration_noise(ts, out.act, cstate.obs, generator, training=training)
            env_act = self.algo.map_action(act)
        step = self.venv.step(cstate.env_state, env_act, generator)
        done = step.terminated | step.truncated
        transition = Batch(
            obs=cstate.obs,
            act=act,
            rew=step.reward,
            terminated=step.terminated,
            truncated=step.truncated,
            obs_next=step.obs,
        )
        if store and self.buffer is not None:
            buf_state, _ = self.buffer.add(buf_state, transition)
        ep_rew = cstate.ep_rew + step.reward
        ep_len = cstate.ep_len + 1
        emit_ret = torch.where(done, ep_rew, 0.0)
        emit_len = torch.where(done, ep_len, 0)
        # auto-reset finished envs
        reset_state, reset_obs = self.venv.reset(generator)
        reset_state = self.venv.carry_through_reset(step.state, reset_state)

        def sel(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
            return torch.where(done.reshape(done.shape + (1,) * (new.dim() - done.dim())), new, old)

        new_cstate = CollectState(
            env_state=tree_map(sel, reset_state, step.state),
            obs=tree_map(sel, reset_obs, step.obs),
            policy_state=out.state,  # recurrent carries (reset on done) are not ported yet
            ep_rew=torch.where(done, 0.0, ep_rew),
            ep_len=torch.where(done, 0, ep_len),
        )
        per_step = Batch(done=done, ep_ret=emit_ret, ep_len=emit_len)
        if keep_rollout:
            per_step.rollout = transition
        return new_cstate, buf_state, per_step

    # ------------------------------------------------------------------
    def collect(
        self,
        ts,
        cstate: CollectState,
        buf_state,
        generator: torch.Generator,
        n_steps: int,
        training: bool = True,
        keep_rollout: bool = False,
        random: bool = False,
    ):
        """Collect ``n_steps`` per env, writing ``cstate`` and ``buf_state``
        in place. Returns ``(cstate, buf_state, out)`` (the same state
        objects) where ``out.done/ep_ret/ep_len`` are ``[T, E]`` device
        tensors and ``out.rollout`` (if requested) is the time-major
        transition Batch. ``random=True`` samples uniform actions (warmup
        prefill)."""
        store = self.buffer is not None
        out = None
        for t in range(n_steps):
            new, buf_state, per = self._step_fn(ts, cstate, buf_state, generator, training,
                                                store, keep_rollout, random)
            if out is None:
                out = tree_map(lambda v: v.new_empty((n_steps, *v.shape)), per)
            tree_map(lambda dst, v: dst[t].copy_(v), out, per)
            tree_map(torch.Tensor.copy_, cstate, new)
        return cstate, buf_state, out

    # ------------------------------------------------------------------
    def stats_from(self, out: Batch) -> CollectStats:
        """Summarize a :meth:`collect` output on the host."""
        done = out.done.cpu().numpy()
        return CollectStats(
            n_collected_steps=int(done.size),
            n_collected_episodes=int(done.sum()),
            returns=out.ep_ret.cpu().numpy()[done],
            lens=out.ep_len.cpu().numpy()[done],
        )
