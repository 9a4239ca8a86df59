"""Device collector (port of ``tianshou_tpu/data/collector.py``; reference
``Collector._collect``, data/collector.py:773-1067).

The JAX package runs a rollout as one jitted ``lax.scan``. Here it is a
Python loop over :meth:`DeviceCollector._step_fn` on the envs' device:
policy forward, env step, buffer insert, episode bookkeeping and auto-reset
stay on the device, and nothing is read back until
:meth:`DeviceCollector.stats_from`. :meth:`DeviceCollector.rollout` writes
the :class:`CollectState` in place and the per-step output into ``[T, E]``
tensors it allocates once per call, so that the trainer can capture a whole
chunk as one CUDA graph (the counterpart of the jitted scan) and replay it.
The host side of a collect (the ``collector`` trace line and
``on_episode_done_hook``) is :meth:`DeviceCollector.report`:
:meth:`DeviceCollector.collect` is ``rollout`` then ``report``, and the
trainer calls ``report`` after each replay, since a graph replays only the
device work.

:meth:`DeviceCollector.collect_episodes` collects exactly ``n`` finished
episodes (the test phase) in chunks of :meth:`DeviceCollector.episode_chunk`,
each of which writes an :class:`EpisodeState` in place, so that the trainer
can capture a chunk as a CUDA graph too.

Episode semantics match the reference:
- transitions store the raw policy action (pre ``map_action``), the true
  terminal ``obs_next`` (pre-reset), terminated/truncated separately;
- per-env episode return/length accumulators emit on done
  (reference collector.py:554-578);
- auto-reset replaces the carried obs with a fresh reset obs.

The policy state (``CollectState.policy_state``: a recurrent carry, gSDE's
noise) is carried from step to step and written in place like the rest of
the state. Where an episode ends, the algorithm's ``reset_policy_state`` is
selected in (reference collector.py:1103), in :meth:`DeviceCollector.rollout`
and :meth:`DeviceCollector.episode_chunk` alike; at the start of every
:meth:`DeviceCollector.rollout`, ``refresh_policy_state`` replaces it (the JAX
package's ``_build_collect``, ``tianshou_tpu/data/collector.py:170-178``;
its episode collection refreshes nothing). Both draw from the collect's
generator only where the algorithm's hook does.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.algorithm.base import ActOut
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.wrappers import inject_rms
from tianshou_tpu_torch.utils.determinism import TraceLogger
from tianshou_tpu_torch.utils.tree import tree_map

__all__ = ["CollectState", "CollectStats", "DeviceCollector", "EpisodeState", "deactivate_surplus"]


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

    @property
    def returns_stat(self):
        r = self.returns
        return None if len(r) == 0 else {"mean": float(r.mean()), "std": float(r.std()), "max": float(r.max()),
                                         "min": float(r.min())}

    @property
    def lens_stat(self):
        n = self.lens
        return None if len(n) == 0 else {"mean": float(n.mean()), "std": float(n.std())}


class EpisodeState(NamedTuple):
    """What :meth:`DeviceCollector.episode_chunk` writes in place."""

    cstate: CollectState
    active: torch.Tensor    # [E] bool: envs whose finished episodes still count
    n_done: torch.Tensor    # 0-d int64: episodes counted so far
    n_target: torch.Tensor  # 0-d int64: episodes wanted


def deactivate_surplus(done: torch.Tensor, active: torch.Tensor, n_done: torch.Tensor,
                       n_target: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's surplus-env removal (collector.py:1049-1067) for one
    step, as ``tianshou_tpu/data/collector.py:253-259`` writes it: the
    episodes that count are those that finish in active envs; then the first
    ``max(active.sum() - remaining, 0)`` of those envs in env-id order are
    deactivated, so that the active count never exceeds the episodes still
    needed. Returns ``(counted done, active, n_done)``."""
    done = done & active
    n_done = n_done + done.sum()
    remaining = (n_target - n_done).clamp(min=0)
    k_deact = (active.sum() - remaining).clamp(min=0)
    rank = torch.cumsum(done.to(torch.int64), dim=0)
    return done, active & ~(done & (rank <= k_deact)), n_done


class DeviceCollector:
    """Collects rollouts from a :class:`VectorDeviceEnv` into ``buffer``
    (which may be ``None`` when the rollout is consumed directly).

    Hooks (reference StepHook collector.py:1412 / EpisodeRolloutHook :1468):
    ``on_step_hook(transition Batch) -> Batch`` transforms every transition
    inside the step, on the device, before it is stored (a captured program
    runs it on every replay); ``on_episode_done_hook(stats)`` runs on the host
    after each collect (:meth:`report`) with the finished episodes' returns
    and lengths.
    """

    def __init__(self, venv: VectorDeviceEnv, algo, buffer=None,
                 on_step_hook: Callable[[Batch], Batch] | None = None,
                 on_episode_done_hook: Callable[[CollectStats], None] | None = None) -> None:
        self.venv = venv
        self.algo = algo
        self.buffer = buffer
        self.on_step_hook = on_step_hook
        self.on_episode_done_hook = on_episode_done_hook
        self._episodes: EpisodeState | None = None  # collect_episodes' state, reset in place by each call

    @property
    def device(self) -> torch.device:
        """The device of the envs and the collector's state."""
        return self.venv.device

    # ------------------------------------------------------------------
    def reset(self, generator: torch.Generator, into: CollectState | None = None) -> CollectState:
        """A fresh state, every leaf its own tensor (an env may hand back one
        tensor as both a state leaf and the observation, and :meth:`collect`
        writes each leaf in place). With ``into``, the fresh values are
        written into its tensors and ``into`` is returned."""
        env_state, obs = tree_map(torch.clone, self.venv.reset(generator))
        E, dev = self.venv.num_envs, self.venv.device
        fresh = CollectState(
            env_state, obs, self.algo.init_policy_state(E, dev),
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
        if self.on_step_hook is not None:
            transition = self.on_step_hook(transition)
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

        policy_state = out.state
        if policy_state is not None:  # the carry restarts where an episode ended
            reset_ps = self.algo.reset_policy_state(E, generator, self.venv.device)
            policy_state = tree_map(sel, reset_ps, policy_state)
        new_cstate = CollectState(
            env_state=tree_map(sel, reset_state, step.state),
            obs=tree_map(sel, reset_obs, step.obs),
            policy_state=policy_state,
            ep_rew=torch.where(done, 0.0, ep_rew),
            ep_len=torch.where(done, 0, ep_len),
        )
        per_step = Batch(done=done, ep_ret=emit_ret, ep_len=emit_len)
        if keep_rollout:
            per_step.rollout = transition
        return new_cstate, buf_state, per_step

    # ------------------------------------------------------------------
    def rollout(
        self,
        ts,
        cstate: CollectState,
        buf_state,
        generator: torch.Generator,
        n_steps: int,
        training: bool = True,
        keep_rollout: bool = False,
        random: bool = False,
    ) -> Batch:
        """The device work of :meth:`collect` (what the trainer's programs
        capture): ``n_steps`` steps per env, ``cstate`` and ``buf_state``
        written in place, the policy state first refreshed
        (``refresh_policy_state``). Returns the ``[T, E]`` per-step output."""
        store = self.buffer is not None
        if cstate.policy_state is not None:
            fresh = self.algo.refresh_policy_state(cstate.policy_state, self.venv.num_envs, generator)
            if fresh is not cstate.policy_state:
                tree_map(torch.Tensor.copy_, cstate.policy_state, fresh)
        out = None
        for t in range(n_steps):
            new, buf_state, per = self._step_fn(ts, cstate, buf_state, generator, training,
                                                store, keep_rollout, random)
            if out is None:
                out = tree_map(lambda v: v.new_empty((n_steps, *v.shape)), per)
            tree_map(lambda dst, v: dst[t].copy_(v), out, per)
            tree_map(torch.Tensor.copy_, cstate, new)
        return out

    def report(self, out: Batch, n_steps: int, training: bool) -> None:
        """The host side of a collect, after its device work: the
        ``collector`` trace line and ``on_episode_done_hook``
        (``tianshou_tpu/data/collector.py:210-219``). Reads ``out`` back only
        when tracing is on or a hook is set."""
        TraceLogger.log(
            "collector",
            lambda: (
                f"n_steps={n_steps} training={training} "
                f"episodes={int(out.done.sum())} "
                f"ep_ret_sum={float(out.ep_ret.double().sum()):.6f}"
            ),
        )
        if self.on_episode_done_hook is not None:
            self.on_episode_done_hook(self.stats_from(out))

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
        in place, then :meth:`report`. Returns ``(cstate, buf_state, out)``
        (the same state objects) where ``out.done/ep_ret/ep_len`` are
        ``[T, E]`` device tensors and ``out.rollout`` (if requested) is the
        time-major transition Batch. ``random=True`` samples uniform actions
        (warmup prefill)."""
        out = self.rollout(ts, cstate, buf_state, generator, n_steps, training, keep_rollout, random)
        self.report(out, n_steps, training)
        return cstate, buf_state, out

    # ------------------------------------------------------------------
    def stats_from(self, out: Batch, max_episodes: int | None = None) -> CollectStats:
        """Summarize a :meth:`collect` output on the host; with ``max_episodes``
        only the first that many finished episodes, in step order."""
        done = out.done.cpu().numpy()
        rets, lens = out.ep_ret.cpu().numpy()[done], out.ep_len.cpu().numpy()[done]
        if max_episodes is not None:
            rets, lens = rets[:max_episodes], lens[:max_episodes]
        return CollectStats(
            n_collected_steps=int(done.size),
            n_collected_episodes=int(done.sum() if max_episodes is None else len(rets)),
            returns=rets,
            lens=lens,
        )

    # ------------------------------------------------------------------
    def reset_episodes(self, generator: torch.Generator, n_episodes: int,
                       into: EpisodeState | None = None) -> EpisodeState:
        """A fresh :class:`EpisodeState` for ``n_episodes`` episodes: a reset
        collect state, the first ``max(min(n, E), 1)`` envs active, nothing
        counted. With ``into``, written into its tensors."""
        E, dev = self.venv.num_envs, self.venv.device
        cstate = self.reset(generator, into=None if into is None else into.cstate)
        active = torch.arange(E, device=dev) < max(min(n_episodes, E), 1)
        n_done = torch.zeros((), dtype=torch.int64, device=dev)
        n_target = torch.full((), n_episodes, dtype=torch.int64, device=dev)
        if into is None:
            return EpisodeState(cstate, active, n_done, n_target)
        into.active.copy_(active)
        into.n_done.copy_(n_done)
        into.n_target.copy_(n_target)
        return into

    @torch.no_grad()
    def episode_chunk(self, ts, state: EpisodeState, generator: torch.Generator, chunk_steps: int,
                      training: bool = False) -> Batch:
        """``chunk_steps`` steps of every env without storing, counting the
        episodes that finish in active envs and deactivating surplus envs
        (:func:`deactivate_surplus`), ``state`` written in place (the JAX
        package's jitted chunk, ``tianshou_tpu/data/collector.py:238-267``).
        Returns the ``[T, E]`` output: ``done`` (counted episodes only),
        ``ep_ret`` and ``ep_len``."""
        E = self.venv.num_envs
        out = Batch(
            done=torch.empty((chunk_steps, E), dtype=torch.bool, device=self.venv.device),
            ep_ret=torch.empty((chunk_steps, E), dtype=torch.float32, device=self.venv.device),
            ep_len=torch.empty((chunk_steps, E), dtype=torch.int64, device=self.venv.device),
        )
        for t in range(chunk_steps):
            new, _, per = self._step_fn(ts, state.cstate, None, generator, training, store=False, keep_rollout=False)
            done, active, n_done = deactivate_surplus(per.done, state.active, state.n_done, state.n_target)
            out.done[t].copy_(done)
            out.ep_ret[t].copy_(per.ep_ret)
            out.ep_len[t].copy_(per.ep_len)
            state.active.copy_(active)
            state.n_done.copy_(n_done)
            tree_map(torch.Tensor.copy_, state.cstate, new)
        return out

    def collect_episodes(
        self,
        ts,
        generator: torch.Generator,
        n_episodes: int,
        chunk_steps: int = 128,
        training: bool = False,
        max_chunks: int = 100,
        rms=None,
        chunk_fn: Callable[..., Batch] | None = None,
    ) -> CollectStats:
        """Collect exactly ``n_episodes`` finished episodes (the test phase),
        from a fresh reset, as the reference's test collector does.

        Chunks of ``chunk_steps`` steps run on the device with the surplus-env
        masking inside; the host reads the episode count once per chunk (the
        static-shape answer to the reference's data-dependent n_episode loop,
        collector.py:1049-1067) and reduces each chunk's output to numpy
        before the next chunk overwrites it. Episodes are kept in completion
        order (time-major, then env id) and cut to ``n_episodes``;
        ``n_collected_steps`` counts every env of every chunk, inactive ones
        too. ``chunk_fn(ts, state, generator, chunk_steps, training)`` runs
        one chunk; it defaults to :meth:`episode_chunk`, and the trainer
        passes its CUDA-graph program of it. The state is this collector's,
        reset in place by every call. ``rms``: pooled observation statistics
        (:func:`tianshou_tpu_torch.env.wrappers.extract_pooled_rms`) written
        into every test env's ``NormObs`` state after the reset.
        """
        state = self._episodes = self.reset_episodes(generator, n_episodes, into=self._episodes)
        if rms is not None:
            # the test envs evaluate under the train envs' pooled observation statistics
            # (the reference shares one obs_rms, venv_wrappers.py:99), written into the state in place
            env_state = state.cstate.env_state
            tree_map(torch.Tensor.copy_, env_state, inject_rms(self.venv.env, env_state, rms))
        run = self.episode_chunk if chunk_fn is None else chunk_fn
        all_rets: list[np.ndarray] = []
        all_lens: list[np.ndarray] = []
        steps = 0
        n_done = 0
        for _ in range(max_chunks):
            out = run(ts, state, generator, chunk_steps, training)
            done = out.done.cpu().numpy()
            all_rets.append(out.ep_ret.cpu().numpy()[done])
            all_lens.append(out.ep_len.cpu().numpy()[done])
            steps += int(done.size)
            n_done = int(state.n_done)
            if n_done >= n_episodes:
                break
        else:
            warnings.warn(
                f"collect_episodes hit max_chunks={max_chunks} with only "
                f"{n_done}/{n_episodes} episodes finished; returning partial results",
                stacklevel=2,
            )
        rets = np.concatenate(all_rets)[:n_episodes]
        lens = np.concatenate(all_lens)[:n_episodes]
        return CollectStats(n_collected_steps=steps, n_collected_episodes=len(rets), returns=rets, lens=lens)
