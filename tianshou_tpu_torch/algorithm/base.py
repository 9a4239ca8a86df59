"""Algorithm/Policy base abstractions (port of ``tianshou_tpu/algorithm/base.py``;
reference ``tianshou/algorithm/algorithm_base.py``).

The JAX package keeps all mutable state in a ``TrainState`` pytree and makes
every method a pure function of it. Here :class:`TrainState` holds the live
objects (online module, target module, optimizer, step counter, dynamic
hyper-parameters) and :meth:`Algorithm.update_step` updates them in place,
returning the same state. The step counter and the hyper-parameters are 0-d
tensors on the model's device, as the JAX package keeps them in its pytree:
a CUDA graph captured over an update reads them where they live, where a
host number would be captured as a constant.

- ``Algorithm.forward(ts, obs, generator)``        <- Policy.forward
- ``Algorithm.init(device) -> TrainState``         <- nn.Module + optimizer ctor
- ``Algorithm.preprocess / update_step``           <- _preprocess_batch / _update_with_batch
- ``Algorithm.update``                             <- Algorithm._update (:586)
- ``Algorithm.map_action``                         <- Policy.map_action (:254): clip or tanh, then scaling
- :func:`polyak_update`                            <- polyak_update (:54), ``optax.incremental_update``
- :class:`Snapshot`: what an update writes, copied aside and selected back on
  the device (TD3's and REDQ's delayed actor steps, PPO's KL guard)

An update draws its random numbers (sampled rows, target and actor noise)
from the generator it is given. A :class:`Draws` in the generator's place
hands the numbers over instead, so that tests can give both packages JAX's
draws: the JAX update splits its key into k1 (the sample), k2 (preprocess)
and k3 (the gradient step), and the test computes each draw from its key.
A draw of one number per batch row goes through :func:`uniform`,
:func:`standard_normal` or :func:`randint`, which inside a mesh step draw the
global batch's numbers and keep this rank's rows (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable
from typing import Any, NamedTuple

import numpy as np
import torch
from torch import nn

from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Discrete, MultiDiscrete, Space
from tianshou_tpu_torch.ops.returns import nstep_returns, value_mask
from tianshou_tpu_torch.utils.data_parallel import active_data_parallel

__all__ = ["ActOut", "Algorithm", "Draws", "OfflineAlgorithm", "OffPolicyAlgorithm", "OnPolicyAlgorithm", "Snapshot",
           "TrainState", "optimizer_tensors", "polyak_update", "randint", "standard_normal", "sync_target",
           "uniform", "weighted_mean"]


@dataclasses.dataclass
class TrainState:
    """All mutable algorithm state. ``step`` counts gradient steps; it and
    every value of ``hparams`` are 0-d tensors on the model's device, written
    in place (the trainer's ``gradient_step`` is the host's mirror of ``step``)."""

    #: online network; actor-critic: a ModuleDict of ``actor``, ``critic`` (and ``critic2``), keyed as the
    #: JAX ``params``, with a 0-d ``log_alpha`` parameter under SAC's or REDQ's ``alpha="auto"``
    model: nn.Module
    #: lagged copy (None without a target net); actor-critic: a ModuleDict keyed as the JAX ``target_params``
    target: nn.Module | None
    #: one optimizer, or one per key of the JAX ``opt_state`` (continuous off-policy)
    optim: torch.optim.Optimizer | dict[str, torch.optim.Optimizer]
    hparams: dict[str, torch.Tensor]    # dynamic knobs the trainer anneals (eps, ...), 0-d float32
    step: torch.Tensor                  # 0-d int64
    #: algorithm-specific carried state, 0-d tensors written in place (the return statistics)
    extra: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Draws:
    """Random numbers handed to an update in place of its generator (tests
    hand over the draws of a JAX key). Each field is what the update would
    otherwise draw; a field the update reads must be given."""

    #: the sampled rows ``[B]`` (the JAX update's k1)
    indices: torch.Tensor | None = None
    #: preprocess's standard normals ``[B, A]``: TD3's smoothing, SAC's and REDQ's next action (k2)
    target: torch.Tensor | None = None
    #: REDQ's target subset of the ensemble ``[M]`` (k2)
    subset: torch.Tensor | None = None
    #: the gradient step's standard normals ``[B, A]``: SAC's and REDQ's actor sample (k3)
    actor: torch.Tensor | None = None
    #: IQN's fractions in ``[0, 1)``: the gradient step's ``[B, sample_size]`` (k3; ``update_step`` draws
    #: ``uniform(k3, (B, sample_size))``), or in ``forward`` the act's own ``uniform(key, (B, sample_size))``
    taus: torch.Tensor | None = None
    #: IQN's target fractions ``[B, target_sample_size]``: ``_target_q`` splits k2 into two keys and draws
    #: these from the first (``iqn.py:_target_q``: ``k1, k2 = split(key)``, ``uniform(k1, ...)``)
    target_taus: torch.Tensor | None = None
    #: IQN's fractions of the double-Q selection ``[B, online_sample_size]``, from the second of k2's halves
    online_taus: torch.Tensor | None = None
    #: HER's future-goal draws ``[B]`` in ``[0, 1)``: the offset into the episode's remaining steps and the
    #: relabel coin (the JAX buffer's ``sample`` splits k1 into the indices' key and ``k_her``, and
    #: ``relabel_plan`` splits ``k_her`` into these two)
    her_offset: torch.Tensor | None = None
    her_relabel: torch.Tensor | None = None
    #: BCQ's standard normals (JAX's ``update_step`` splits k3 into ``k_vae, k_dec, k_actor``): the VAE's
    #: reparameterization ``[B, latent]`` (``k_vae``), the decoded candidates of the target ``[B * n, latent]``
    #: (``k_dec``) and of the actor's loss ``[B, latent]`` (``k_actor``); in ``forward`` the act's own
    #: ``[B * forward_sampled_times, latent]``, ``normal(key, ...)``, under ``decode``
    vae: torch.Tensor | None = None
    decode_next: torch.Tensor | None = None
    decode_actor: torch.Tensor | None = None
    decode: torch.Tensor | None = None
    #: CQL's candidate actions (k3 splits into ``k_actor, k_rand, k_cur, k_next``; ``actor`` above is
    #: ``k_actor``'s): the random actions in ``[-1, 1)`` ``[B * R, A]``, and the standard normals of the
    #: current and the next policy's samples ``[B * R, A]``
    cql_rand: torch.Tensor | None = None
    cql_cur: torch.Tensor | None = None
    cql_next: torch.Tensor | None = None
    #: GAIL's discriminator batches, ``[disc_update_num, batch_size]`` row indices into the expert data and
    #: into the flattened rollout (``randint`` of the two halves of each step's key)
    expert_indices: torch.Tensor | None = None
    policy_indices: torch.Tensor | None = None
    #: PSRL's posterior sample: the transition model ``[S, A, S]`` (``dirichlet(k1, ...)``) and the
    #: reward's standard normals ``[S, A]`` (``normal(k2, ...)``)
    psrl_trans: torch.Tensor | None = None
    psrl_rew: torch.Tensor | None = None


def _per_row(source: torch.Generator | Draws, field: str, shape: tuple[int, ...],
             draw: Callable[[tuple[int, ...]], torch.Tensor]) -> torch.Tensor:
    """A per-row draw of ``shape`` ``[b, ...]``: ``draw(shape)``, or the ``field``
    of handed :class:`Draws`. Inside a mesh step (an active
    ``DataParallel``, whose ``b`` rows are this rank's positions of a global
    batch) the global ``[dp.rows(b), ...]`` tensor is drawn from the
    generator every rank holds alike, and this rank keeps its positions: each
    row gets the number one process gives it, and the generator advances as
    one process advances it. A handed ``Draws`` field is the one-process
    draw, of which the rank keeps its positions too."""
    dp = active_data_parallel()
    if isinstance(source, Draws):
        whole = getattr(source, field)
    else:
        whole = draw(shape if dp is None else (dp.rows(shape[0]), *shape[1:]))
    return whole if dp is None else dp.my_positions(whole)


def uniform(source: torch.Generator | Draws, field: str, shape: tuple[int, ...],
            device: torch.device | str) -> torch.Tensor:
    """float32 uniforms in ``[0, 1)`` of ``shape`` (``[b, ...]``, one row per
    batch row) on ``device``, drawn as :func:`_per_row` says."""
    out = _per_row(source, field, shape, lambda s: torch.rand(s, generator=source, device=device))
    return out.to(device=device, dtype=torch.float32)


def standard_normal(source: torch.Generator | Draws, field: str, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``like``'s shape (``[b, ...]``, one row per batch
    row), dtype and device, drawn as :func:`_per_row` says."""
    out = _per_row(source, field, tuple(like.shape),
                   lambda s: torch.randn(s, generator=source, device=like.device, dtype=like.dtype))
    return out.to(device=like.device, dtype=like.dtype)


def randint(source: torch.Generator | Draws, field: str, high: int, shape: tuple[int, ...],
            device: torch.device | str) -> torch.Tensor:
    """int64 integers in ``[0, high)`` of ``shape`` (``[b, ...]``, one row per
    batch row) on ``device``, drawn as :func:`_per_row` says."""
    out = _per_row(source, field, shape, lambda s: torch.randint(0, high, s, generator=source, device=device))
    return out.to(device=device, dtype=torch.int64)


def weighted_mean(elem: torch.Tensor, weight: torch.Tensor | None) -> torch.Tensor:
    """``mean(weight * elem)``, or ``mean(elem)`` without prioritized replay's weights."""
    return (elem if weight is None else weight * elem).mean()


@torch.no_grad()
def polyak_update(target: Iterable[torch.Tensor], online: Iterable[torch.Tensor], tau: float) -> None:
    """``target <- tau * online + (1 - tau) * target`` in place, as multi-tensor
    ops: ``optax.incremental_update``'s order of operations (two products,
    then their sum), not ``lerp``'s (reference utils/lagged_network.py)."""
    target, online = list(target), list(online)
    torch._foreach_mul_(target, 1.0 - tau)
    torch._foreach_add_(target, torch._foreach_mul(online, tau))


@torch.no_grad()
def sync_target(target: nn.Module, online: nn.Module, step: torch.Tensor, period: int) -> None:
    """Copy ``online``'s weights into ``target`` when the gradient-step count
    ``step``, already advanced past this step, is a multiple of ``period``: a
    select on the device (``tianshou_tpu`` ``jnp.where(sync, online,
    target)``), no host branch. On a sync step the target takes the online
    weights' bits; on any other step it keeps its own. One pointwise kernel
    per parameter, written in place."""
    sync = step % period == 0
    for t, o in zip(target.parameters(), online.parameters()):
        torch.where(sync, o, t, out=t)


def optimizer_tensors(opt: torch.optim.Optimizer) -> list[torch.Tensor]:
    """Every tensor a step of ``opt`` writes: its parameters, their state
    (Adam's step count and moments) and a learning rate held as a tensor."""
    out = []
    for group in opt.param_groups:
        out += group["params"]
        for p in group["params"]:
            out += [v for v in opt.state[p].values() if torch.is_tensor(v)]
        if torch.is_tensor(group["lr"]):
            out.append(group["lr"])
    return out


class Snapshot:
    """Copies of the tensors an update writes, to select back on the device
    with no host branch: :meth:`take` before the update, :meth:`restore_where`
    after it, ``torch.where(cond, old, new, out=new)`` per tensor. The JAX
    package selects whole trees with ``jnp.where``. The copies are grouped by
    dtype: a multi-tensor copy takes one dtype, and a mixed list falls back to
    one copy per tensor. An optimizer's state must exist before the first
    :meth:`take` (:func:`tianshou_tpu_torch.algorithm.optim.init_adam_state`)."""

    def __init__(self, tensors: Iterable[torch.Tensor]) -> None:
        self.groups: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            self.groups.setdefault(t.dtype, []).append(t)
        self.saved = {dtype: [torch.empty_like(t) for t in group] for dtype, group in self.groups.items()}

    @torch.no_grad()
    def take(self) -> None:
        for dtype, group in self.groups.items():
            torch._foreach_copy_(self.saved[dtype], group)

    @torch.no_grad()
    def restore_where(self, cond: torch.Tensor) -> None:
        """Where the 0-d bool ``cond`` holds, every tensor takes back its copy."""
        for dtype, group in self.groups.items():
            for old, new in zip(self.saved[dtype], group):
                torch.where(cond, old, new, out=new)


class ActOut(NamedTuple):
    act: torch.Tensor   # raw policy output (pre map_action)
    state: Any          # recurrent state (None if stateless)
    info: Batch         # logits / q values as needed


class Algorithm:
    """Base for all algorithms. Static config lives on ``self``; everything
    that changes during training lives in :class:`TrainState`."""

    #: buffer fields to skip when sampling inside :meth:`update`, for
    #: algorithms whose preprocess/update_step never read them
    update_sample_drop_keys: tuple[str, ...] = ()

    def __init__(
        self,
        action_space: Space,
        gamma: float = 0.99,
        optim: OptimizerFactory | None = None,
        action_scaling: bool = False,
        action_bound_method: str | None = "clip",  # "clip" | "tanh" | None
    ) -> None:
        if action_bound_method not in ("clip", "tanh", None):
            raise ValueError(f"action_bound_method must be 'clip', 'tanh' or None, got {action_bound_method!r}")
        self.action_space = action_space
        self.gamma = gamma
        self.optim = optim if optim is not None else AdamOptimizerFactory(lr=1e-3)
        self.action_scaling = action_scaling
        self.action_bound_method = action_bound_method
        self.is_discrete = isinstance(action_space, (Discrete, MultiDiscrete))

    @property
    def action_dim(self) -> int:
        """The number of discrete actions, or the flat width of a continuous action."""
        if isinstance(self.action_space, Discrete):
            return self.action_space.n
        return math.prod(self.action_space.shape)

    # ------------------------------------------------------------------
    def init(self, device: str | torch.device | None = None) -> TrainState:
        raise NotImplementedError

    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        raise NotImplementedError

    def exploration_noise(self, ts: TrainState, act: torch.Tensor, obs: Any,
                          generator: torch.Generator, training: bool = True) -> torch.Tensor:
        """Exploration hook (reference Policy.add_exploration_noise :354),
        called by collectors in both train and eval mode."""
        return act

    def init_policy_state(self, num_envs: int, device: str | torch.device | None = None) -> Any:
        """Initial policy state for the collector's carry on ``device`` (None
        for a stateless policy); the collector writes it in place."""
        return None

    def reset_policy_state(self, num_envs: int, generator: torch.Generator,
                           device: str | torch.device | None = None) -> Any:
        """State installed where an episode just finished (reference
        collector.py:1103): the initial state by default; gSDE draws its
        noise state from ``generator``."""
        return self.init_policy_state(num_envs, device)

    def refresh_policy_state(self, state: Any, num_envs: int, generator: torch.Generator) -> Any:
        """Run once at the start of every collect chunk: the state as it is
        by default; gSDE draws its noise matrix anew (arXiv:2005.05719)."""
        return state

    def map_action(self, act: torch.Tensor) -> torch.Tensor:
        """Raw policy output -> env action (reference Policy.map_action :254):
        a continuous action is clipped to [-1, 1] (or squashed by tanh), then
        with ``action_scaling`` mapped affinely onto the Box's bounds.
        Discrete actions pass unchanged."""
        if self.is_discrete:
            return act
        if self.action_bound_method == "clip":
            act = act.clamp(-1.0, 1.0)
        elif self.action_bound_method == "tanh":
            act = torch.tanh(act)
        if self.action_scaling and isinstance(self.action_space, Box):
            low, high = self.action_space.bounds(act.device)
            act = low + (high - low) * (act + 1.0) / 2.0
        return act

    def map_action_inverse(self, act: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`map_action` for env actions (reference :289)."""
        if self.is_discrete:
            return act
        if self.action_scaling and isinstance(self.action_space, Box):
            low, high = self.action_space.bounds(act.device)
            act = 2.0 * (act - low) / (high - low) - 1.0
        if self.action_bound_method == "tanh":
            eps = 1e-6
            act = torch.atanh(act.clamp(-1 + eps, 1 - eps))
        return act

    def compute_action(self, ts: TrainState, obs: np.ndarray, generator: torch.Generator | None = None) -> np.ndarray:
        """One observation in, its env action out, both numpy (reference
        Policy.compute_action :317): the deterministic action, mapped, computed
        on the algorithm's device (the train state's); a policy that samples
        draws from ``generator`` (default: one seeded 0 on that device)."""
        device = ts.step.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        obs_b = torch.as_tensor(np.asarray(obs), device=device)[None]
        out = self.forward(ts, obs_b, generator, deterministic=True)
        return self.map_action(out.act)[0].cpu().numpy()

    # ------------------------------------------------------------------
    def preprocess(self, ts: TrainState, buffer, buf_state, batch: Batch,
                   indices: torch.Tensor, generator: torch.Generator) -> Batch:
        """Compute targets before the gradient step (n-step / GAE)."""
        return batch

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        """One gradient step, in place; returns (ts, loss stats Batch).
        ``generator`` draws what the step samples (noisy-net noise)."""
        raise NotImplementedError

    def postprocess(self, ts: TrainState, buffer, buf_state, batch: Batch,
                    indices: torch.Tensor, stats: Batch):
        """Write back per-sample info (PER priorities). Returns buf_state."""
        return buf_state

    def update(self, ts: TrainState, buffer, buf_state, generator: torch.Generator | Draws,
               batch_size: int) -> tuple[TrainState, Any, Batch]:
        """sample -> preprocess -> update_step -> postprocess (reference
        Algorithm._update, algorithm_base.py:586). With :class:`Draws` for
        ``generator`` the buffer takes ``generator.indices`` as its draw. A
        buffer that relabels on sample (HER) gets the generator or the draws
        itself and every field, since relabelling reads ``obs_next``."""
        if getattr(buffer, "relabels_on_sample", False):
            batch, indices = buffer.sample(buf_state, generator, batch_size)
        else:
            rows = generator.indices if isinstance(generator, Draws) else generator
            batch, indices = buffer.sample(buf_state, rows, batch_size, drop_keys=self.update_sample_drop_keys)
        batch = self.preprocess(ts, buffer, buf_state, batch, indices, generator)
        ts, stats = self.update_step(ts, batch, generator)
        buf_state = self.postprocess(ts, buffer, buf_state, batch, indices, stats)
        return ts, buf_state, stats

    # ------------------------------------------------------------------
    def _nstep_terminal(self, buffer, buf_state, batch: Batch, indices: torch.Tensor):
        """n-step reward chain plus the terminal row's (obs_next, terminated).

        For n_step == 1 the terminal row is the sampled row, so the gathered
        batch is reused. For n_step > 1 only the two consumed fields are
        gathered at the terminal index.
        """
        base_state = buf_state.base if hasattr(buf_state, "base") else buf_state  # prioritized replay
        rews, ends, term_idx = buffer.n_step_gather(base_state, indices, self.n_step)
        if self.n_step == 1 and "obs_next" in batch:
            return rews, ends, batch.obs_next, batch.terminated
        terminal = buffer.get(buf_state, term_idx, keys=("obs_next", "terminated"))
        return rews, ends, terminal.obs_next, terminal.terminated


class OnPolicyAlgorithm(Algorithm):
    """Updates from whole fresh rollouts (reference :828)."""

    run_mode = "on_policy"

    def rollout_grad_steps(self, n: int, repeat: int, batch_size: int) -> int:
        """The gradient steps one ``update_rollout`` over ``n`` rows takes: the
        count the trainer adds, as the JAX trainer adds its stats'
        ``n_grad_steps``."""
        raise NotImplementedError


class OffPolicyAlgorithm(Algorithm):
    """Updates from replayed minibatches (reference :868). Subclasses that
    define ``_target_q(ts, obs_next, generator)`` get n-step bootstrapped
    targets from :meth:`preprocess` (reference ``compute_nstep_return``,
    :721); ``generator`` draws the target's noise (TD3, SAC, REDQ)."""

    run_mode = "off_policy"
    n_step: int = 1

    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | Draws | None) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def preprocess(self, ts, buffer, buf_state, batch: Batch, indices: torch.Tensor,
                   generator: torch.Generator) -> Batch:
        """``batch.returns``: the n-step returns bootstrapped by ``_target_q``
        at the chain's terminal row. Under HER (``relabels_on_sample``) the
        buffer's relabel plan (``her_new_goal``, ``her_relabel``, popped here)
        relabels the n-step chain as it relabelled the sample (the reference
        rewrites the buffer before ``compute_nstep_return``, her.py:100 and
        algorithm_base.py:721); at n = 1 the bootstrap comes straight off the
        relabelled batch."""
        if getattr(buffer, "relabels_on_sample", False):
            new_goal, relabel = batch.pop("her_new_goal"), batch.pop("her_relabel")
            if self.n_step == 1:
                tq = self._masked_target(ts, batch.obs_next, batch.terminated, generator)
                rew = batch.rew.reshape(batch.rew.shape + (1,) * (tq.dim() - 1))
                batch.returns = rew + self.gamma * tq
                return batch
            base_state = buf_state.base if hasattr(buf_state, "base") else buf_state
            rews, ends, term_idx = buffer.n_step_gather_relabeled(base_state, indices, self.n_step, new_goal, relabel)
            terminal = buffer.get(buf_state, term_idx, keys=("obs_next", "terminated"))
            terminal.obs_next = terminal.obs_next.copy()
            terminal.obs_next.desired_goal = buffer._splice(new_goal, terminal.obs_next.desired_goal, relabel)
            obs_next_t, terminated_t = terminal.obs_next, terminal.terminated
        else:
            rews, ends, obs_next_t, terminated_t = self._nstep_terminal(buffer, buf_state, batch, indices)
        batch.returns = nstep_returns(rews, ends, self._masked_target(ts, obs_next_t, terminated_t, generator),
                                      self.gamma)
        return batch

    def _masked_target(self, ts, obs_next: Any, terminated: torch.Tensor,
                       generator: torch.Generator | Draws | None) -> torch.Tensor:
        """``_target_q`` zeroed where the episode terminated."""
        tq = self._target_q(ts, obs_next, generator)
        mask = value_mask(terminated)
        return tq * mask.reshape(mask.shape + (1,) * (tq.dim() - 1))


class OfflineAlgorithm(Algorithm):
    """Updates from a fixed dataset (reference :906), trained by
    :class:`tianshou_tpu_torch.trainer.trainer.OfflineTrainer`. The offline
    members built on an off-policy algorithm (``DiscreteCQL``, ``TD3BC``,
    ``CQL``) subclass that algorithm and set ``run_mode = "offline"``, as the
    JAX package does."""

    run_mode = "offline"
