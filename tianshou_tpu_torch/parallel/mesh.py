"""Data- and tensor-parallel programs over a torch device mesh (port of
``tianshou_tpu/parallel/mesh.py``).

The reference scales with worker processes, ray actors and ``nn.DataParallel``
(SURVEY.md §2b). The JAX package runs one SPMD program over a
``jax.sharding.Mesh`` and lets XLA insert the collectives. Here every rank of a
``torch.distributed`` process group runs the same Python program on its own
slice of the envs (and of the replay ring), and the collectives are written
out where one process would have computed over the whole batch:

- **Draws.** A rank's envs draw from that rank's own generator (policy
  samples, exploration, env steps, resets); the update draws come from an
  ``update_generator`` that every rank holds in the same state. A global
  draw (the minibatch permutation, the replay sample, REDQ's ensemble subset,
  PSRL's posterior) is the same on every rank. A per-row draw of a ``[b,
  ...]`` tensor (TD3's target smoothing, SAC's and REDQ's action noise,
  IQN's fractions, HER's relabel plan, GAIL's discriminator rows) draws the
  global ``[W*b, ...]`` tensor and keeps this rank's positions of it
  (``algorithm/base.py:uniform``, ``standard_normal``, ``randint``): every
  row gets the number one process gives it, and the generator advances as
  one process advances it.
- **Rows.** A minibatch holds global row indices. Each rank computes the loss
  on its ``B/W`` positions of it, fetched from the ranks that own the rows
  (one ``all_to_all`` per read, a row's fields packed together); the rollout
  and the ring never move.
- **Gradients** are all-reduced as a sum and divided by the world size in
  :meth:`DataParallel.average_grads`, which
  ``algorithm/optim.py:OptimizerFactory.step`` calls before the global-norm
  clip, so every rank takes the same step and the parameters stay the same.
- **Batch statistics** (the advantage normalisation of a minibatch, the
  return statistics' Welford merge, the stats a step returns) are reduced
  over the ranks; per-env state (``NormObs``, GAE) stays local. NPG and TRPO
  average the surrogate's gradient, each Fisher-vector product and the line
  search's objective and KL over the ranks; PSRL counts the whole rollout on
  every rank.

The on-policy step takes every on-policy algorithm (PPO, A2C, REINFORCE,
NPG, TRPO, GAIL, the ICM wrapper, PSRL, the multi-agent dispatcher); the
off-policy step every off-policy algorithm, over a uniform, a prioritized, a
relabelling (HER) or a ``sample_avail`` ring.

At world size 1 every collective runs and copies or divides by 1.0; only the
moments of a batch are taken as one process takes them, so a step gives the
trainer's program bit for bit. The hooks in the algorithm code read
``utils/data_parallel.py:active_data_parallel``, which a step sets while it
updates.

``tp_axis`` (tensor parallelism, :func:`shard_params_tp`): every 2-D weight
whose output dimension divides by the ``mp`` axis is a ``DTensor`` sharded on
dim 0 (a torch ``Linear`` weight is ``[out, in]``; JAX's flax kernel
``[in, out]`` shards dim 1), the rest is replicated. Each layer computes its
columns of the output on its rank and gathers them (Megatron's column-parallel
layer with a gathered output); gradients are averaged over the ``dp`` axis
only.
"""

from __future__ import annotations

import copy
import functools
from collections.abc import Callable
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from tianshou_tpu_torch.algorithm.base import Draws
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import BufferState, ReplayBuffer
from tianshou_tpu_torch.data.buffer.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.parallel.distributed import mesh_device_type
from tianshou_tpu_torch.utils.data_parallel import activated
from tianshou_tpu_torch.utils.device import resolve_device
from tianshou_tpu_torch.utils.tree import tree_map

__all__ = [
    "DataParallel",
    "make_mesh",
    "make_mesh_2d",
    "replicate",
    "shard_buffer",
    "shard_leading",
    "shard_params_tp",
    "make_dp_train_step",
    "make_dp_offpolicy_train_step",
]


# ---------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------
def _ensure_group(n_devices: int | None, device: str | torch.device | None) -> None:
    """A one-rank group for a process that never called ``initialize``, as
    the JAX mesh needs no set-up on one device."""
    if dist.is_initialized():
        return
    if n_devices not in (None, 1):
        raise RuntimeError(f"a mesh of {n_devices} ranks needs parallel.distributed.initialize first")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev.index)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(), world_size=1, rank=0)


def make_mesh(n_devices: int | None = None, axis_name: str = "dp",
              device: str | torch.device | None = None) -> DeviceMesh:
    """A 1-D mesh over the process group's ``n_devices`` ranks (default:
    all). Without a group, ``make_mesh(1)`` makes a one-rank group on
    ``device`` (default: the card)."""
    _ensure_group(n_devices, device)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"a mesh of {n_devices} ranks in a group of {world}")
    return init_device_mesh(mesh_device_type(), (world,), mesh_dim_names=(axis_name,))


def make_mesh_2d(n_devices: int, mp: int = 2, axis_names: tuple[str, str] = ("dp", "mp")) -> DeviceMesh:
    """2-D mesh for data x model (tensor) parallelism: ``n_devices / mp`` by ``mp``."""
    if n_devices % mp:
        raise ValueError(f"{n_devices} ranks do not split into rows of mp={mp}")
    _ensure_group(n_devices, None)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"a mesh of {n_devices} ranks in a group of {dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(), (n_devices // mp, mp), mesh_dim_names=axis_names)


def replicate(mesh: DeviceMesh) -> list:
    """The placements of a tensor held whole on every rank of ``mesh``."""
    return [Replicate()] * mesh.ndim


def shard_leading(mesh: DeviceMesh, axis_name: str = "dp") -> list:
    """The placements of a tensor split on its leading axis over ``axis_name``."""
    return [Shard(0) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def _sub_mesh(mesh: DeviceMesh, axis_name: str) -> DeviceMesh:
    return mesh if mesh.ndim == 1 else mesh[axis_name]


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
def tp_sharded(shape: tuple[int, ...], mp: int) -> bool:
    """The placement rule: a 2-D weight whose output dim (dim 0 of ``[out, in]``) divides by ``mp``."""
    return len(shape) == 2 and shape[0] % mp == 0


class _TPHooks:
    """Forward hooks of the modules that hold ``DTensor`` parameters: the
    outermost such module takes its tensor inputs as replicated ``DTensor`` s
    and hands a plain, gathered tensor back, so that nothing outside it meets
    a ``DTensor``."""

    def __init__(self, mesh: DeviceMesh) -> None:
        self.mesh = mesh
        self.depth = 0

    def pre(self, module: nn.Module, args: tuple) -> tuple:
        self.depth += 1
        if self.depth > 1:
            return args
        return tuple(DTensor.from_local(a, self.mesh, [Replicate()], run_check=False)
                     if torch.is_tensor(a) and not isinstance(a, DTensor) else a for a in args)

    def post(self, module: nn.Module, args: tuple, out: Any) -> Any:
        self.depth -= 1
        if self.depth > 0:
            return out
        return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, out)


def shard_params_tp(model: nn.Module, mesh: DeviceMesh, axis_name: str = "mp", optim=None) -> nn.Module:
    """Megatron-style placement of ``model``'s parameters, in place: each 2-D
    weight whose output dim divides by the ``axis_name`` size becomes a
    ``DTensor`` with ``Shard(0)`` on that sub-mesh, every other parameter a
    replicated one. ``optim`` (an optimizer or a dict of them) is carried
    over: its parameter references, and its state placed as its parameter.
    Returns ``model``."""
    sub = _sub_mesh(mesh, axis_name)
    mp = sub.size()
    hooks = _TPHooks(sub)
    placed: dict[int, nn.Parameter] = {}
    for module in model.modules():
        own = list(module.named_parameters(recurse=False))
        if not own:
            continue
        for name, p in own:
            if isinstance(p, DTensor):
                continue
            placements = [Shard(0)] if tp_sharded(tuple(p.shape), mp) else [Replicate()]
            new = nn.Parameter(distribute_tensor(p.detach(), sub, placements), requires_grad=p.requires_grad)
            setattr(module, name, new)
            placed[id(p)] = new
        module.register_forward_pre_hook(hooks.pre)
        module.register_forward_hook(hooks.post)
    optims = optim.values() if isinstance(optim, dict) else [] if optim is None else [optim]
    for opt in optims:
        for group in opt.param_groups:
            for i, p in enumerate(group["params"]):
                new = placed.get(id(p))
                if new is None:
                    continue
                state = opt.state.pop(p, {})
                opt.state[new] = {k: distribute_tensor(v, sub, new.placements)
                                  if torch.is_tensor(v) and v.shape == p.shape and v.dim() else v
                                  for k, v in state.items()}
                group["params"][i] = new
    return model


# ---------------------------------------------------------------------------
# the data-parallel group of a step
# ---------------------------------------------------------------------------
#: one tensor gathered from every rank into one (its name since torch 2.11)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class DataParallel:
    """The ``axis_name`` sub-mesh of a step's mesh: this rank's place in it
    and the collectives the update hooks use. ``rollout_envs``: the envs of
    one rank's rollout (the on-policy row layout ``t * E + e``)."""

    def __init__(self, mesh: DeviceMesh, axis_name: str = "dp", rollout_envs: int | None = None) -> None:
        sub = _sub_mesh(mesh, axis_name)
        self.group = sub.get_group()
        self.world = sub.size()
        self.rank = sub.get_local_rank()
        self.rollout_envs = rollout_envs

    # -- reductions ----------------------------------------------------
    @torch.no_grad()
    def average_grads(self, params: list[torch.Tensor]) -> None:
        """Every gradient all-reduced as a sum and divided by the world size,
        in place (the local shard of a ``DTensor`` gradient), one collective
        per dtype."""
        grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad for p in params if p.grad is not None]
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat, group=self.group)
            flat.div_(float(self.world))
            torch._foreach_copy_(group, [piece.view_as(g) for piece, g in zip(flat.split([g.numel() for g in group]),
                                                                               group)])

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of equal-sized ``x``: their pieces' means, summed and divided by the world size."""
        return self.average(x.mean())

    def moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(mean, variance)`` over the ranks' equal-sized pieces of ``x``,
        the variance divided by N; at world size 1 ``x.mean()`` and
        ``x.var(correction=0)`` as one process takes them."""
        if self.world == 1:
            return x.mean(), x.var(correction=0)
        mean = self.mean(x)
        return mean, self.mean((x - mean) ** 2)

    def mean_std(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(mean, std)`` over the ranks' pieces of ``x`` (``std`` divided by N)."""
        if self.world == 1:
            return x.mean(), x.std(correction=0)
        mean, var = self.moments(x)
        return mean, var.sqrt()

    def average(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (one shape on every rank) summed over the ranks and divided by the world size."""
        out = x.detach().reshape(-1).clone()
        dist.all_reduce(out, group=self.group)
        return out.div_(float(self.world)).view_as(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` concatenated on dim 0, in rank order."""
        if x.dtype == torch.bool:
            return self.all_gather(x.view(torch.uint8)).view(torch.bool)
        out = x.new_empty((self.world * x.shape[0], *x.shape[1:]))
        _all_gather_single(out, x.contiguous(), group=self.group)
        return out

    def whole_rollout(self, x: torch.Tensor) -> torch.Tensor:
        """The global time-major ``[T, E, ...]`` rollout tensor from every
        rank's ``[T, E/W, ...]``, the envs in rank order."""
        T, E_r = x.shape[:2]
        parts = self.all_gather(x).reshape(self.world, T, E_r, *x.shape[2:])
        return parts.transpose(0, 1).reshape(T, self.world * E_r, *x.shape[2:])

    def reduce_stats(self, stats: Batch) -> Batch:
        """A step's stats as one process would report them: 0-d floating
        stats averaged over the ranks (one collective), per-row stats
        gathered in rank order, the rest as they are."""
        by_dtype: dict[torch.dtype, list[str]] = {}
        for k, v in stats.items():
            if torch.is_tensor(v) and v.dim() == 0 and v.is_floating_point():
                by_dtype.setdefault(v.dtype, []).append(k)
        out = Batch(dict(stats.items()))
        for keys in by_dtype.values():
            flat = torch.stack([stats[k] for k in keys])
            dist.all_reduce(flat, group=self.group)
            flat.div_(float(self.world))
            out.update(zip(keys, flat.unbind()))
        for k, v in stats.items():
            if isinstance(v, Batch):
                out[k] = self.reduce_stats(v)
            elif torch.is_tensor(v) and v.dim() >= 1:
                out[k] = self.all_gather(v)
        return out

    # -- rows that cross ranks -----------------------------------------
    def route(self, owner: torch.Tensor, fn: Callable[[], Any]) -> Any:
        """This rank's ``B/W`` positions of a ``[B]`` global selection, each
        row from its owner: ``fn()`` returns every position's rows as this rank
        sees them (right where ``owner`` is this rank); each row's bytes, every
        field side by side, go to rank ``p // (B/W)`` in one ``all_to_all``."""
        rows = fn()
        B = owner.shape[0]
        per = B // self.world
        mine = owner[self.rank * per:(self.rank + 1) * per]
        leaves: list[torch.Tensor] = []
        tree_map(leaves.append, rows)
        packed = torch.cat([v.reshape(-1).view(torch.uint8).reshape(B, -1) for v in leaves], dim=1)
        recv = torch.empty_like(packed)
        dist.all_to_all_single(recv, packed, group=self.group)
        got = recv.reshape(self.world, per, -1)[mine, torch.arange(per, device=owner.device)]
        widths = [v[0].numel() * v.element_size() for v in leaves]
        pieces = iter(got.split(widths, dim=1))
        return tree_map(lambda v: next(pieces).contiguous().view(v.dtype).reshape(per, *v.shape[1:]), rows)

    def my_positions(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``B/W`` positions of a ``[B]`` global tensor."""
        per = x.shape[0] // self.world
        return x[self.rank * per:(self.rank + 1) * per]

    def rollout_rows(self, batch: Batch, idx: torch.Tensor) -> Batch:
        """This rank's positions of the global rollout rows ``idx`` (global row
        ``t * E + e``; rank ``e // E_r`` holds it as its row ``t * E_r + e % E_r``)."""
        E_r = self.rollout_envs
        t, e = idx // (E_r * self.world), idx % (E_r * self.world)
        owner, local = e // E_r, t * E_r + e % E_r
        return self.route(owner, lambda: batch[local])

    def rows(self, n: int) -> int:
        """The global row count of ``n`` rows per rank."""
        return n * self.world


# ---------------------------------------------------------------------------
# a replay ring split by envs over the ranks
# ---------------------------------------------------------------------------
def _global_leaves(dp: DataParallel, offset: int, idx: torch.Tensor) -> torch.Tensor:
    """Every rank's written ring rows at their global leaves (``-1`` kept), in rank order."""
    return dp.all_gather(torch.where(idx >= 0, idx + offset, -1))


def shard_buffer(buffer: ReplayBuffer, mesh: DeviceMesh, axis_name: str = "dp") -> ReplayBuffer:
    """This rank's part of ``buffer``: the rings of its ``E/W`` envs, with
    ``buffer``'s capacity per ring. A prioritized buffer keeps its sum tree
    over every rank's rows: each add writes all ranks' new rows at their
    global leaves, so every rank holds the same tree."""
    dp = DataParallel(mesh, axis_name)
    if buffer.num_envs % dp.world:
        raise ValueError(f"{buffer.num_envs} env rings do not split over {dp.world} ranks")
    local = copy.copy(buffer)
    local.num_envs = buffer.num_envs // dp.world
    local.total_size = local.capacity * local.num_envs
    if isinstance(local, PrioritizedReplayBuffer):
        local.leaf_map = functools.partial(_global_leaves, dp, dp.rank * local.total_size)
    return local


class _ShardedRing:
    """The update's view of a rank's ring (a subclass of the ring's own
    buffer class, so an algorithm's ``isinstance`` checks hold): flat indices
    address the global ``[E, C]`` layout, sampling draws over every rank's
    rows, and each read runs where the row lives (:meth:`DataParallel.route`);
    a prioritized ring's writeback gathers every rank's new priorities, so
    every rank writes the same tree. A relabelling (HER) ring's plan is made
    by the rank that holds the sampled row, from the global draw, since an
    episode's future rows lie in its env's ring."""

    _dp: DataParallel
    _local: ReplayBuffer  # the rank's own ring, which reads its rows
    _per_rank: int  # rows of one rank's rings

    def _owner(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return idx // self._per_rank, idx % self._per_rank

    def sample_indices(self, state, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        dp = self._dp
        if isinstance(self, PrioritizedReplayBuffer):  # the tree is global
            return super().sample_indices(state, generator, batch_size)
        if self.sample_avail and self.stack_num > 1:  # every rank's mask in rank order: the whole ring's
            ok = dp.all_gather(self._local._avail_mask(state))
            return torch.multinomial(ok.to(torch.float32), batch_size, replacement=True, generator=generator)
        whole = copy.copy(self._local)
        whole.num_envs = self.num_envs * dp.world
        cursor, size, last_idx = dp.all_gather(torch.stack([state.cursor, state.size, state.last_idx], dim=1)).unbind(1)
        view = BufferState(data=Batch(), cursor=cursor, size=size, last_idx=last_idx)
        return ReplayBuffer.sample_indices(whole, view, generator, batch_size)

    def sample(self, state, generator: torch.Generator | Draws | torch.Tensor, batch_size: int,
               drop_keys: tuple[str, ...] = ()) -> tuple[Batch, torch.Tensor]:
        dp = self._dp
        rows = generator.indices if isinstance(generator, Draws) else generator
        idx = self._indices(state, rows, batch_size)  # [B], the same on every rank
        owner, local = self._owner(idx)
        if getattr(self, "relabels_on_sample", False):  # the plan's global uniforms, each rank's positions gathered
            u_off, u_mask = (dp.all_gather(u) for u in self.plan_draws(generator, batch_size // dp.world, idx.device))
            batch = dp.route(owner, lambda: self._local.relabelled(state, local, u_off, u_mask, drop_keys))
        else:
            batch = dp.route(owner, lambda: self._local.get(state, local, drop_keys=drop_keys))
        if isinstance(self, PrioritizedReplayBuffer):
            batch.weight = dp.my_positions(self.get_weight(state, idx))
        return batch, dp.my_positions(idx)

    def get(self, state, flat_idx: torch.Tensor, stack_num=None, keys=None, drop_keys=()) -> Batch:
        owner, local = self._owner(self._dp.all_gather(flat_idx))
        return self._dp.route(owner, lambda: self._local.get(state, local, stack_num, keys=keys, drop_keys=drop_keys))

    def _chain(self, flat_idx: torch.Tensor, gather: Callable) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """An n-step chain per row of ``flat_idx``, walked where the row lives:
        ``gather(local indices)`` gives the owner's ``(rews [n, B], ends [n,
        B], terminal index)`` for every global position."""
        owner, local = self._owner(self._dp.all_gather(flat_idx))
        offset = self._dp.rank * self._per_rank

        def here() -> Batch:
            rews, ends, term = gather(local)
            return Batch(rews=rews.T, ends=ends.T, term=term + offset)

        out = self._dp.route(owner, here)
        return out.rews.T, out.ends.T, out.term

    def n_step_gather(self, state, flat_idx: torch.Tensor, n: int):
        return self._chain(flat_idx, lambda local: self._local.n_step_gather(state, local, n))

    def n_step_gather_relabeled(self, state, flat_idx: torch.Tensor, n: int, new_goal: torch.Tensor,
                                relabel: torch.Tensor):
        goal, rel = self._dp.all_gather(new_goal), self._dp.all_gather(relabel)
        return self._chain(flat_idx, lambda local: self._local.n_step_gather_relabeled(state, local, n, goal, rel))

    def update_weight(self, state, flat_idx: torch.Tensor, td_error: torch.Tensor):
        return self._local.update_weight(state, self._dp.all_gather(flat_idx), self._dp.all_gather(td_error.detach()))


def _sharded_ring(local: ReplayBuffer, dp: DataParallel) -> ReplayBuffer:
    cls = type(local)
    view_cls = type(f"Sharded{cls.__name__}", (_ShardedRing, cls), {})
    view = object.__new__(view_cls)
    view.__dict__.update(local.__dict__)
    view._dp, view._per_rank, view._local = dp, local.num_envs * local.capacity, local
    return view


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------
def _stack(stats: list[Batch]) -> Batch:
    return tree_map(lambda *xs: torch.stack(xs), *stats)


def _minibatch_loops(algo) -> list:
    """The algorithms whose minibatch loops an ``update_rollout`` of ``algo``
    runs: ``algo`` itself, a wrapper's inner algorithm, each agent of a
    dispatcher (none for PSRL)."""
    if hasattr(algo, "algorithms"):
        return [a for agent in algo.algorithms for a in _minibatch_loops(agent)]
    if hasattr(algo, "wrapped"):
        return _minibatch_loops(algo.wrapped)
    return [algo] if hasattr(algo, "minibatch_shape") else []


def make_dp_train_step(algo, collector, mesh: DeviceMesh, n_steps: int, repeat: int, batch_size: int,
                       axis_name: str = "dp", tp_axis: str | None = None):
    """One data-parallel on-policy megastep: a collect of ``n_steps`` on this
    rank's envs (``collector`` holds its ``E/W``), then ``update_rollout``
    over the global ``[T, E]`` rollout, for any on-policy algorithm (the
    module docstring says how each family reduces over the ranks).

    Returns ``step(ts, cstate, generator, update_generator=None) -> (ts,
    cstate, stats)``; ``generator`` is this rank's, ``update_generator`` the
    one every rank holds alike (``None``: ``generator``, the one-process
    program). With ``tp_axis``, place the weights with :func:`shard_params_tp`
    on that axis first; gradients are then averaged over ``axis_name`` only.
    The analogue of the reference's ``DataParallelNet`` (net/common.py:473).
    """
    dp = DataParallel(mesh, axis_name, rollout_envs=collector.venv.num_envs)
    rows = dp.rows(n_steps * collector.venv.num_envs)
    for loop in _minibatch_loops(algo):
        mb_size = loop.minibatch_shape(rows, batch_size)[1]
        if mb_size % dp.world:
            raise ValueError(f"a minibatch of {mb_size} rows ({rows} rollout rows over batch_size {batch_size}) does "
                             f"not split over {dp.world} ranks")
    if tp_axis is not None and tp_axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no axis {tp_axis!r}")

    def step(ts, cstate, generator: torch.Generator, update_generator: torch.Generator | None = None):
        out = collector.rollout(ts, cstate, None, generator, n_steps, keep_rollout=True)
        with activated(dp):
            ts, stats = algo.update_rollout(ts, out.rollout, generator if update_generator is None else update_generator,
                                            repeat, batch_size)
        return ts, cstate, stats

    return step


def make_dp_offpolicy_train_step(algo, collector, buffer: ReplayBuffer, mesh: DeviceMesh, n_steps: int, n_updates: int,
                                 batch_size: int, axis_name: str = "dp"):
    """One data-parallel off-policy megastep: a collect of ``n_steps`` into
    this rank's rings, then ``n_updates`` gradient steps over every rank's
    rows (the mesh analogue of ``OffPolicyTrainer.megastep``).

    ``buffer`` is the whole replay buffer (``E`` rings); the collector holds
    this rank's ``E/W`` envs and ``shard_buffer(buffer, mesh)``, and the
    buffer state is that shard's. Writes during the collect are rank-local;
    sample indices are drawn over the global ``[E, C]`` layout from
    ``update_generator`` (through every rank's ``sample_avail`` mask where the
    ring has one), the owners gather the rows (n-step chains and HER's
    future goals never leave one env's ring) and hand each rank its ``B/W``
    of them. Returns ``step(ts, cstate, buf_state, generator,
    update_generator=None) -> (ts, cstate, buf_state, collect output, stacked
    update stats)``. An update's per-row draws (target or actor noise, IQN's
    fractions, HER's relabel plan) are the global batch's draw from
    ``update_generator``, of which each rank keeps its rows' numbers: the
    numbers one process draws for them. The JAX step has no ``tp_axis``, and
    neither has this one.
    """
    dp = DataParallel(mesh, axis_name)
    local = collector.buffer
    if local.capacity != buffer.capacity or local.num_envs * dp.world != buffer.num_envs:
        raise ValueError(f"the collector's rings ({local.num_envs} x {local.capacity}) are not 1/{dp.world} of "
                         f"the buffer's ({buffer.num_envs} x {buffer.capacity}): give it shard_buffer(buffer, mesh)")
    if batch_size % dp.world:
        raise ValueError(f"batch_size {batch_size} does not split over {dp.world} ranks")
    ring = _sharded_ring(local, dp)

    def step(ts, cstate, buf_state, generator: torch.Generator, update_generator: torch.Generator | None = None):
        gen_u = generator if update_generator is None else update_generator
        out = collector.rollout(ts, cstate, buf_state, generator, n_steps)
        with activated(dp):
            stats = [dp.reduce_stats(algo.update(ts, ring, buf_state, gen_u, batch_size)[2]) for _ in range(n_updates)]
        return ts, cstate, buf_state, out, _stack(stats)

    return step
