"""Rank programs of the port's multi-process CPU tests, and the setups both
sides of those tests build (no JAX here: the ranks import only the port).

``python -m tests._torch_mesh_worker KIND RDZV WORLD RANK OUT`` joins a gloo
group of ``WORLD`` ranks at ``RDZV`` (a ``file://`` URL), runs every check of
``KIND`` and writes what the test compares to ``OUT/KIND_rank{RANK}.pt``:

- ``distributed``: the twin of ``tests/distributed_worker.py``;
- ``mesh2``: the on-policy step (PPO, CartPole), and the off-policy step (DQN,
  CartPole) over a uniform and a prioritized ring, at world size 2, and the
  on-policy step's refusal of a minibatch that does not split over the ranks;
- ``mesh4``: the tensor-parallel on-policy step on a 2 x 2 mesh.

The test process computes the one-process composition from the same setups
while the ranks run (:func:`onpolicy_reference`, :func:`offpolicy_reference`).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from tianshou_tpu_torch.utils.tree import tree_map

#: on-policy: envs, steps, passes, batch (tests/test_mesh.py:40-50)
ON_E, ON_T, ON_REPEAT, ON_BATCH = 32, 8, 2, 64
#: off-policy: envs, ring slots per env, steps, updates, batch (tests/test_mesh.py:90-122)
OFF_E, OFF_SLOTS, OFF_T, OFF_UPDATES, OFF_BATCH = 16, 64, 16, 4, 32
MP = 2  # the model axis of the 2 x 2 mesh
ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120  # the longest a test waits for its ranks


def spawn(kind: str, world: int, tmp: Path) -> list:
    """Start ``world`` ranks of ``kind``; they meet at a file in ``tmp``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-m", "tests._torch_mesh_worker", kind, f"file://{tmp}/rdzv_{kind}",
                              str(world), str(r), str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def join(procs: list, kind: str, tmp: Path) -> list[dict]:
    """The ranks' records, waited for under one timeout of ``JOIN_S``; on a
    hang every rank is killed, and a hang or a failed rank raises."""
    try:
        outs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{kind} ranks did not finish within {JOIN_S} s") from None
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{kind} rank {r} failed:\n{out}"
    return [torch.load(tmp / f"{kind}_rank{r}.pt", weights_only=False) for r in range(len(procs))]


def rank_generator(rank: int, base: int) -> torch.Generator:
    """The generator of data-parallel rank ``rank``'s envs."""
    return torch.Generator().manual_seed(base + rank)


def update_generator(seed: int) -> torch.Generator:
    """The update's generator, held alike by every rank."""
    return torch.Generator().manual_seed(seed)


def ppo():
    """CartPole and PPO over 64x64 nets, advantage normalisation and return standardisation on."""
    from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic

    torch.manual_seed(0)
    env = CartPole()
    return env, PPO(actor=DiscreteActor((64, 64), 2, input_dim=4), critic=DiscreteCritic((64, 64), input_dim=4),
                    action_space=env.action_space, optim=AdamOptimizerFactory(lr=3e-4, max_grad_norm=0.5),
                    deterministic_eval=True, advantage_normalization=True, return_standardization=True)


def dqn():
    from tianshou_tpu_torch.algorithm.modelfree.dqn import DQN
    from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory
    from tianshou_tpu_torch.env.classic.cartpole import CartPole
    from tianshou_tpu_torch.models.mlp import Net

    torch.manual_seed(0)
    env = CartPole()
    return env, DQN(model=Net((64, 64), 2, input_dim=4), action_space=env.action_space,
                    optim=AdamOptimizerFactory(lr=1e-3), gamma=0.97, n_step_return_horizon=3, target_update_freq=8,
                    eps_training=0.3)


def ring(prio: bool, envs: int = OFF_E):
    from tianshou_tpu_torch.data.buffer.base import VectorReplayBuffer
    from tianshou_tpu_torch.data.buffer.prio import PrioritizedVectorReplayBuffer

    if prio:
        return PrioritizedVectorReplayBuffer(OFF_SLOTS * envs, envs, alpha=0.6, beta=0.4)
    return VectorReplayBuffer(OFF_SLOTS * envs, envs)


def example():
    from tianshou_tpu_torch.data.batch import Batch

    return Batch(obs=torch.zeros(4), act=torch.tensor(0), rew=torch.tensor(0.0), terminated=torch.tensor(False),
                 truncated=torch.tensor(False), obs_next=torch.zeros(4))


def collector(env, envs: int, algo, buffer):
    from tianshou_tpu_torch.data.collector import DeviceCollector
    from tianshou_tpu_torch.env.core import VectorDeviceEnv

    return DeviceCollector(VectorDeviceEnv(env, envs, device="cpu"), algo, buffer)


def _recording(coll, into: list) -> None:
    """Keep every ``rollout`` output of ``coll``."""
    rollout = coll.rollout

    def recorded(*args, **kwargs):
        out = rollout(*args, **kwargs)
        into.append(tree_map(torch.clone, out))
        return out

    coll.rollout = recorded


def plain(tree):
    """Every tensor of ``tree`` as a plain CPU tensor (a ``DTensor`` gathered)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x.detach().clone(), tree)


def ring_record(bs) -> dict:
    """A ring's tensors (a prioritized state's base ring)."""
    base = getattr(bs, "base", bs)
    return plain({"data": base.data, "cursor": base.cursor, "size": base.size, "last_idx": base.last_idx})


def ts_record(ts) -> dict:
    opt = ts.optim.state_dict()["state"]
    return {"params": plain(dict(ts.model.state_dict())), "step": int(ts.step), "extra": plain(dict(ts.extra)),
            "adam": {i: plain({k: v for k, v in s.items() if k != "step"}) for i, s in opt.items()}}


# ---------------------------------------------------------------------------
# the one-process compositions
# ---------------------------------------------------------------------------
def onpolicy_reference(slices: int, repeat: int = ON_REPEAT) -> dict:
    """Each of ``slices`` env slices collected in turn with its rank's
    generator, then ``update_rollout`` over the concatenated rollout with the
    update generator: what the ranks' step must give."""
    env, algo = ppo()
    ts = algo.init("cpu")
    outs, cstates = [], []
    for r in range(slices):
        coll = collector(env, ON_E // slices, algo, None)
        g = rank_generator(r, 100)
        cstate = coll.reset(g)
        outs.append(coll.rollout(ts, cstate, None, g, ON_T, keep_rollout=True))
        cstates.append(plain(cstate))
    rollout = tree_map(lambda *xs: torch.cat(xs, dim=1), *[o.rollout for o in outs])
    ts, stats = algo.update_rollout(ts, rollout, update_generator(7), repeat, ON_BATCH)
    return {"rollouts": [o.rollout for o in outs], "cstates": cstates, "ts": ts_record(ts), "stats": plain(stats)}


def offpolicy_reference(prio: bool, slices: int = 2) -> dict:
    """Each slice collected in turn into its own rings with its rank's
    generator, the rings joined into the whole buffer's (its sum tree
    written at every stored row, as the adds write it), then the updates with
    the update generator."""
    env, algo = dqn()
    ts = algo.init("cpu")
    rings = []
    for r in range(slices):
        local = ring(False, OFF_E // slices)
        coll = collector(env, OFF_E // slices, algo, local)
        bs = local.init(example(), "cpu")
        g = rank_generator(r, 200)
        coll.rollout(ts, coll.reset(g), bs, g, OFF_T)
        rings.append(bs)
    whole = ring(prio, OFF_E)
    bs = whole.init(example(), "cpu")
    base = bs.base if prio else bs
    tree_map(lambda dst, *xs: dst.copy_(torch.cat(xs)), base.data, *[b.data for b in rings])
    for name in ("cursor", "size", "last_idx"):
        getattr(base, name).copy_(torch.cat([getattr(b, name) for b in rings]))
    if prio:
        stored = torch.arange(OFF_SLOTS)[None, :] < base.size[:, None]
        leaves = torch.nonzero(stored.reshape(-1))[:, 0]
        whole.segtree.update(bs.tree, leaves, (bs.max_prio ** whole.alpha).expand(leaves.shape))
    gu = update_generator(9)
    stats = [algo.update(ts, whole, bs, gu, OFF_BATCH)[2] for _ in range(OFF_UPDATES)]
    out = {"rings": [ring_record(b) for b in rings], "ts": ts_record(ts), "loss": torch.stack([s.loss for s in stats])}
    if prio:
        out["tree"] = bs.tree.clone()
    return out


# ---------------------------------------------------------------------------
# the rank programs
# ---------------------------------------------------------------------------
def run_distributed(rdzv: str, world: int, rank: int) -> dict:
    from torch.distributed.tensor import Replicate

    from tianshou_tpu_torch.parallel.distributed import (
        global_to_host_local,
        host_local_to_global,
        initialize,
        make_global_mesh,
        process_env_slice,
    )

    initialize(rdzv, world, rank, device="cpu")
    initialize(rdzv, world, rank, device="cpu")  # idempotent
    try:
        initialize(rdzv, world + 1, rank, device="cpu")
        raised = False
    except RuntimeError:
        raised = True
    mesh = make_global_mesh("dp")
    E = 16
    start, count = process_env_slice(E)
    local = np.arange(start, start + count, dtype=np.float32)[:, None] * np.ones(4, np.float32)
    global_x = host_local_to_global(local, mesh)
    mean = global_x.mean().redistribute(mesh, [Replicate()]).to_local()
    back = global_to_host_local(global_x * 2.0 + 1.0)
    return {"raised": raised, "slice": (start, count), "shape": tuple(global_x.shape), "mean": mean, "local": local,
            "back": back}


def _onpolicy_rank(mesh, dp_rank: int, dp_world: int, repeat: int, tp_axis: str | None = None) -> dict:
    from tianshou_tpu_torch.parallel.mesh import make_dp_train_step, shard_params_tp

    env, algo = ppo()
    ts = algo.init("cpu")
    sharded = []
    if tp_axis is not None:
        shard_params_tp(ts.model, mesh, tp_axis, optim=ts.optim)
        from torch.distributed.tensor import DTensor, Shard

        sharded = [n for n, p in ts.model.named_parameters() if isinstance(p, DTensor) and p.placements == (Shard(0),)]
    coll = collector(env, ON_E // dp_world, algo, None)
    outs: list = []
    _recording(coll, outs)
    g = rank_generator(dp_rank, 100)
    cstate = coll.reset(g)
    step = make_dp_train_step(algo, coll, mesh, ON_T, repeat, ON_BATCH, tp_axis=tp_axis)
    ts, cstate, stats = step(ts, cstate, g, update_generator(7))
    return {"rollout": outs[0].rollout, "cstate": plain(cstate), "ts": ts_record(ts), "stats": plain(stats),
            "sharded": sharded}


def _offpolicy_rank(mesh, rank: int, world: int, prio: bool) -> dict:
    from tianshou_tpu_torch.parallel.mesh import make_dp_offpolicy_train_step, shard_buffer

    env, algo = dqn()
    ts = algo.init("cpu")
    buffer = ring(prio)
    local = shard_buffer(buffer, mesh)
    coll = collector(env, OFF_E // world, algo, local)
    bs = local.init(example(), "cpu")
    g = rank_generator(rank, 200)
    step = make_dp_offpolicy_train_step(algo, coll, buffer, mesh, OFF_T, OFF_UPDATES, OFF_BATCH)
    ts, cstate, bs, out, ustats = step(ts, coll.reset(g), bs, g, update_generator(9))
    rec = {"ring": ring_record(bs), "ts": ts_record(ts),
           "loss": ustats.loss.clone(), "td_error": ustats.td_error.clone()}
    if prio:
        rec["tree"] = bs.tree.clone()
    return rec


def _minibatch_guard(mesh) -> str:
    """The error of an on-policy step whose minibatch does not split over the
    ranks: 13 envs a rank, 5 steps and batch_size 64 (minibatches of 65 rows)."""
    from tianshou_tpu_torch.parallel.mesh import make_dp_train_step

    env, algo = ppo()
    try:
        make_dp_train_step(algo, collector(env, 13, algo, None), mesh, 5, 1, ON_BATCH)
    except ValueError as e:
        return str(e)
    return "no error"


def run_mesh2(rdzv: str, world: int, rank: int) -> dict:
    from tianshou_tpu_torch.parallel.distributed import initialize
    from tianshou_tpu_torch.parallel.mesh import make_mesh

    initialize(rdzv, world, rank, device="cpu")
    mesh = make_mesh(world)
    return {"onpolicy": _onpolicy_rank(mesh, rank, world, ON_REPEAT),
            "uniform": _offpolicy_rank(mesh, rank, world, prio=False),
            "prio": _offpolicy_rank(mesh, rank, world, prio=True),
            "guard": _minibatch_guard(mesh)}


def run_mesh4(rdzv: str, world: int, rank: int) -> dict:
    from tianshou_tpu_torch.parallel.distributed import initialize
    from tianshou_tpu_torch.parallel.mesh import make_mesh_2d

    initialize(rdzv, world, rank, device="cpu")
    mesh = make_mesh_2d(world, mp=MP)
    dp_rank, dp_world = mesh.get_local_rank("dp"), mesh.size(0)
    return {"tp": _onpolicy_rank(mesh, dp_rank, dp_world, 1, tp_axis="mp")}


RUNS = {"distributed": run_distributed, "mesh2": run_mesh2, "mesh4": run_mesh4}


def main(kind: str, rdzv: str, world: int, rank: int, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    record = RUNS[kind](rdzv, world, rank)
    torch.save(record, f"{out_dir}/{kind}_rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
