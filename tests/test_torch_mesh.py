"""The port's mesh programs (``tianshou_tpu_torch/parallel/mesh.py``) on
gloo CPU process groups, twins of ``tests/test_mesh.py``.

One spawn per world size runs every check of that world (the rank programs
are ``tests/_torch_mesh_worker.py``, which imports no JAX), while this process
computes the one-process composition on the same global inputs: each env
slice collected in turn with its rank's generator, then the update with the
update generator. The one-process programs compared against are the ones
``tests/test_torch_{dqn,prio,onpolicy}.py`` hold against the JAX package.

- world 2: the on-policy step (PPO over CartPole, E = 32, 8 steps, 2 passes
  of batch 64, advantage normalisation and return standardisation on) and
  the off-policy step (DQN, E = 16, 64 slots per env, 16 steps, 4 updates of
  batch 32) over a uniform and a prioritized ring (alpha 0.6, beta 0.4):
  rollouts and rings bit-equal to the one-process slices, parameters (and
  sum trees) bit-identical across ranks and within JAX's mesh tolerance
  (``rtol=2e-4, atol=2e-5``) of the one-process run, every collected step
  landed.
- world 4, a 2 x 2 mesh: ``shard_params_tp`` makes every 64x64 weight a
  ``DTensor`` with ``Shard(0)`` on ``mp``, and one ``tp_axis="mp"`` step
  matches the one-process run.
- against JAX: the port's placement rule picks the leaves that JAX's
  ``shard_params_tp`` shards on a (dp, mp) mesh of host devices, mapped
  through ``models/convert.py``. A JAX mesh run cannot be held against the port's
  directly: JAX's keys cannot be handed through ``make_dp_*``, whose draws
  come from torch generators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_mesh_worker as W
from tests._torch_threads import one_intra_op_thread  # noqa: F401
from tianshou_tpu.models import discrete as jdisc
from tianshou_tpu.parallel import mesh as jmesh
from tianshou_tpu_torch.models.convert import actor_critic_params_from_flax
from tianshou_tpu_torch.models.discrete import DiscreteActor, DiscreteCritic
from tianshou_tpu_torch.parallel.mesh import tp_sharded

MESH_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worlds' ranks, started together; this process computes the
    one-process runs meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh")
    procs = {"mesh2": W.spawn("mesh2", 2, tmp), "mesh4": W.spawn("mesh4", 4, tmp)}
    torch.set_num_threads(1)
    refs = {"onpolicy": W.onpolicy_reference(2), "uniform": W.offpolicy_reference(False),
            "prio": W.offpolicy_reference(True), "tp": W.onpolicy_reference(2, repeat=1)}
    return {kind: W.join(p, kind, tmp) for kind, p in procs.items()}, refs


@pytest.fixture(scope="module")
def world2(spawned):
    return spawned[0]["mesh2"], spawned[1]


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned[0]["mesh4"], spawned[1]["tp"]


def assert_equal_trees(a, b, what: str) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: leaf {i} differs"


def _leaves(tree) -> list:
    from tianshou_tpu_torch.utils.tree import tree_leaves

    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


def assert_close_ts(got: dict, want: dict) -> None:
    assert got["step"] == want["step"]
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), **MESH_TOL, err_msg=k)
    for k, v in want["extra"].items():
        np.testing.assert_allclose(got["extra"][k].numpy(), v.numpy(), rtol=2e-4, err_msg=k)


# ---------------------------------------------------------------------------
# world 2
# ---------------------------------------------------------------------------
def test_onpolicy_step_rollouts_are_the_one_process_slices(world2):
    ranks, refs = world2
    for r, rec in enumerate(ranks):
        assert_equal_trees(rec["onpolicy"]["rollout"], refs["onpolicy"]["rollouts"][r], f"rank {r} rollout")
        assert_equal_trees(rec["onpolicy"]["cstate"], refs["onpolicy"]["cstates"][r], f"rank {r} collect state")


def test_onpolicy_step_matches_the_one_process_update(world2):
    ranks, refs = world2
    assert ranks[0]["onpolicy"]["ts"]["step"] == W.ON_REPEAT * (W.ON_T * W.ON_E // W.ON_BATCH)
    assert_equal_trees(ranks[0]["onpolicy"]["ts"], ranks[1]["onpolicy"]["ts"], "parameters across ranks")
    assert_close_ts(ranks[0]["onpolicy"]["ts"], refs["onpolicy"]["ts"])
    for k, v in refs["onpolicy"]["stats"].items():
        np.testing.assert_allclose(ranks[0]["onpolicy"]["stats"][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["uniform", "prio"])
def test_offpolicy_step_rings_are_the_one_process_slices(world2, kind):
    ranks, refs = world2
    for r, rec in enumerate(ranks):
        assert_equal_trees(rec[kind]["ring"], refs[kind]["rings"][r], f"rank {r} ring")
    assert sum(int(rec[kind]["ring"]["size"].sum()) for rec in ranks) == W.OFF_T * W.OFF_E  # every collected step landed


@pytest.mark.parametrize("kind", ["uniform", "prio"])
def test_offpolicy_step_matches_the_one_process_updates(world2, kind):
    ranks, refs = world2
    a, b = ranks[0][kind], ranks[1][kind]
    assert a["ts"]["step"] == W.OFF_UPDATES
    assert_equal_trees(a["ts"], b["ts"], "parameters across ranks")
    assert_close_ts(a["ts"], refs[kind]["ts"])
    np.testing.assert_allclose(a["loss"].numpy(), refs[kind]["loss"].numpy(), **MESH_TOL)
    assert a["td_error"].shape == (W.OFF_UPDATES, W.OFF_BATCH)
    if kind == "prio":
        assert torch.equal(a["tree"], b["tree"])
        np.testing.assert_allclose(a["tree"].numpy(), refs[kind]["tree"].numpy(), **MESH_TOL)


def test_onpolicy_step_refuses_a_minibatch_that_does_not_split(world2):
    """2 x 13 envs, 5 steps and batch_size 64 make minibatches of 65 rows: the step is refused when it is made."""
    ranks, _ = world2
    for rec in ranks:
        assert "a minibatch of 65 rows" in rec["guard"], rec["guard"]


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------
def test_world_size_1_steps_are_the_one_process_programs_bit_for_bit():
    """``make_mesh(1)`` in a process with no group makes a one-rank gloo group; through it the on-policy step and the
    prioritized off-policy step, with no ``update_generator``, give the bits of the plain programs (the collect, then
    ``update_rollout`` or the updates, on one generator): every collective of the multi-rank program runs at one rank
    (the rows routed, the stats reduced, the prioritized ring's leaves gathered through ``shard_buffer``)."""
    import torch.distributed as dist

    from tianshou_tpu_torch.parallel.mesh import make_dp_offpolicy_train_step, make_dp_train_step, make_mesh, shard_buffer

    assert not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        runs = []
        for mesh_step in (False, True):
            env, algo = W.ppo()
            ts, coll, g = algo.init("cpu"), W.collector(env, W.ON_E, algo, None), W.rank_generator(0, 100)
            cstate = coll.reset(g)
            if mesh_step:
                stats = make_dp_train_step(algo, coll, mesh, W.ON_T, W.ON_REPEAT, W.ON_BATCH)(ts, cstate, g)[2]
            else:
                out = coll.rollout(ts, cstate, None, g, W.ON_T, keep_rollout=True)
                stats = algo.update_rollout(ts, out.rollout, g, W.ON_REPEAT, W.ON_BATCH)[1]
            env, dqn = W.dqn()
            d_ts, buffer = dqn.init("cpu"), W.ring(prio=True)
            local = shard_buffer(buffer, mesh) if mesh_step else buffer
            d_coll, bs, d_g = W.collector(env, W.OFF_E, dqn, local), local.init(W.example(), "cpu"), W.rank_generator(0, 200)
            d_cs = d_coll.reset(d_g)
            if mesh_step:
                ustats = make_dp_offpolicy_train_step(dqn, d_coll, buffer, mesh, W.OFF_T, W.OFF_UPDATES,
                                                      W.OFF_BATCH)(d_ts, d_cs, bs, d_g)[4]
            else:
                d_coll.rollout(d_ts, d_cs, bs, d_g, W.OFF_T)
                ustats = [dqn.update(d_ts, buffer, bs, d_g, W.OFF_BATCH)[2] for _ in range(W.OFF_UPDATES)]
                ustats = {k: torch.stack([s[k] for s in ustats]) for k in ustats[0].keys()}
            runs.append([W.ts_record(ts), W.plain(cstate), W.plain(dict(stats)), g.get_state(), W.ts_record(d_ts),
                         W.ring_record(bs), bs.tree, W.plain(d_cs), W.plain(dict(ustats)), d_g.get_state()])
    finally:
        dist.destroy_process_group()
    assert_equal_trees(runs[0], runs[1], "mesh step at world size 1 against the plain programs")


# ---------------------------------------------------------------------------
# world 4: dp x mp
# ---------------------------------------------------------------------------
def test_tp_step_shards_the_64x64_weights_and_matches_the_one_process_run(world4):
    ranks, ref = world4
    for r, rec in enumerate(ranks):
        tp = rec["tp"]
        square = {n for n, p in tp["ts"]["params"].items() if p.shape == (64, 64)}
        assert square and square <= set(tp["sharded"]), f"rank {r}: {tp['sharded']}"
        for n, p in tp["ts"]["params"].items():  # exactly the rule's leaves
            assert (n in tp["sharded"]) == tp_sharded(tuple(p.shape), W.MP), n
        assert_equal_trees(tp["ts"], ranks[0]["tp"]["ts"], f"rank {r} against rank 0")
        assert_equal_trees(tp["rollout"], ref["rollouts"][r // W.MP], f"rank {r} rollout")
        assert_close_ts(tp["ts"], ref["ts"])


# ---------------------------------------------------------------------------
# the placement rule against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mp", [2, 4])
def test_shard_params_tp_picks_jax_leaves(mp):
    """Each flax leaf is filled with its own number and placed by JAX's
    ``shard_params_tp`` on a (dp, mp) mesh of host devices; the leaves it
    shards on ``mp`` are carried over, and the port's rule must pick the
    parameters that hold a sharded leaf's number."""
    key, obs = jax.random.key(0), jnp.zeros((1, 4))
    jparams = {"actor": jax.eval_shape(jdisc.DiscreteActor((64, 64), 2).init, key, obs),
               "critic": jax.eval_shape(jdisc.DiscreteCritic((64, 64)).init, key, obs)}
    leaves, treedef = jax.tree.flatten(jparams)
    marked = jax.tree.unflatten(treedef, [np.full(x.shape, i + 1, np.float32) for i, x in enumerate(leaves)])
    placed = jax.tree.leaves(jmesh.shard_params_tp(marked, jmesh.make_mesh_2d(4, mp=mp), "mp"))
    jax_picks = {int(x.reshape(-1)[0]) for x in placed if "mp" in tuple(x.sharding.spec)}
    model = torch.nn.ModuleDict({"actor": DiscreteActor((64, 64), 2, input_dim=4),
                                 "critic": DiscreteCritic((64, 64), input_dim=4)})
    converted = actor_critic_params_from_flax(marked, model)
    port_picks = {int(v.reshape(-1)[0]) for k, v in converted.items() if tp_sharded(tuple(v.shape), mp)}
    assert jax_picks and port_picks == jax_picks
