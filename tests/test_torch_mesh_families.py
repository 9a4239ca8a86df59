"""The port's mesh steps over every algorithm family and ring that the JAX
mesh steps run (``tianshou_tpu/parallel/mesh.py``: one ``jax.jit`` program
that XLA partitions, whatever the algorithm), on gloo CPU process groups.

One world-2 spawn runs every case (``tests/_torch_mesh_families_worker.py``,
which imports no JAX), while this process computes each case's one-process
composition on the same global inputs: each env slice collected in turn with
its rank's generator, then the update with the update generator. The
one-process programs are the ones ``tests/test_torch_{continuous_offpolicy,
distributional,her,trust_region,gail,icm_psrl,marl}.py`` hold against the
JAX package.

Cases (narrow nets): SAC, TD3 and REDQ on Pendulum, IQN on CartPole,
HER-DDPG at n = 3 on GoalReach, DQN over a ``sample_avail`` ring of 3
stacked CartPole frames and the multi-agent off-policy dispatcher on
TicTacToe (host envs), each 4 updates of batch 32 after a collect of 16
(boards: 8) steps; NPG, TRPO, GAIL, the ICM on-policy wrapper over PPO,
PSRL on NChain and the multi-agent on-policy dispatcher, each one rollout
and its update. Each case holds:

- the ranks' train states bit-identical (weights, targets, optimizer states);
- the weights, the carried state and the stats within the JAX mesh
  tolerance (``rtol=2e-4, atol=2e-5``) of the one-process run (NPG and TRPO
  at three conjugate-gradient iterations: ten amplify the other order of
  the ranks' sums to 1e-3 of the actor's weights, as they amplify the
  difference between JAX's and the port's products in
  ``tests/test_torch_trust_region.py``);
- at world size 1, in this process, the mesh step bit-identical to the
  plain program.

SAC's and TD3's per-row noise (target smoothing, the actor's sample) that
each rank's rows used is bit-equal to those rows of the one-process draw.
"""

import numpy as np
import pytest
import torch

from tests import _torch_mesh_families_worker as W
from tests._torch_threads import one_intra_op_thread  # noqa: F401
from tianshou_tpu_torch.utils.tree import tree_leaves

MESH_TOL = dict(rtol=2e-4, atol=2e-5)
CASES = list(W.CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 ranks' records, this process's one-process references,
    and the world-size-1 runs (a one-rank gloo group made here)."""
    import torch.distributed as dist

    from tianshou_tpu_torch.parallel.mesh import make_mesh

    tmp = tmp_path_factory.mktemp("families")
    procs = W.spawn(tmp)
    torch.set_num_threads(1)
    refs = {name: W.reference(name) for name in CASES}
    assert not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")
    try:
        ones = {name: W.world_one(name, mesh) for name in CASES}
    finally:
        dist.destroy_process_group()
    return W.collect(procs, tmp), refs, ones


def _ranks(runs, name):
    ranks = [rec[name] for rec in runs[0]]
    for r, rec in enumerate(ranks):
        assert "error" not in rec, f"rank {r}:\n{rec['error']}"
    return ranks


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if torch.is_tensor(x)]


def _assert_equal(a, b, what: str) -> None:
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: tensor {i} differs by {float((x.double() - y.double()).abs().max())}"


def _flat_params(rec: dict) -> dict:
    """Each weight (and target weight) of a train-state record, by name (each agent's of a dispatcher)."""
    if "params" not in rec:
        return {f"{agent}.{k}": v for agent, sub in rec.items() for k, v in _flat_params(sub).items()}
    out = dict(rec["params"])
    out.update({f"target.{k}": v for k, v in rec.get("target", {}).items()})
    return out


def _steps(rec: dict) -> list:
    return [rec["step"]] if "step" in rec else [s for sub in rec.values() for s in _steps(sub)]


@pytest.mark.parametrize("name", CASES)
def test_ranks_hold_bit_identical_train_states(runs, name):
    a, b = _ranks(runs, name)
    _assert_equal(a["ts"], b["ts"], f"{name}: rank 0 against rank 1")


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_matches_the_one_process_update(runs, name):
    got, want = _ranks(runs, name)[0], runs[1][name]
    assert _steps(got["ts"]) == _steps(want["ts"]) and all(s > 0 for s in _steps(got["ts"]))
    gp, wp = _flat_params(got["ts"]), _flat_params(want["ts"])
    assert gp.keys() == wp.keys()
    for k, w in wp.items():
        np.testing.assert_allclose(gp[k].numpy(), w.numpy(), **MESH_TOL, err_msg=f"{name}: {k}")
    for k, w in want["ts"].get("extra", {}).items():  # PSRL's posterior: the whole rollout counted on each rank
        np.testing.assert_allclose(got["ts"]["extra"][k].numpy(), w.numpy(), **MESH_TOL, err_msg=f"{name}: {k}")
    for k, w in want["stats"].items():
        if torch.is_tensor(w) and w.is_floating_point():
            np.testing.assert_allclose(got["stats"][k].numpy(), w.numpy(), **MESH_TOL, err_msg=f"{name}: {k}")
    if "rings" in want:  # each rank's ring is its slice of the one-process collect
        for r, rec in enumerate(_ranks(runs, name)):
            _assert_equal(rec["ring"], want["rings"][r], f"{name}: rank {r} ring")


@pytest.mark.parametrize("name", CASES)
def test_world_size_1_mesh_step_is_the_plain_program_bit_for_bit(runs, name):
    mesh_run, plain_run = runs[2][name]
    _assert_equal(mesh_run, plain_run, f"{name}: the mesh step at world size 1 against the plain program")


@pytest.mark.parametrize("name", W.NOISE_CASES)
def test_each_rank_draws_its_rows_of_the_one_process_noise(runs, name):
    """The fault this guards against: each rank drawing ``[B/W, A]`` from the shared generator, so that every
    rank's rows get rank 0's numbers and the generator runs behind the one-process program's."""
    ranks, want = _ranks(runs, name), runs[1][name]["noise"]
    assert want and all(len(rec["noise"]) == len(want) for rec in ranks)
    per = W.OFF_BATCH // W.WORLD
    for r, rec in enumerate(ranks):
        for i, ((field, got), (wfield, whole)) in enumerate(zip(rec["noise"], want)):
            assert field == wfield
            rows = whole[r * per:(r + 1) * per]
            assert torch.equal(got, rows), (f"{name}: rank {r}'s draw {i} ({field}) is not its rows of the one-process "
                                            f"draw: largest difference {float((got - rows).abs().max())}")
