"""The offline scripts (``offline/_gather.py``'s, ``d4rl_bcq``), each through its own ``main`` on the CPU at a tiny
size (``tests/_torch_example_runs.py``). They take no option but ``--device`` (``d4rl_bcq``: ``--dataset`` and
``--epochs``), so the sizes are cut where they are set: the behavior run (SAC on Pendulum or DQN on CartPole) trains
one epoch of 64 steps after a 64-step prefill, the dataset holds 256 rows (``gather_*``'s ``dataset_size``, from
20,000), and the offline trainer runs one epoch of 16 updates (from 8-10 epochs of 500). ``d4rl_bcq`` synthesizes
its d4rl-layout file under a temporary directory, then learns from it.
"""

import pytest

from tests._torch_example_runs import Cut, assert_finite_run, run_main
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TRAINERS = dict(max_epochs=1, epoch_num_steps=64, start_steps=64, update_step_num_gradient_steps_per_epoch=16)
SMALL = {"dataset_size": 256}


def _cut(script: str, gather: str) -> Cut:
    return Cut(trainer=TRAINERS, partials={f"examples_torch.offline.{script}:{gather}": SMALL})


RUNS = {
    "offline/cql_pendulum.py": _cut("cql_pendulum", "gather_pendulum"),
    "offline/td3_bc_pendulum.py": _cut("td3_bc_pendulum", "gather_pendulum"),
    "offline/bcq_pendulum.py": _cut("bcq_pendulum", "gather_pendulum"),
    "offline/il_pendulum.py": _cut("il_pendulum", "gather_pendulum"),
    "offline/discrete_bcq_cartpole.py": _cut("discrete_bcq_cartpole", "gather_cartpole"),
    "offline/discrete_cql_cartpole.py": _cut("discrete_cql_cartpole", "gather_cartpole"),
    "offline/discrete_crr_cartpole.py": _cut("discrete_crr_cartpole", "gather_cartpole"),
    "offline/d4rl_bcq.py": Cut(("--epochs", "1"), TRAINERS, {"examples_torch.offline._gather:gather_pendulum": SMALL},
                               needs=("h5py",)),
}


@pytest.mark.parametrize("rel", list(RUNS))
def test_an_offline_script_trains_on_the_cpu_through_its_main(rel, monkeypatch, tmp_path, capsys):
    cut = RUNS[rel]
    if rel == "offline/d4rl_bcq.py":
        dataset = tmp_path / "pendulum_d4rl.hdf5"
        cut = cut._replace(argv=(*cut.argv, "--dataset", str(dataset)))
    rec = run_main(rel, cut, monkeypatch)
    assert_finite_run(rec)
    behavior, offline = rec.trainers
    assert type(behavior).__name__ == "OffPolicyTrainer" and type(offline).__name__ == "OfflineTrainer"
    assert rec.result.epochs == 1 and rec.result.gradient_step == 16
    assert int(rec.result.buf_state.size.sum()) == 256  # the dataset the offline trainer learned from
    out = capsys.readouterr().out
    assert "[gather] behavior policy best_reward=" in out and ": best_reward=" in out
    if rel == "offline/d4rl_bcq.py":
        assert dataset.stat().st_size > 0 and "synthesized d4rl-format dataset" in out
