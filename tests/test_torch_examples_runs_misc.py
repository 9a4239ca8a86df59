"""The remaining scripts, each through its own ``main`` on the CPU at a tiny size (``tests/_torch_example_runs.py``),
and the guard that every script of ``examples_torch/`` has such a run.

- ``continuous/{sac_pendulum,ddpg_her_goalreach}``, ``discrete/ppo_cartpole_hl``, ``inverse/irl_gail`` and
  ``modelbased/psrl``: one epoch, cut in the trainer where the script has no option (a 64-step prefill and epoch;
  PPO's and GAIL's collects 8 steps a env); GAIL's expert dataset of 256 rows.
- ``box2d/*``: 2 train envs, one epoch of 40 steps after a 40-step prefill. The device scripts step ``Acrobot``
  and ``MountainCarContinuous``; the host ones Gymnasium's Box2D envs in ``SubprocVectorEnv`` workers. A test
  phase counts 2 episodes.
- ``marl/*``: the self-play of ``selfplay`` with a 64-step prefill, 2 rounds and 4 evaluation episodes (from 500, 200
  and 100): both DQNs updated, agent 0 played against the random policy.

A script that needs a package beyond the port's skips, naming it, where that package is absent (``Box2D``,
``pettingzoo``, ``h5py``, ``tensorboard`` and ``matplotlib``, Gymnasium's MuJoCo): all are present here.
"""

import importlib
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from tests._torch_example_runs import Cut, assert_finite_run, run_main
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

SHORT = dict(epoch_num_steps=64, start_steps=64, test_step_num_episodes=2)
BOX2D = ("--epochs", "1", "--num-envs", "2")
RUNS = {
    "continuous/sac_pendulum.py": Cut(trainer=dict(SHORT, max_epochs=1)),
    "continuous/ddpg_her_goalreach.py": Cut(trainer=dict(SHORT, max_epochs=1)),
    "discrete/ppo_cartpole_hl.py": Cut(trainer=dict(SHORT, max_epochs=1, collection_step_num_env_steps=8,
                                                    update_step_num_repetitions=1)),
    "inverse/irl_gail.py": Cut(trainer=dict(SHORT, max_epochs=1, epoch_num_steps=128, collection_step_num_env_steps=8),
                               partials={"examples_torch.inverse.irl_gail:gather_pendulum": {"dataset_size": 256}}),
    "modelbased/psrl.py": Cut(("--epochs", "1", "--epoch-num-steps", "800"), dict(test_step_num_episodes=2)),
    "box2d/acrobot_dualdqn.py": Cut((*BOX2D, "--epoch-num-steps", "40", "--buffer-size", "200"),
                                    dict(start_steps=40, test_step_num_episodes=2)),
    "box2d/mcc_sac.py": Cut((*BOX2D, "--epoch-num-steps", "40"), dict(start_steps=40, test_step_num_episodes=2)),
    "box2d/lunarlander_dqn.py": Cut(BOX2D, dict(epoch_num_steps=40, start_steps=40, test_step_num_episodes=2),
                                    needs=("Box2D",)),
    "box2d/bipedal_sac.py": Cut(BOX2D, dict(epoch_num_steps=40, start_steps=40, test_step_num_episodes=2),
                                needs=("Box2D",)),
    "box2d/bipedal_bdq.py": Cut((*BOX2D, "--epoch-num-steps", "40", "--buffer-size", "200"),
                                dict(start_steps=40, test_step_num_episodes=2), needs=("Box2D",)),
}
SELFPLAY = {"prefill": 64, "rounds": 2, "eval_episodes": 4}
MARL = {
    "marl/tictactoe_selfplay.py": Cut(partials={"examples_torch.marl.tictactoe_selfplay:selfplay": SELFPLAY}),
    "marl/pettingzoo_tictactoe_dqn.py": Cut(
        partials={"examples_torch.marl.pettingzoo_tictactoe_dqn:selfplay": SELFPLAY}, needs=("pettingzoo",)),
}


@pytest.mark.parametrize("rel", list(RUNS))
def test_a_script_trains_on_the_cpu_through_its_main(rel, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)  # an experiment's persistence writes under ./log
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rec = run_main(rel, RUNS[rel], monkeypatch)
    # a summary reads a trained scalar without its graph (sac_pendulum's alpha printed through .detach())
    assert not [w for w in caught if "requires_grad=True to a scalar" in str(w.message)]
    assert_finite_run(rec)
    assert rec.result.epochs == 1 and rec.result.gradient_step > 0 and rec.result.env_step > 0
    assert "best_reward=" in capsys.readouterr().out
    if RUNS[rel].needs:  # the host scripts' workers are closed after the run
        (trainer,) = rec.trainers
        assert type(trainer).__name__ == "HostOffPolicyTrainer"
        assert type(trainer.train_collector.venv).__name__ == "SubprocVectorEnv"
        assert trainer.train_collector.venv.is_closed and trainer.test_collector.venv.is_closed


def test_dqn_cartpole_logs_through_tensorboard(monkeypatch, tmp_path):
    """``--logdir``: the logger writes through ``torch.utils.tensorboard``, and the run's test rewards read back
    from its event files."""
    pytest.importorskip("tensorboard")
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # TensorBoard's stand-in: TensorFlow's import takes 10 s
    from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger

    rec = run_main("discrete/dqn_cartpole.py", Cut(("--epochs", "1", "--logdir", str(tmp_path)),
                                                   dict(epoch_num_steps=200, start_steps=100)), monkeypatch)
    assert_finite_run(rec)
    (trainer,) = rec.trainers
    assert type(trainer.params.logger.writer).__module__.startswith("torch.utils.tensorboard")
    trainer.params.logger.writer.close()
    logged = TensorboardLogger(log_dir=str(tmp_path)).restore_logged_data()
    assert [v for _, v in logged["test/reward"]] == [float(np.mean(rec.tests[0].returns))]


@pytest.mark.parametrize("rel", list(MARL))
def test_a_self_play_script_trains_on_the_cpu_through_its_main(rel, monkeypatch, capsys):
    rec = run_main(rel, MARL[rel], monkeypatch)
    stats, ts = rec.result
    tensors = chip_smoke._ex_weights(torch, rec.result)
    assert tensors and all(t.device.type == "cpu" and bool(torch.isfinite(t).all()) for t in tensors)
    assert len(stats.returns) == 4 and np.isfinite(stats.returns).all()
    assert all(int(ts[f"agent{i}"].step) == 2 for i in (0, 1))  # one update a round for each agent
    assert "win rate vs random: " in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------
PORT = Path(__file__).resolve().parents[1] / "examples_torch"
#: the modules with a script's CPU run: {module: its runs' table(s)}
RUN_TABLES = {
    "tests.test_torch_examples_runs": ("RUNS",),
    "tests.test_torch_examples_runs_atari": ("RUNS",),
    "tests.test_torch_examples_runs_mujoco": ("RUNS",),
    "tests.test_torch_examples_runs_hl": ("RUNS",),
    "tests.test_torch_examples_runs_offline": ("RUNS",),
    "tests.test_torch_examples_runs_misc": ("RUNS", "MARL"),
    "tests.test_torch_vizdoom_domain": ("TINY",),
}
#: scripts run by a test of their own, not a table's: {script: the test}
OWN_TESTS = {
    "mujoco/plotter.py": "tests/test_torch_examples_runs_mujoco.py::test_the_plotter_plots_a_multi_seed_log_directory",
    "benchmark/seed_vmap.py": "tests/test_torch_benchmark_seed_vmap.py::test_main_trains_every_seed",
    "benchmark/seed_queue.py": "tests/test_torch_benchmark_queue.py::test_the_queue_runs_every_kind_of_job",
    "benchmark/run_benchmark.py": "tests/test_torch_benchmark_scripts.py::test_run_benchmark_runs_one_cell",
    "benchmark/throughput.py": "tests/test_torch_benchmark_scripts.py::test_throughput_sweeps_through_its_main",
    "benchmark/offpolicy_throughput.py":
        "tests/test_torch_benchmark_scripts.py::test_offpolicy_throughput_runs_both_modes_through_its_main",
    "benchmark/host_throughput.py": "tests/test_torch_benchmark_scripts.py::test_host_throughput_runs_both_collectors",
    "benchmark/host_overlap.py": "tests/test_torch_benchmark_scripts.py::test_host_overlap_trains_in_three_modes",
}


def _scripts() -> set[str]:
    """Every script of ``examples_torch/``: a file with a ``main`` that is not a runner, a sibling or a package file."""
    return {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
            if not p.name.startswith("_") and "def main(" in p.read_text()}


def test_every_script_runs_on_the_cpu_or_names_the_package_it_skips_on():
    """A script of ``examples_torch/`` fails this unless a CPU run through its ``main`` holds it: a table entry of a
    run module (whose ``needs`` names each package it skips on), or a test of its own that says so."""
    covered = set(OWN_TESTS)
    for module, tables in RUN_TABLES.items():
        mod = importlib.import_module(module)
        for table in tables:
            covered |= set(getattr(mod, table))
    scripts = _scripts()
    assert len(scripts) == 58
    assert scripts - covered == set(), sorted(scripts - covered)
    assert covered - scripts == set(), sorted(covered - scripts)
    for path, test in OWN_TESTS.items():
        file, name = test.split("::")
        assert f"def {name}(" in (PORT.parent / file).read_text(), test
