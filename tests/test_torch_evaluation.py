"""The port's multi-seed evaluation (``tianshou_tpu_torch/evaluation/``)
against the JAX package's.

- ``iqm``, ``stratified_bootstrap_ci`` and ``eval_results``: bit-equal to
  JAX's on the same scores and seed (both are numpy with the same draws).
- ``load_and_eval_experiments``: the same arrays from both packages over the
  same event files, written once by JAX's and once by the port's
  ``TensorboardLogger`` (the twin of ``tests/test_utils_infra.py:182-207``);
  the IQM plot is written.
- The launchers (the twin of ``tests/test_models_eval.py:49-65``):
  ``ReinforceExperimentBuilder`` on CartPole, seeds 0 and 1 on the CPU, give
  what ``Experiment.run`` gives per seed; a failing experiment lands in
  ``failures`` and the others run on; ``PoolExpLauncher(2)`` under ``spawn``
  gives the sequential results, and reports an experiment that does not
  pickle as a failure.
"""

import dataclasses
import functools
import os
import sys
import types

# TensorBoard reads event files with its own reader where TensorFlow is absent (its ``notf`` marker), as on a
# machine without TensorFlow: the files read the same, and TensorFlow's import costs seconds
sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))

import numpy as np  # noqa: E402
import pytest
import torch

from tests._torch_threads import one_intra_op_thread  # noqa: F401
from tianshou_tpu.evaluation import rliable_evaluation as jre
from tianshou_tpu.utils.logger.tensorboard import TensorboardLogger as JTensorboardLogger
from tianshou_tpu_torch.env.classic.cartpole import CartPole
from tianshou_tpu_torch.evaluation import rliable_evaluation as tre
from tianshou_tpu_torch.evaluation.launcher import PoolExpLauncher, SequentialExpLauncher, run_seeded_experiments
from tianshou_tpu_torch.highlevel.config import ExperimentConfig, OnPolicyTrainingConfig
from tianshou_tpu_torch.highlevel.experiment import ReinforceExperimentBuilder
from tianshou_tpu_torch.utils.logger.tensorboard import TensorboardLogger

SCORES = {
    "outlier": np.array([1.0, 2.0, 3.0, 4.0, 100.0]),
    "five_seeds": np.array([10.0, 12.0, 11.0, 9.0, 13.0]),
    "uniform": np.random.default_rng(3).uniform(-50, 200, size=(7, 4)),
}


@pytest.mark.parametrize("name", list(SCORES))
def test_statistics_are_bit_equal_to_jax(name):
    scores = SCORES[name]
    assert tre.iqm(scores) == jre.iqm(scores)
    runs = scores[:, None] if scores.ndim == 1 else scores  # runs on axis 0
    for seed in (0, 5):
        got = tre.stratified_bootstrap_ci(runs, n_boot=300, seed=seed)
        assert got == jre.stratified_bootstrap_ci(runs, n_boot=300, seed=seed)
    flat = scores.reshape(-1)
    assert dataclasses.asdict(tre.eval_results(flat, n_boot=200)) == dataclasses.asdict(jre.eval_results(flat, n_boot=200))


def _write_runs(logger_cls, root) -> list[str]:
    dirs = []
    for seed in range(3):
        d = str(root / f"run{seed}")
        lg = logger_cls(log_dir=d, test_interval=1)
        for i, step in enumerate([0, 100, 200, 300]):
            lg.write("test/env_step", step, {"test/reward": float(seed + i * 10) + 0.25 * seed * i})
        lg.writer.close()  # the accumulator reads closed event files
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_and_eval_experiments_matches_jax(tmp_path, writer):
    dirs = _write_runs(JTensorboardLogger if writer == "jax" else TensorboardLogger, tmp_path)
    got, want = tre.load_and_eval_experiments(dirs, n_boot=200), jre.load_and_eval_experiments(dirs, n_boot=200)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(got[4]) == dataclasses.asdict(want[4])
    grid, iqm_c, lo, hi, summary = got
    assert len(grid) == 4 and np.all(np.diff(iqm_c) > 0)
    assert summary.n_runs == 3 and lo[-1] <= summary.iqm <= hi[-1] + 1e-9
    out = str(tmp_path / "curve.png")
    tre.plot_iqm_curve(grid, iqm_c, lo, hi, title="t", out_path=out)
    assert os.path.getsize(out) > 0


def test_from_log_dir_needs_test_returns(tmp_path):
    lg = TensorboardLogger(log_dir=str(tmp_path), test_interval=1)
    lg.write("train/env_step", 0, {"train/loss": 1.0})
    lg.writer.close()
    with pytest.raises(ValueError, match="no test-return scalars"):
        tre.LoggedCollectStats.from_log_dir(str(tmp_path))


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------
def _builder(seed: int, env_factory=CartPole):
    return ReinforceExperimentBuilder(
        env_factory, ExperimentConfig(seed=seed, persistence_enabled=False),
        OnPolicyTrainingConfig(max_epochs=1, epoch_num_steps=1024, num_train_envs=8, num_test_envs=4,
                               test_step_num_episodes=2))


def _broken_env():
    raise RuntimeError("this env cannot be made")


def _summary(result) -> tuple:
    params = [p.detach().cpu() for p in result.train_state.model.parameters()]
    return result.best_reward, result.env_step, result.gradient_step, params


def _same(a, b) -> bool:
    return a[:3] == b[:3] and all(torch.equal(x, y) for x, y in zip(a[3], b[3]))


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    root = tmp_path_factory.mktemp("seeds")
    return root, run_seeded_experiments(_builder, seeds=[0, 1], run_name=str(root / "rs"), device="cpu")


def test_run_seeded_experiments_equals_run_per_seed(sequential):
    root, res = sequential
    assert [name for name, _ in res.successes] == [str(root / "rs/seed0"), str(root / "rs/seed1")]
    assert not res.failures
    for seed, (name, result) in enumerate(res.successes):
        assert _same(_summary(result), _summary(_builder(seed).build().run(name, device="cpu")))
    summary = tre.eval_results(np.array([r.best_reward for _, r in res.successes]), n_boot=100)
    assert summary.n_runs == 2


def test_a_failing_experiment_is_reported_and_the_rest_run():
    res = SequentialExpLauncher(device="cpu").launch([(_builder(0, _broken_env).build(), "broken"),
                                                       (_builder(0).build(), "fine")])
    assert [n for n, _ in res.successes] == ["fine"]
    (name, tb), = res.failures
    assert name == "broken" and "this env cannot be made" in tb


def test_pool_launcher_under_spawn_gives_the_sequential_results(sequential):
    _, seq = sequential
    exps = [(_builder(s).build(), name) for s, (name, _) in enumerate(seq.successes)]
    exps.append((_builder(0, functools.partial(lambda: CartPole())).build(), "lambda"))
    res = PoolExpLauncher(max_workers=2, device="cpu").launch(exps)
    assert [n for n, _ in res.successes] == [n for n, _ in seq.successes]
    for (_, got), (_, want) in zip(res.successes, seq.successes):
        assert _same(_summary(got), _summary(want))
    (name, tb), = res.failures
    assert name == "lambda" and "pickle" in tb.lower()
