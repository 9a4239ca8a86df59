"""Robust multi-seed evaluation (port of
``tianshou_tpu/evaluation/rliable_evaluation.py``; reference
tianshou/evaluation/rliable_evaluation.py).

The reference delegates to the ``rliable`` package (IQM and stratified
bootstrap confidence intervals). As in the JAX package, the statistics are
written with numpy and draw from ``np.random.default_rng(seed)``, so the two
packages give the same bits for the same scores and seed. TensorBoard and
matplotlib are imported by the two functions that use them, when called.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "iqm", "stratified_bootstrap_ci", "eval_results", "RunSummary",
    "LoggedCollectStats", "load_and_eval_experiments", "plot_iqm_curve",
]

#: scalar tags that hold an experiment's test returns
RETURN_TAGS = ("test/returns_stat/mean", "test/reward")


def iqm(scores: np.ndarray) -> float:
    """Interquartile mean over the flattened score set."""
    x = np.sort(np.asarray(scores).ravel())
    n = len(x)
    lo, hi = int(np.floor(n * 0.25)), int(np.ceil(n * 0.75))
    return float(x[lo:hi].mean()) if hi > lo else float(x.mean())


def stratified_bootstrap_ci(
    scores: np.ndarray,
    statistic=iqm,
    n_boot: int = 2000,
    ci: float = 0.95,
    seed: int = 0,
) -> tuple[float, float]:
    """Percentile interval of ``statistic`` over runs resampled with
    replacement (axis 0 holds the runs; docs/04_benchmarks: 5 seeds, IQM, 95% CI)."""
    scores = np.atleast_2d(np.asarray(scores))
    n_runs = scores.shape[0]
    rng = np.random.default_rng(seed)
    stats = np.empty(n_boot)
    for b in range(n_boot):
        idx = rng.integers(0, n_runs, size=n_runs)
        stats[b] = statistic(scores[idx])
    alpha = (1.0 - ci) / 2.0
    return float(np.quantile(stats, alpha)), float(np.quantile(stats, 1 - alpha))


@dataclasses.dataclass
class RunSummary:
    iqm: float
    mean: float
    median: float
    ci_low: float
    ci_high: float
    n_runs: int


def eval_results(score_per_run: np.ndarray, n_boot: int = 2000) -> RunSummary:
    """Aggregate the final scores of N seeded runs (reference eval_results:442)."""
    s = np.asarray(score_per_run, np.float64)
    lo, hi = stratified_bootstrap_ci(s[:, None], n_boot=n_boot)
    return RunSummary(
        iqm=iqm(s),
        mean=float(s.mean()),
        median=float(np.median(s)),
        ci_low=lo,
        ci_high=hi,
        n_runs=len(s),
    )


@dataclasses.dataclass
class LoggedCollectStats:
    """Test-return curve of one experiment read back from its event files
    (reference rliable_evaluation.py:53 LoggedCollectStats.from_data_dict)."""

    env_steps: np.ndarray          # [T]
    returns: np.ndarray            # [T]

    @staticmethod
    def from_log_dir(log_dir: str) -> "LoggedCollectStats":
        # the event files are read directly: a TensorboardLogger made here would
        # add a fresh, empty event file, and the accumulator would then drop the
        # run's own events as those of a restarted run
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(log_dir)
        acc.Reload()
        data = {
            tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags().get("scalars", [])
        }
        key = next((k for k in data if k.endswith(RETURN_TAGS)), None)
        if key is None:
            raise ValueError(f"no test-return scalars found in {log_dir}: {sorted(data)}")
        steps, vals = zip(*data[key])
        return LoggedCollectStats(np.asarray(steps), np.asarray(vals))


def load_and_eval_experiments(log_dirs, n_boot: int = 2000):
    """Aggregate seeded runs from their TensorBoard logs: the IQM curve with
    its stratified bootstrap band (reference load_and_eval_experiment:442).

    Returns ``(steps [T], iqm [T], lo [T], hi [T], RunSummary of the final
    scores)``; each curve is interpolated onto the first run's steps.
    """
    curves = [LoggedCollectStats.from_log_dir(d) for d in log_dirs]
    grid = curves[0].env_steps.astype(np.float64)
    mat = np.stack([
        np.interp(grid, c.env_steps.astype(np.float64), c.returns) for c in curves
    ])  # [n_runs, T]
    iqm_curve = np.array([iqm(mat[:, t]) for t in range(mat.shape[1])])
    lo = np.empty_like(iqm_curve)
    hi = np.empty_like(iqm_curve)
    for t in range(mat.shape[1]):
        lo[t], hi[t] = stratified_bootstrap_ci(mat[:, t][:, None], n_boot=max(200, n_boot // 10))
    summary = eval_results(mat[:, -1], n_boot=n_boot)
    return grid, iqm_curve, lo, hi, summary


def plot_iqm_curve(grid, iqm_curve, lo, hi, title: str = "", out_path: str | None = None):
    """Learning curve with its bootstrap band (the reference's rliable
    sample-efficiency plot), saved to ``out_path`` when one is given."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(grid, iqm_curve, label="IQM")
    ax.fill_between(grid, lo, hi, alpha=0.25, label="95% CI")
    ax.set_xlabel("env steps")
    ax.set_ylabel("test return")
    if title:
        ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path, dpi=120)
    return fig
