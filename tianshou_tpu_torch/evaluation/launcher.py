"""Experiment launchers (port of ``tianshou_tpu/evaluation/launcher.py``;
reference tianshou/evaluation/launcher.py:36-147): ``SequentialExpLauncher``
and a process-pool launcher in place of ``JoblibExpLauncher``. A failing
experiment is caught and reported with its traceback, and the others run on
(launcher.py:64-85).

Every launcher takes a ``device`` (``None``: the card, as
``Experiment.run`` defaults) and passes it to ``exp.run(name, device=...)``.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import pickle
import traceback
from collections.abc import Callable, Sequence
from concurrent.futures import ProcessPoolExecutor
from typing import Any

import torch

__all__ = ["LaunchResult", "ExpLauncher", "SequentialExpLauncher", "PoolExpLauncher", "run_seeded_experiments"]


@dataclasses.dataclass
class LaunchResult:
    successes: list  # (name, TrainResult)
    failures: list   # (name, traceback text)


class ExpLauncher:
    def __init__(self, device: str | torch.device | None = None) -> None:
        self.device = device

    def launch(self, experiments: Sequence[tuple[Any, str]]) -> LaunchResult:
        raise NotImplementedError


def _run_one(exp, name: str, device) -> tuple[str, str, Any]:
    try:
        return ("ok", name, exp.run(name, device=device))
    except Exception:
        return ("err", name, traceback.format_exc())


class SequentialExpLauncher(ExpLauncher):
    def launch(self, experiments: Sequence[tuple[Any, str]]) -> LaunchResult:
        ok, bad = [], []
        for exp, name in experiments:
            status, name, payload = _run_one(exp, name, self.device)
            (ok if status == "ok" else bad).append((name, payload))
        return LaunchResult(ok, bad)


class PoolExpLauncher(ExpLauncher):
    """Process-parallel launcher (reference JoblibExpLauncher:117).

    The workers are started with ``spawn``: a child forked from a parent
    that has used CUDA cannot use CUDA. Each experiment is pickled to its
    worker, so its env and model factories must be module-level callables
    (a class, a module function, a ``functools.partial`` of one), not
    lambdas or closures; an experiment that does not pickle is reported as
    that experiment's failure. Every worker runs on ``device``: on one card
    the experiments share it."""

    def __init__(self, max_workers: int = 2, device: str | torch.device | None = None) -> None:
        super().__init__(device)
        self.max_workers = max_workers

    def launch(self, experiments: Sequence[tuple[Any, str]]) -> LaunchResult:
        ok, bad, jobs = [], [], []
        for exp, name in experiments:
            try:
                jobs.append((pickle.dumps(exp), name))
            except Exception:
                bad.append((name, traceback.format_exc()))
        if jobs:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=min(self.max_workers, len(jobs)), mp_context=ctx) as ex:
                for blob in ex.map(_run_pickled, jobs, [self.device] * len(jobs)):
                    status, name, payload = pickle.loads(blob)
                    (ok if status == "ok" else bad).append((name, payload))
        return LaunchResult(ok, bad)


def _run_pickled(job: tuple[bytes, str], device) -> bytes:
    """A pool worker's run, its outcome pickled by value: a device tensor
    crosses as its bytes, not as a handle into the worker's memory, which
    ends with the worker. A result that cannot be pickled is that
    experiment's failure."""
    blob, name = job
    try:
        return pickle.dumps(_run_one(pickle.loads(blob), name, device))
    except Exception:
        return pickle.dumps(("err", name, traceback.format_exc()))


def run_seeded_experiments(builder_fn: Callable[[int], Any], seeds: Sequence[int], run_name: str,
                           device: str | torch.device | None = None) -> LaunchResult:
    """Build one experiment per seed and run them in turn on ``device`` (the
    multi-seed evaluation entry point of the rliable aggregation)."""
    exps = [(builder_fn(s).build(), f"{run_name}/seed{s}") for s in seeds]
    return SequentialExpLauncher(device).launch(exps)
