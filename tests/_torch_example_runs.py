"""Running a port example script through its own ``main`` on the CPU at a tiny size.

A script runs as ``main(["--device", "cpu", *argv])`` with the smallest options it takes. Where a script has no
option for a size that its run would spend minutes on at its default (an epoch, a prefill, a collect's length,
an episode's), the run cuts that size in the trainer it builds (:class:`Cut`: the trainer's params replaced at
construction), in a helper the script calls (``partials``: ``module.name`` bound to smaller keywords, as
``chip_smoke.py`` binds a script's ``train``) or in a class attribute (``sets``). Every cut is a size, never a
setting the script compares or a branch it takes.

Every run's test phases step the device collector in chunks of :data:`TEST_CHUNK` steps, where the collector's
default is 128: the test phase of an env whose episodes end early then stops early (a vector step of the physics
takes tens of milliseconds on the CPU).

A run passes when it ends with finite weights on the CPU and a finite test return: every test phase a trainer
ran returned finite rewards, and the run's best reward is finite.
"""

from __future__ import annotations

import functools
import importlib
import math
from typing import Any, NamedTuple

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_examples_cli import port_module


#: the test phase's chunk on the device collector (``DeviceCollector.collect_episodes``' ``chunk_steps``)
TEST_CHUNK = 16


class Cut(NamedTuple):
    """What one script's run takes: its arguments after ``--device cpu``; the trainer fields set at construction
    where the script has no option for them; ``{"module:attr": keywords}`` helpers bound to smaller sizes;
    ``{"module:Class.attr": value}`` attributes set; the packages beyond the port's own it needs (the run skips,
    naming the package, where one is absent)."""

    argv: tuple[str, ...] = ()
    trainer: dict[str, Any] = {}
    partials: dict[str, dict[str, Any]] = {}
    sets: dict[str, Any] = {}
    needs: tuple[str, ...] = ()


class Recorded(NamedTuple):
    result: Any
    trainers: list
    tests: list


def run_main(rel: str, cut: Cut, monkeypatch) -> Recorded:
    """``main(["--device", "cpu", *cut.argv])`` of ``examples_torch/<rel>`` with ``cut`` applied, recording the
    trainers it builds and their test phases' stats (``chip_smoke._Recording``, as the card's runs record them)."""
    from tianshou_tpu_torch.data.collector import DeviceCollector

    for package in cut.needs:
        pytest.importorskip(package)
    monkeypatch.setattr(DeviceCollector, "collect_episodes",
                        functools.partialmethod(DeviceCollector.collect_episodes, chunk_steps=TEST_CHUNK))
    for where, keywords in cut.partials.items():
        module, attr = where.split(":")
        owner = importlib.import_module(module)
        monkeypatch.setattr(owner, attr, functools.partial(getattr(owner, attr), **keywords))
    for where, value in cut.sets.items():
        module, path = where.split(":")
        *owners, attr = path.split(".")
        owner = functools.reduce(getattr, owners, importlib.import_module(module))
        monkeypatch.setattr(owner, attr, value)
    with chip_smoke._Recording(cut.trainer) as rec:
        result = port_module(rel).main(["--device", "cpu", *cut.argv])
    return Recorded(result, rec.trainers, rec.tests)


def assert_finite_run(rec: Recorded) -> None:
    """Finite weights on the CPU, a test phase with finite returns, and a finite best reward."""
    res = rec.result
    tensors = chip_smoke._ex_weights(torch, res)
    assert tensors, "no float tensor in the train state"
    assert all(t.device.type == "cpu" and bool(torch.isfinite(t).all()) for t in tensors)
    assert rec.tests, "no test phase ran"
    for stats in rec.tests:
        returns = np.asarray(stats.returns)
        assert returns.size > 0 and np.isfinite(returns).all(), returns
    assert math.isfinite(res.best_reward), res.best_reward
