"""Launch counters of the hand-written kernels, one per kernel name.

A wrapper adds one where it launches its kernel and nowhere else. Under a
CUDA graph (:mod:`tianshou_tpu_torch.utils.graph`) a wrapper runs once while
the graph is captured, and nothing launches then; the graph helper takes the
increments of the capture back out (:func:`snapshot` / :func:`restore`) and
adds them again on every replay (:func:`add_all`), so that a counter always
counts device launches.
"""

from __future__ import annotations

__all__ = ["add", "add_all", "get", "reset", "restore", "snapshot"]

_counts: dict[str, int] = {}


def add(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def get(name: str) -> int:
    return _counts.get(name, 0)


def reset(*names: str) -> None:
    for name in names:
        _counts[name] = 0


def snapshot() -> dict[str, int]:
    return dict(_counts)


def restore(counts: dict[str, int]) -> None:
    _counts.clear()
    _counts.update(counts)


def add_all(counts: dict[str, int]) -> None:
    for name, n in counts.items():
        add(name, n)
