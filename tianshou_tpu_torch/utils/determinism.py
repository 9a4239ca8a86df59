"""Determinism tracing and regression testing (port of
``tianshou_tpu/utils/determinism.py``; reference tianshou/utils/determinism.py).

``TraceLogger`` (reference :57) is a global, opt-in buffer of lazily
formatted lines; ``TraceLoggerContext`` switches it on for a block;
``trace_param_hash`` (reference ``torch_param_hash`` :233) hashes a train
state's weights; ``TraceDeterminismTest`` (:250) compares a trace with a
stored snapshot and prints the lines that differ.

On the card a run is repeatable when it replays the same kernels on the same
generator state: the trainer's programs are CUDA graphs, and cuDNN may be held
to deterministic algorithms (``chip_smoke.py``'s determinism phase says which
settings it uses).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from collections.abc import Callable

__all__ = ["TraceLogger", "TraceLoggerContext", "trace_param_hash", "TraceDeterminismTest"]


class TraceLogger:
    """Global, opt-in trace buffer. A message is a callable, evaluated only
    when tracing is on (reference TraceLogger:57)."""

    enabled: bool = False
    _lines: list[str] = []

    @classmethod
    def log(cls, source: str, msg_fn: Callable[[], str]) -> None:
        if cls.enabled:
            cls._lines.append(f"{source}: {msg_fn()}")

    @classmethod
    def get_trace(cls) -> list[str]:
        return list(cls._lines)

    @classmethod
    def reset(cls) -> None:
        cls._lines = []


class TraceLoggerContext:
    def __enter__(self):
        TraceLogger.reset()
        TraceLogger.enabled = True
        return TraceLogger

    def __exit__(self, *exc):
        TraceLogger.enabled = False
        return False


def trace_param_hash(ts) -> str:
    """SHA1 over a train state's weights: the ``state_dict()`` of ``ts.model``
    and then of ``ts.target`` (where there is one), each in key order, over
    every key and every tensor's bytes on the CPU. Equal weights give equal
    hashes across runs and devices."""
    h = hashlib.sha1()
    for module in (ts.model, ts.target):
        if module is None:
            continue
        for k, v in module.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class TraceDeterminismTest:
    """Compare a behavior trace against a stored snapshot
    (reference TraceDeterminismTest:250)."""

    base_path: str

    def check(self, name: str, trace: list[str], create_if_missing: bool = True) -> None:
        os.makedirs(self.base_path, exist_ok=True)
        path = os.path.join(self.base_path, f"{name}.trace")
        text = "\n".join(trace)
        if not os.path.exists(path):
            if create_if_missing:
                with open(path, "w") as f:
                    f.write(text)
                return
            raise FileNotFoundError(path)
        with open(path) as f:
            expected = f.read()
        if expected != text:
            exp_lines = expected.splitlines()
            got_lines = text.splitlines()
            diffs = [
                f"line {i}: expected {e!r} got {g!r}"
                for i, (e, g) in enumerate(zip(exp_lines, got_lines))
                if e != g
            ]
            if len(exp_lines) != len(got_lines):
                diffs.append(f"length mismatch: {len(exp_lines)} vs {len(got_lines)}")
            raise AssertionError("determinism trace mismatch:\n" + "\n".join(diffs[:20]))
