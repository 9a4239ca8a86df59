"""Benchmark-suite orchestration (reference benchmark/run_benchmark.py), the port of
``examples/benchmark/run_benchmark.py``.

The reference farms its example scripts out to tmux sessions with a concurrency cap and polls for completion.
Same shape here with plain subprocesses: a run matrix of (script, task, seed) cells over the port's example
scripts, a concurrency cap (default 1: one card serializes anyway; raise it for CPU runs or more cards), per-run
logs, and a JSON summary of best rewards. ``--device`` is handed to every script.

    python examples_torch/benchmark/run_benchmark.py --suite mujoco --seeds 0 1 2
    python examples_torch/benchmark/run_benchmark.py --suite mujoco --tasks Hopper Walker2d --epochs 5
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SUITES = {
    "mujoco": {
        "scripts": ["examples_torch/mujoco/mujoco_sac.py", "examples_torch/mujoco/mujoco_td3.py",
                    "examples_torch/mujoco/mujoco_ppo.py"],
        "tasks": ["HalfCheetah", "Hopper", "Walker2d", "Ant"],
    },
    "classic": {
        "scripts": ["examples_torch/discrete/dqn_cartpole.py"],
        "tasks": [None],
    },
}
#: seconds between two looks at the running cells
POLL_S = 5.0

_BEST = re.compile(r"best_reward=([-\d.]+)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", choices=sorted(SUITES), default="mujoco")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--tasks", nargs="+", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--max-concurrent", type=int, default=1)
    ap.add_argument("--log-dir", default="log/benchmark")
    ap.add_argument("--device", default="cuda", help="handed to every script: cuda (the default) or cpu")
    return ap


def main(argv=None) -> dict[str, float | None]:
    args = build_parser().parse_args(argv)

    suite = SUITES[args.suite]
    tasks = args.tasks or suite["tasks"]
    log_dir = Path(args.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)

    cells = [
        (script, task, seed)
        for script in suite["scripts"]
        for task in tasks
        for seed in args.seeds
    ]
    print(f"{len(cells)} runs, max {args.max_concurrent} concurrent", flush=True)

    running: list[tuple[subprocess.Popen, Path, str]] = []
    results: dict[str, float | None] = {}

    def drain(block: bool) -> None:
        while running and (block or len(running) >= args.max_concurrent):
            for item in list(running):
                proc, log, name = item
                if proc.poll() is None:
                    continue
                running.remove(item)
                text = log.read_text()
                m = _BEST.findall(text)
                results[name] = float(m[-1]) if m else None
                status = "ok" if proc.returncode == 0 else f"rc={proc.returncode}"
                print(f"  done {name}: best={results[name]} ({status})", flush=True)
            if running and (block or len(running) >= args.max_concurrent):
                time.sleep(POLL_S)

    for script, task, seed in cells:
        drain(block=False)
        name = f"{Path(script).stem}" + (f"_{task}" if task else "") + f"_s{seed}"
        log = log_dir / f"{name}.log"
        cmd = [sys.executable, str(ROOT / script), "--seed", str(seed), "--device", args.device]
        if task:
            cmd += ["--task", task]
        if args.epochs:
            cmd += ["--epochs", str(args.epochs)]
        print(f"  launch {name}", flush=True)
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT)
        running.append((proc, log, name))

    drain(block=True)
    summary = log_dir / "summary.json"
    summary.write_text(json.dumps(results, indent=2))
    print(f"summary -> {summary}", flush=True)
    return results


if __name__ == "__main__":
    main()
