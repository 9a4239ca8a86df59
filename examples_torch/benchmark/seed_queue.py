"""Sequential seed-run queue for the single-card benchmark protocol, the port of
``examples/benchmark/seed_queue.py``.

The reference's table protocol is multi-seed (max test return per trial, aggregated across trials,
examples/mujoco/README.md:444 of the reference). This runner drains job files from a queue directory one at a time
(device runs serialize through the one card anyway), so that long multi-seed sweeps can run unattended while jobs
can be enqueued mid-flight.

Job file format (JSON, one job per file, processed in sorted order)::

    {"name": "td3_HalfCheetah",
     "script": "examples_torch/mujoco/mujoco_td3.py",
     "kwargs": {"task": "HalfCheetah", "epochs": 50, "epoch_num_steps": 20000},
     "seeds": [1, 2]}

Each seed calls the script's ``train(seed=s, device=..., **kwargs)`` (with a ``CurveLogger`` where ``train`` takes a
logger) and appends one line to the results JSONL. A job with ``"vmap"`` (``{"algo", "task", "seeds", ...}``) runs
``seed_vmap.py``'s ``run_multiseed`` over all its seeds at once; one with ``"cmd"`` runs ``python <cmd...>`` from
the repo root, its output in ``<name>.log`` beside the results. Each job runs in a fresh subprocess (``--run-one``)
with its ``"timeout"``. Completed job files move to ``<queue>/done/``; failed ones to ``<queue>/failed/`` with the
traceback beside them. The results file is committed to git after each seed when it lies inside the repo.

Usage::

    python examples_torch/benchmark/seed_queue.py \\
        --queue examples_torch/benchmark/queue \\
        --results examples_torch/benchmark/results/seed_runs.jsonl \\
        --idle-timeout 900 [--device cpu]
"""

if __package__ in (None, ""):  # run as a file: put the repo root on the path
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import argparse
import importlib
import inspect
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

_REPO = Path(__file__).resolve().parents[2]


def _load_train(script: str):
    """The ``train`` of a port script named by its path from the repo root (``examples_torch/<dir>/<name>.py``)."""
    module = script.removesuffix(".py").replace("/", ".")
    return importlib.import_module(module).train


def _commit_results(results_path: Path, name: str) -> None:
    """Commit the results JSONL after every seed, when it lies inside the repo: raw rows must never exist only on
    an ephemeral machine."""
    results_path = results_path.resolve()
    if not results_path.is_relative_to(_REPO):
        return
    try:
        rel = results_path.relative_to(_REPO)
        subprocess.run(["git", "add", str(rel)], cwd=_REPO, check=True)
        # the pathspec limits the commit to the results file: an unattended runner must never sweep up unrelated
        # staged work
        r = subprocess.run(
            ["git", "commit", "-m", f"Record seed-run rows: {name}", "--", str(rel)],
            cwd=_REPO, capture_output=True, text=True,
        )
        if r.returncode == 0:
            print(f"[seed_queue] committed results for {name}", flush=True)
        elif "nothing to commit" not in r.stdout + r.stderr:
            print(f"[seed_queue] WARNING: results commit for {name} failed "
                  f"(rc={r.returncode}): {r.stderr.strip() or r.stdout.strip()}", flush=True)
    except Exception as e:  # never let bookkeeping kill a run
        print(f"[seed_queue] results commit failed: {e}", flush=True)


def _append(results_path: Path, row: dict) -> None:
    with results_path.open("a") as f:
        f.write(json.dumps(row) + "\n")


def _run_job(job: dict, results_path: Path, device: str) -> None:
    if "cmd" in job:
        # an arbitrary script job (benchmarks, profilers) as a subprocess, so that its state cannot leak into
        # queued training jobs; its output lands next to the results file
        log = results_path.parent / (job["name"] + ".log")
        with log.open("w") as f:
            subprocess.run([sys.executable, *job["cmd"]], cwd=_REPO, stdout=f, stderr=subprocess.STDOUT,
                           check=True, timeout=job.get("timeout", 7200))
        print(f"[seed_queue] cmd job {job['name']} done -> {log}", flush=True)
        return
    if "vmap" in job:
        # a seed-stacked multi-seed run (see seed_vmap.py): all seeds train at once
        from examples_torch.benchmark.seed_vmap import run_multiseed

        spec = dict(job["vmap"])
        spec.setdefault("device", device)
        results = run_multiseed(spec.pop("algo"), spec.pop("task"), spec.pop("seeds"), **spec)
        for r in results:
            row = {"name": job["name"], **{k: v for k, v in r.items() if k != "curve"},
                   "curve": r["curve"], "finished_at": time.strftime("%Y-%m-%dT%H:%M:%S")}
            _append(results_path, row)
            print(f"[seed_queue] {job['name']} seed={r['seed']}: best={r['best_reward']:.1f}", flush=True)
            # commit per seed: a crash mid-job must not lose rows
            _commit_results(results_path, f"{job['name']} seed={r['seed']}")
        return
    train = _load_train(job["script"])
    kwargs = dict(job.get("kwargs", {}))
    takes_logger = "logger" in inspect.signature(train).parameters
    for seed in job["seeds"]:
        # the test-return learning curve, so that the rows feed the rliable IQM/CI curve plots, as the vmap jobs
        # record theirs
        logger = None
        if takes_logger:
            from tianshou_tpu_torch.utils.logger.base import CurveLogger

            logger = CurveLogger()
        t0 = time.time()
        result = train(seed=seed, **({"logger": logger} if logger else {}), **{"device": device, **kwargs})
        dt = time.time() - t0
        row = {
            "name": job["name"],
            "seed": seed,
            "best_reward": float(result.best_reward),
            "env_step": int(result.env_step),
            "steps_per_s": round(int(result.env_step) / max(dt, 1e-9), 1),
            "wall_s": round(dt, 1),
            "kwargs": kwargs,
            "finished_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        if logger is not None and logger.curve:
            row["curve"] = logger.curve
        _append(results_path, row)
        print(f"[seed_queue] {job['name']} seed={seed}: "
              f"best={row['best_reward']:.1f} ({row['steps_per_s']:,.0f} steps/s)", flush=True)
        # commit per seed: a crash mid-job must not lose rows
        _commit_results(results_path, f"{job['name']} seed={seed}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--queue", default="examples_torch/benchmark/queue")
    p.add_argument("--results", default="examples_torch/benchmark/results/seed_runs.jsonl")
    p.add_argument("--idle-timeout", type=float, default=900.0,
                   help="exit after the queue has been empty this long (s)")
    p.add_argument("--poll", type=float, default=15.0)
    p.add_argument("--run-one", default=None,
                   help="(internal) execute this one job file and exit")
    p.add_argument("--device", default="cuda", help="the jobs' device: cuda (the default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    if args.run_one:
        jobfile = Path(args.run_one)
        _run_job(json.loads(jobfile.read_text()), _REPO / args.results, args.device)
        return

    qdir = _REPO / args.queue
    done = qdir / "done"
    failed = qdir / "failed"
    running = qdir / "running"
    for d in (qdir, done, failed, running):
        d.mkdir(parents=True, exist_ok=True)
    results_path = _REPO / args.results
    results_path.parent.mkdir(parents=True, exist_ok=True)

    # recover jobs orphaned in running/ by a dead runner (a machine reset mid-job)
    for f in sorted(running.glob("*.json")):
        print(f"[seed_queue] recovering orphaned {f.name}", flush=True)
        f.rename(qdir / f.name)

    idle_since = time.time()
    while True:
        pending = sorted(f for f in qdir.glob("*.json"))
        if not pending:
            if time.time() - idle_since > args.idle_timeout:
                print("[seed_queue] queue idle, exiting", flush=True)
                return
            time.sleep(args.poll)
            continue
        idle_since = time.time()
        # claim BEFORE executing: the rename is atomic, so two concurrent runners can never both run a job
        try:
            jobfile = running / pending[0].name
            pending[0].rename(jobfile)
        except FileNotFoundError:
            continue  # another runner claimed it between glob and rename
        try:
            job = json.loads(jobfile.read_text())
            seeds = job.get("seeds") or job.get("vmap", {}).get("seeds")
            print(f"[seed_queue] start {jobfile.name}: {job['name']} seeds={seeds}", flush=True)
            # each job runs in a fresh subprocess, so that edits to the framework land on the next job without
            # restarting the queue runner and one job's state cannot leak into the next; the timeout guards
            # against a job that hangs
            subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--run-one", str(jobfile),
                 "--results", args.results, "--device", args.device],
                check=True,
                timeout=job.get("timeout", 5400),
            )
            jobfile.rename(done / jobfile.name)
        except Exception:
            tb = traceback.format_exc()
            print(f"[seed_queue] FAILED {jobfile.name}\n{tb}", flush=True)
            (failed / (jobfile.stem + ".traceback.txt")).write_text(tb)
            jobfile.rename(failed / jobfile.name)
        idle_since = time.time()


if __name__ == "__main__":
    main()
