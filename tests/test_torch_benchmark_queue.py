"""``examples_torch/benchmark/seed_queue.py``, the seed-run queue, on a queue under ``tmp_path`` on the CPU.

One run of the queue through ``main`` (the jobs processed in sorted order, each claimed by a rename into
``running/`` and run in a fresh ``--run-one`` subprocess) over five job files: a script job (``psrl.py``'s
``train`` for seeds 0 and 1, with a ``CurveLogger``: one JSONL row per seed with its curve), a ``"vmap"`` job
(``seed_vmap.py``'s ``run_multiseed`` over seeds 3 and 4 at a tiny size: a row per seed), a ``"cmd"`` job (its output
in ``<name>.log`` beside the results), a job that fails (into ``failed/`` with its traceback beside it), and a job left
in ``running/`` by a dead runner (recovered first, then run). The results lie outside the repo, so nothing is
committed, and no test writes into the repo. The queue's defaults are ``examples_torch/benchmark/queue`` and
``.../results/seed_runs.jsonl``; the JAX rounds' ``examples/benchmark/queue`` and ``results`` are not read.
"""

import json

from examples_torch.benchmark import seed_queue
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

TINY_VMAP = dict(algo="sac", task="HalfCheetah", seeds=[3, 4], epochs=1, epoch_num_steps=4, num_envs=2, chunk_len=2,
                 start_steps=4, test_episodes=2, buffer_size=64, batch_size=4,
                 env_overrides={"max_episode_steps": 4}, verbose=False)


def _write(path, job):
    path.write_text(json.dumps(job))


def test_the_queue_runs_every_kind_of_job(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the jobs' own processes, beside the other test workers
    queue, results = tmp_path / "queue", tmp_path / "results" / "seed_runs.jsonl"
    (queue / "running").mkdir(parents=True)
    _write(queue / "a_script.json", {"name": "psrl_nchain", "script": "examples_torch/modelbased/psrl.py",
                                     "kwargs": {"epochs": 1, "epoch_num_steps": 200, "verbose": False},
                                     "seeds": [0, 1]})
    _write(queue / "b_vmap.json", {"name": "sac_vmap", "vmap": TINY_VMAP})
    _write(queue / "c_cmd.json", {"name": "hello", "cmd": ["-c", "print('hello from the queue')"]})
    _write(queue / "d_fails.json", {"name": "broken", "cmd": ["-c", "raise SystemExit(3)"]})
    _write(queue / "running" / "e_orphan.json", {"name": "orphan", "cmd": ["-c", "print('recovered')"]})

    seed_queue.main(["--queue", str(queue), "--results", str(results), "--idle-timeout", "0", "--poll", "0.01",
                     "--device", "cpu"])

    out = capsys.readouterr().out
    assert "recovering orphaned e_orphan.json" in out and "queue idle, exiting" in out
    assert sorted(p.name for p in (queue / "done").iterdir()) == ["a_script.json", "b_vmap.json", "c_cmd.json",
                                                                   "e_orphan.json"]
    assert sorted(p.name for p in (queue / "failed").iterdir()) == ["d_fails.json", "d_fails.traceback.txt"]
    assert "CalledProcessError" in (queue / "failed" / "d_fails.traceback.txt").read_text()
    assert not list((queue / "running").iterdir()) and not list(queue.glob("*.json"))
    assert (results.parent / "hello.log").read_text() == "hello from the queue\n"
    assert (results.parent / "orphan.log").read_text() == "recovered\n"

    rows = [json.loads(line) for line in results.read_text().splitlines()]
    assert [(r["name"], r["seed"]) for r in rows] == [("psrl_nchain", 0), ("psrl_nchain", 1), ("sac_vmap", 3),
                                                      ("sac_vmap", 4)]
    for r in rows[:2]:  # a script job's row: its train's result and the CurveLogger's curve
        assert r["env_step"] > 0 and r["kwargs"]["epochs"] == 1 and len(r["curve"]) == 1
        assert r["steps_per_s"] > 0
    for r in rows[2:]:  # a vmap job's row: run_multiseed's result dict
        assert r["env_step"] == 8 and len(r["curve"]) == 1 and r["agent_steps_per_s"] > 0
    assert all(isinstance(r["best_reward"], float) for r in rows)


def test_results_outside_the_repo_are_not_committed(tmp_path, monkeypatch):
    """``_commit_results`` runs ``git`` only for a results file inside the repo."""
    calls = []
    monkeypatch.setattr(seed_queue.subprocess, "run", lambda *a, **k: calls.append(a))
    seed_queue._commit_results(tmp_path / "seed_runs.jsonl", "job")
    assert calls == []
    assert seed_queue.build_parser().parse_args([]).queue == "examples_torch/benchmark/queue"
