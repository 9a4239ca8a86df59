"""The port's ``examples_torch/benchmark/`` scripts against the JAX package's ``examples/benchmark/`` on the CPU:
what each builds, and each through its own ``main`` (or ``train``) at a tiny size. ``seed_vmap.py``'s programs and
``seed_queue.py`` have files of their own (``tests/test_torch_benchmark_{seed_vmap,queue}.py``); the options of
every script are held by ``tests/test_torch_examples_cli.py``.

- What each builds, held as ``tests/test_torch_examples_builders.py`` holds the example scripts (the algorithm's
  class and hyper-parameters, its optimizers, its nets' fields and sizes, the ring, the env counts, the trainer's
  parameters): ``seed_vmap.py``'s four factories with ``ALGOS`` and ``START_STEPS`` and ``run_multiseed``'s
  defaults; ``throughput.py``'s PPO, ``T``, ``REPEAT``, ``BATCH`` and its numbers of envs (read from the JAX
  script's syntax tree, where they live inside its ``__main__`` block); ``offpolicy_throughput.py``'s DQN, ring,
  collectors and trainer parameters; ``host_throughput.py``'s DQN; ``host_overlap.py``'s SAC and the arguments it
  hands ``run_offpolicy_host``; ``run_benchmark.py``'s ``SUITES`` (the same scripts' twins, the same tasks). A JAX
  script runs until it has built what is compared (its trainer's, collector's or ``init``'s constructor patched
  to stop it), or is imported without running its ``__main__`` block.
- Runs at a tiny size: ``throughput.py`` over two small numbers of envs, ``offpolicy_throughput.py`` at 16 envs
  (both modes, the timed run's own env and gradient steps), ``host_throughput.py`` over two Subproc workers of
  Gymnasium's CartPole and of ``chip_smoke.py``'s numpy CartPole (the card's run), ``host_overlap.py`` on
  Gymnasium's ``Reacher-v4`` (three JSONL rows, written under ``tmp_path``), ``run_benchmark.py`` over one cell of
  its ``classic`` suite (``dqn_cartpole.py`` for one epoch in a subprocess, its summary under ``tmp_path``).
"""

import ast
import importlib.util
import inspect
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from examples_torch.benchmark import host_overlap, host_throughput, offpolicy_throughput, run_benchmark, seed_vmap
from examples_torch.benchmark import throughput
from tests.test_torch_examples_builders import assert_same_buffer, assert_same_net_fields, assert_same_nets
from tests.test_torch_highlevel import assert_same_hyperparameters, assert_same_trainer_params
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX_BENCH = REPO / "examples" / "benchmark"


class _Captured(Exception):
    pass


def _capture(monkeypatch, owner, name: str):
    """Patch ``owner.name`` to raise ``_Captured`` with its arguments."""
    def record(*args, **kwargs):
        raise _Captured(args, kwargs)

    monkeypatch.setattr(owner, name, record)


def _run_jax_main(name: str, monkeypatch) -> tuple:
    """Run ``examples/benchmark/<name>.py`` as ``__main__`` until a patched constructor stops it."""
    path = JAX_BENCH / f"{name}.py"
    monkeypatch.setattr(sys, "argv", [str(path)])
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script puts the repo root on it
    with pytest.raises(_Captured) as got:
        runpy.run_path(str(path), run_name="__main__")
    return got.value.args


def _load_jax(name: str, monkeypatch):
    """``examples/benchmark/<name>.py`` imported as a module (its ``__main__`` block does not run)."""
    monkeypatch.setattr(sys, "path", list(sys.path))  # the scripts put folders on it
    spec = importlib.util.spec_from_file_location(f"jax_benchmark_{name}", JAX_BENCH / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_algorithm(jalgo, talgo, obs_dim: int):
    assert_same_hyperparameters(jalgo, talgo)
    assert_same_net_fields(jalgo, talgo)
    jts = jax.eval_shape(lambda k: jalgo.init(k, jnp.zeros(obs_dim)), jax.random.key(0))
    assert_same_nets(jts, talgo.init("cpu"))


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()}


# ---------------------------------------------------------------------------
# what each builds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sac", "td3", "ddpg", "redq"])
def test_seed_vmap_builds_the_jax_algorithms(name, monkeypatch):
    from tianshou_tpu.env.mujoco import make as jmake
    from tianshou_tpu_torch.env.mujoco import make

    jsv = _load_jax("seed_vmap", monkeypatch)
    assert seed_vmap.START_STEPS == jsv.START_STEPS and seed_vmap.ALGOS.keys() == jsv.ALGOS.keys()
    assert _defaults(seed_vmap.run_multiseed) == {**_defaults(jsv.run_multiseed), "device": None}
    _same_algorithm(jsv.ALGOS[name](jmake("HalfCheetah")), seed_vmap.ALGOS[name](make("HalfCheetah")), 17)


def _main_block_constants(name: str) -> dict:
    """The literal assignments and ``for`` tuples inside the JAX script's ``if __name__ == "__main__":`` block."""
    tree = ast.parse((JAX_BENCH / f"{name}.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.If) and "__main__" in ast.unparse(n.test))
    found = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], (ast.Tuple, ast.Name)):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            names = [t.id for t in getattr(node.targets[0], "elts", [node.targets[0]])]
            found.update(zip(names, value if len(names) > 1 else [value]))
        elif isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            try:
                found[f"for {node.target.id}"] = ast.literal_eval(node.iter)
            except ValueError:
                pass
    return found


def test_throughput_builds_the_jax_ppo_and_sweep(monkeypatch):
    import tianshou_tpu.data.collector as jcollector
    from tianshou_tpu_torch.env.classic.cartpole import CartPole

    consts = _main_block_constants("throughput")
    assert (consts["T"], consts["REPEAT"], consts["BATCH"]) == (throughput.T, throughput.REPEAT, throughput.BATCH)
    assert consts["for E"] == throughput.ENVS
    assert consts["iters"] == throughput.ITERS and throughput.WARMUP == 2  # the JAX script's 2 warm-up megasteps
    _capture(monkeypatch, jcollector.DeviceCollector, "__init__")
    (_, venv, jalgo, buffer), _ = _run_jax_main("throughput", monkeypatch)
    assert venv.num_envs == throughput.ENVS[0] and buffer is None
    _same_algorithm(jalgo, throughput.make_algo(CartPole()), 4)


def test_offpolicy_throughput_builds_the_jax_trainer(monkeypatch):
    import tianshou_tpu.trainer.trainer as jtrainer
    import tianshou_tpu_torch.trainer.trainer as ttrainer

    consts = _main_block_constants("offpolicy_throughput")
    assert (consts["E"], consts["T"]) == (offpolicy_throughput.E, offpolicy_throughput.T)
    _capture(monkeypatch, jtrainer.OffPolicyTrainer, "__init__")
    (_, jalgo, jtrain, jtest, jbuf, jparams), _ = _run_jax_main("offpolicy_throughput", monkeypatch)
    _capture(monkeypatch, ttrainer.OffPolicyTrainer, "__init__")
    with pytest.raises(_Captured) as got:
        offpolicy_throughput.main(["--device", "cpu"])
    (_, talgo, ttrain, ttest, tbuf, tparams), _ = got.value.args
    _same_algorithm(jalgo, talgo, 4)
    assert_same_buffer(jbuf, tbuf)
    assert (ttrain.venv.num_envs, ttest.venv.num_envs) == (jtrain.venv.num_envs, jtest.venv.num_envs) == (1024, 8)
    assert ttest.buffer is None and jtest.buffer is None
    assert_same_trainer_params(tparams, jparams)
    assert tparams.fused_megastep is False  # the first mode
    assert tparams.epoch_num_steps == 32 * 1024 * offpolicy_throughput.TIMED_CHUNKS


def test_host_throughput_builds_the_jax_dqn(monkeypatch):
    from tianshou_tpu.algorithm.modelfree.dqn import DQN as JDQN

    _capture(monkeypatch, JDQN, "init")
    (jalgo, *_), _ = _run_jax_main("host_throughput", monkeypatch)
    monkeypatch.undo()  # init compared below
    _same_algorithm(jalgo, host_throughput.make_algo(), 4)


def test_host_overlap_hands_run_offpolicy_host_the_jax_arguments(monkeypatch):
    import types

    import examples_torch.mujoco._runner as trunner
    from tianshou_tpu.env.mujoco import make as jmake
    from tianshou_tpu_torch.env.mujoco import make

    jho = _load_jax("host_overlap", monkeypatch)
    assert _defaults(host_overlap.train) == {**_defaults(jho.train), "device": None}
    stub = types.ModuleType("_runner")
    stub.run_offpolicy_host = lambda *a, **k: (_ for _ in ()).throw(_Captured(a, k))
    monkeypatch.setitem(sys.modules, "_runner", stub)  # the JAX script imports its sibling by bare name
    args = ("overlap", "HalfCheetah", 3, 64, 2, 8, 1.0, 16, 32)
    with pytest.raises(_Captured) as jgot:
        jho._one(*args)
    _capture(monkeypatch, trunner, "run_offpolicy_host")
    with pytest.raises(_Captured) as tgot:
        host_overlap._one(*args)
    (jmake_algo, *jpos), jkw = jgot.value.args
    (tmake_algo, *tpos), tkw = tgot.value.args
    assert tpos == jpos and tkw == {**jkw, "device": None}
    assert (tkw["pipelined"], tkw["overlap"]) == (True, True)
    _same_algorithm(jmake_algo(jmake("HalfCheetah")), tmake_algo(make("HalfCheetah")), 17)


def test_run_benchmark_suites_name_the_twins_of_the_jax_scripts(monkeypatch):
    jrb = _load_jax("run_benchmark", monkeypatch)
    assert run_benchmark.SUITES.keys() == jrb.SUITES.keys()
    for name, suite in jrb.SUITES.items():
        port = run_benchmark.SUITES[name]
        assert port["tasks"] == suite["tasks"]
        assert port["scripts"] == ["examples_torch/" + s.removeprefix("examples/") for s in suite["scripts"]]
        for script in port["scripts"]:  # each takes the options the run matrix hands it
            module = importlib.import_module(script.removesuffix(".py").replace("/", "."))
            argv = ["--seed", "1", "--device", "cpu", "--epochs", "2"]
            args = vars(module.build_parser().parse_args(argv + (["--task", "Hopper"] if suite["tasks"][0] else [])))
            assert (args["seed"], args["device"], args["epochs"]) == (1, "cpu", 2)
    assert run_benchmark._BEST.pattern == jrb._BEST.pattern


# ---------------------------------------------------------------------------
# runs at a tiny size
# ---------------------------------------------------------------------------
def test_throughput_sweeps_through_its_main(monkeypatch, capsys):
    for name, value in dict(ENVS=(8, 16), T=4, BATCH=16, ITERS=1).items():
        monkeypatch.setattr(throughput, name, value)
    rates = throughput.main(["--device", "cpu"])
    assert list(rates) == [8, 16] and all(np.isfinite(r) and r > 0 for r in rates.values())
    assert "E=    8:" in capsys.readouterr().out


def test_offpolicy_throughput_runs_both_modes_through_its_main(monkeypatch):
    for name, value in dict(E=16, T=4, TIMED_CHUNKS=2).items():
        monkeypatch.setattr(offpolicy_throughput, name, value)
    out = offpolicy_throughput.main(["--device", "cpu"])
    assert list(out) == [False, True]
    for run in out.values():  # 2 timed chunks of 4 x 16 steps, one update each (max(1, round(0.01 * 64)))
        assert (run["env_steps"], run["gradient_steps"]) == (128, 2) and run["env_steps_per_s"] > 0


def test_host_throughput_runs_both_collectors(capsys):
    import chip_smoke
    from tianshou_tpu_torch.data.host_collector import HostCollector
    from tianshou_tpu_torch.data.pipelined_collector import PipelinedHostCollector
    from tianshou_tpu_torch.env.venvs import SubprocVectorEnv

    pytest.importorskip("gymnasium")
    out = host_throughput.main(["--device", "cpu", "--n-envs", "2", "--n-step", "40", "--env-ms", "1"])
    assert set(out) == {"sequential", "pipelined"} and all(r > 0 for r in out.values())
    assert "speedup:" in capsys.readouterr().out
    algo = host_throughput.make_algo()
    ts = algo.init("cpu")
    for cls in (HostCollector, PipelinedHostCollector):  # the card's run: numpy CartPole workers
        venv = SubprocVectorEnv([lambda: host_throughput.SleepyCartPole(1.0, chip_smoke.NumpyCartPole())] * 2)
        try:
            assert host_throughput.run(cls, venv, algo, ts, 40, "cpu") > 0
        finally:
            venv.close()


def test_host_overlap_trains_in_three_modes(monkeypatch, tmp_path):
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")
    monkeypatch.setattr(host_overlap, "RESULTS", tmp_path / "results" / "host_overlap.jsonl")
    res = host_overlap.train(task="Reacher", epoch_num_steps=32, num_envs=2, chunk_len=8, batch_size=8,
                             start_steps=16, device="cpu")
    rows = [json.loads(line) for line in host_overlap.RESULTS.read_text().splitlines()]
    assert [r["mode"] for r in rows] == ["sync", "pipelined", "overlap"]
    assert all(r["env_step"] == 48 and np.isfinite(r["best_reward"]) and r["train_steps_per_s"] > 0 for r in rows)
    assert np.isfinite(res.best_reward) and res.env_step == 48


def test_run_benchmark_runs_one_cell(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(run_benchmark, "POLL_S", 0.2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the cell's own process, beside the other test workers
    results = run_benchmark.main(["--suite", "classic", "--seeds", "0", "--epochs", "1", "--device", "cpu",
                                  "--log-dir", str(tmp_path)])
    assert list(results) == ["dqn_cartpole_s0"] and np.isfinite(results["dqn_cartpole_s0"])
    assert json.loads((tmp_path / "summary.json").read_text()) == results
    assert "best_reward=" in (tmp_path / "dqn_cartpole_s0.log").read_text()
    assert "done dqn_cartpole_s0" in capsys.readouterr().out
