"""The port's example scripts (``examples_torch/``) against the JAX package's
(``examples/``): their command lines, their imports and the Atari catch game.

- CLI parity, one case per ported script (every script of ``examples/``): the namespace the JAX script's own
  parser gives for no arguments (its ``__main__`` run by ``runpy`` while
  ``argparse.ArgumentParser.parse_args`` is patched here to record
  ``parse_args([])`` and stop) against the port's ``build_parser()``: the same
  keys and values, and ``device`` (default ``cuda``) as the only extra key;
  ``PORT_DEFAULTS`` names the values where the port's default is its own
  (``seed_queue.py``'s queue and results, the port's, not the JAX rounds').
  A JAX script without a parser gets a port parser of ``device`` alone.
- No file under ``examples_torch/`` imports ``jax``, ``flax``, ``optax``,
  ``tianshou_tpu`` or anything of ``examples/``.
- ``SyntheticAtari``, the catch game of ``examples/atari/_runner.py``, under
  ``FrameStack(·, 4)`` in both packages over a scripted 250-step trajectory
  of 3 envs (the 200-step truncation and a reset inside it): the draws of the
  JAX keys (columns at reset, the next ball at a catch) handed over to the
  port's ``reset_from`` / ``step_from``; frames, rewards, terminations and
  truncations bit-equal.
"""

import argparse
import ast
import importlib
import importlib.util
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
JAX_EXAMPLES = REPO / "examples"
PORT = REPO / "examples_torch"

#: the JAX example scripts the port has, relative to examples/
SCRIPTS = (
    [f"atari/atari_{a}.py" for a in ("dqn", "c51", "qrdqn", "iqn", "fqf", "rainbow", "sac", "ppo")]
    + [f"mujoco/mujoco_{a}.py" for a in ("sac", "td3", "ppo", "ddpg", "redq", "reinforce", "a2c", "npg", "trpo")]
    + [f"mujoco/mujoco_{a}_hl.py" for a in ("sac", "td3", "ppo", "ddpg", "redq", "reinforce", "a2c", "npg", "trpo")]
    + ["mujoco/goal_her_ddpg.py", "mujoco/plotter.py", "discrete/dqn_cartpole.py", "discrete/ppo_cartpole_hl.py",
       "continuous/sac_pendulum.py", "continuous/ddpg_her_goalreach.py"]
    + [f"offline/{s}.py" for s in ("cql_pendulum", "td3_bc_pendulum", "bcq_pendulum", "il_pendulum",
                                   "discrete_bcq_cartpole", "discrete_cql_cartpole", "discrete_crr_cartpole", "d4rl_bcq")]
    + ["inverse/irl_gail.py", "modelbased/psrl.py", "marl/tictactoe_selfplay.py", "marl/pettingzoo_tictactoe_dqn.py"]
    + [f"box2d/{s}.py" for s in ("acrobot_dualdqn", "mcc_sac", "lunarlander_dqn", "bipedal_sac", "bipedal_bdq")]
    + ["vizdoom/vizdoom_c51.py", "vizdoom/vizdoom_ppo.py"]
    + [f"benchmark/{s}.py" for s in ("seed_vmap", "seed_queue", "run_benchmark", "throughput", "offpolicy_throughput",
                                     "host_throughput", "host_overlap")]
)
#: the folders of examples/ that the port mirrors
FOLDERS = ("atari", "mujoco", "discrete", "continuous", "offline", "inverse", "modelbased", "marl", "box2d", "vizdoom",
           "benchmark")
#: the command line both parsers see where ``[]`` would not parse (a required positional)
ARGV = {"mujoco/plotter.py": ["log/seed0"]}
#: the port's own defaults where the JAX script's name the JAX rounds' records: {script: {key: the port's value}}
PORT_DEFAULTS = {"benchmark/seed_queue.py": {"queue": "examples_torch/benchmark/queue",
                                             "results": "examples_torch/benchmark/results/seed_runs.jsonl"}}
#: scripts that run nothing on a device, and so take no --device
HOST_ONLY = {"mujoco/plotter.py"}
#: the JAX examples' sibling modules, imported by bare name from the script's folder
SIBLINGS = ("_runner", "_hl", "_gather", "env")


def port_module(rel: str):
    return importlib.import_module("examples_torch." + rel.removesuffix(".py").replace("/", "."))


class _Parsed(Exception):
    pass


def jax_namespace(rel: str, monkeypatch) -> dict | None:
    """The JAX script's parsed defaults, or None where it has no parser."""
    path = JAX_EXAMPLES / rel
    if "parse_args" not in path.read_text():
        return None
    parse = argparse.ArgumentParser.parse_args

    def record(self, args=None, namespace=None):
        raise _Parsed(parse(self, ARGV.get(rel, []), namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    monkeypatch.setattr(sys, "argv", [str(path)])
    monkeypatch.syspath_prepend(str(path.parent))
    for name in SIBLINGS:
        monkeypatch.delitem(sys.modules, name, raising=False)
    try:
        with pytest.raises(_Parsed) as parsed:
            runpy.run_path(str(path), run_name="__main__")
    finally:
        for name in SIBLINGS:  # the next script's sibling of the same name is another file
            sys.modules.pop(name, None)
    return vars(parsed.value.args[0])


def test_the_slice_covers_every_script_of_its_groups():
    folders = {p.name for p in JAX_EXAMPLES.iterdir() if p.is_dir() and not p.name.startswith(("_", "."))}
    assert folders - set(FOLDERS) == set()
    for folder in FOLDERS:
        jax_scripts = {f"{folder}/{p.name}" for p in (JAX_EXAMPLES / folder).glob("*.py")
                       if not p.name.startswith("_") and p.stem not in SIBLINGS}
        assert jax_scripts <= set(SCRIPTS), jax_scripts - set(SCRIPTS)
    for rel in SCRIPTS:
        assert (PORT / rel).is_file(), rel
    for folder in FOLDERS:
        for sibling in (JAX_EXAMPLES / folder).glob("*.py"):
            if sibling.name.startswith("_") or sibling.stem in SIBLINGS:
                assert (PORT / folder / sibling.name).is_file(), sibling


@pytest.mark.parametrize("rel", SCRIPTS)
def test_the_port_parser_gives_the_jax_defaults(rel, monkeypatch):
    port = port_module(rel)
    assert callable(port.main)
    got = vars(port.build_parser().parse_args(ARGV.get(rel, [])))
    want = jax_namespace(rel, monkeypatch)
    if want is None:
        assert got == {"device": "cuda"}, rel
        return
    extra = set(got) - set(want)
    assert extra == (set() if rel in HOST_ONLY else {"device"}), (rel, extra)
    assert set(want) <= set(got), (rel, set(want) - set(got))
    want.update(PORT_DEFAULTS.get(rel, {}))
    for key, value in want.items():
        assert got[key] == value and type(got[key]) is type(value), (rel, key, got[key], value)
    if rel not in HOST_ONLY:
        assert got["device"] == "cuda"


def _imported_modules(source: Path | ast.Module) -> list[str]:
    names = []
    tree = source if isinstance(source, ast.Module) else ast.parse(source.read_text(), str(source))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__", "run_path", "run_module"):
            names += [a.value for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    return names


def test_no_port_example_imports_jax_or_the_jax_package():
    forbidden = {"jax", "flax", "optax", "tianshou_tpu", "examples", *SIBLINGS}
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= len(SCRIPTS)
    for path in files:
        for name in _imported_modules(path):
            root = name.split(".")[0]
            assert not name.startswith(".") and root not in forbidden, (path.relative_to(REPO), name)


def test_every_port_example_imports_where_gymnasium_and_its_kin_are_absent():
    """The card's machine has no ``gymnasium``, ``pettingzoo``, ``h5py`` or ``matplotlib``: a port example imports
    them only inside the functions that need them, so that every script imports there (and raises a clear
    ``ImportError`` only when such a function runs)."""
    host_only = {"gymnasium", "gym", "pettingzoo", "h5py", "matplotlib", "tensorboard", "cloudpickle", "Box2D"}
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        top = [n for n in tree.body if not isinstance(n, (ast.FunctionDef, ast.ClassDef))]
        for name in _imported_modules(ast.Module(body=top, type_ignores=[])):
            assert name.split(".")[0] not in host_only, (path.relative_to(REPO), name)


def test_a_script_runs_as_a_file_and_refuses_a_missing_gpu(monkeypatch, capsys):
    """Run as a file (``__package__`` empty: the script puts the repo root on the path itself), and ``--device``
    left at ``cuda`` without a GPU raises."""
    script = PORT / "atari" / "atari_rainbow.py"
    monkeypatch.setattr(sys, "argv", [str(script), "--help"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(script), run_name="__main__")
    assert done.value.code == 0 and "--device" in capsys.readouterr().out
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_module("atari/atari_rainbow.py").main([])


# ---------------------------------------------------------------------------
# the catch game
# ---------------------------------------------------------------------------
E, STEPS, COLS = 3, 250, 21


def _jax_runner():
    spec = importlib.util.spec_from_file_location("jax_examples_atari_runner", JAX_EXAMPLES / "atari" / "_runner.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Handed:
    """The port's catch game with the draws handed over: ``reset`` and ``step`` pop them from queues."""

    def __init__(self, game):
        self.game, self.resets, self.balls = game, [], []
        self.observation_space, self.action_space = game.observation_space, game.action_space
        self.max_episode_steps = game.max_episode_steps

    def reset(self, num_envs, generator, device):
        return self.game.reset_from(*self.resets.pop(0))

    def step(self, state, action, generator):
        return self.game.step_from(state, action, self.balls.pop(0))


def test_the_catch_game_is_bit_equal_to_jax():
    from examples_torch.atari._runner import FRAME, STACK, SyntheticAtari
    from tianshou_tpu.env.wrappers import FrameStack as JFrameStack
    from tianshou_tpu_torch.env.wrappers import FrameStack

    jr = _jax_runner()
    jenv = JFrameStack(jr.SyntheticAtari(), STACK)
    assert jr.FRAME == FRAME and jr.STACK == STACK
    game = SyntheticAtari()
    handed = _Handed(game)
    tenv = FrameStack(handed, STACK)
    assert tuple(game.observation_space.shape) == jr.SyntheticAtari().observation_space.shape
    assert game.action_space.n == 3 and (game.cols, game.max_episode_steps) == (COLS, 200)
    jreset, jstep = jax.jit(jax.vmap(jenv.reset)), jax.jit(jax.vmap(jenv.step))
    draw = jax.jit(jax.vmap(lambda k: jax.random.randint(k, (), 0, COLS)))

    def reset(key):
        keys = jax.random.split(key, E)
        kb_kp = jax.vmap(jax.random.split)(keys)  # SyntheticAtari.reset: kb, kp = split(key)
        handed.resets.append(tuple(torch.from_numpy(np.array(draw(kb_kp[:, i]))) for i in (1, 0)))
        return jreset(keys), tenv.reset(E, None, "cpu")

    (js, jobs), (ts, tobs) = reset(jax.random.key(0))
    rng = np.random.default_rng(0)
    frames = rewards = resets = 0
    for t in range(STEPS):
        # the port's device FrameStack stacks on the axis after the env axis, as the JAX one does on the
        # axis after its vmapped one: [E, 4, 84, 84, 1] both, compared without an axis move
        assert tuple(tobs.shape) == (E, STACK, *FRAME) == jobs.shape
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        frames += 1
        act = rng.integers(0, 3, E)
        keys = jax.random.split(jax.random.key(t + 1), E)
        handed.balls.append(torch.from_numpy(np.array(draw(keys))))
        jout = jstep(js, jnp.asarray(act, jnp.int32), keys)
        tout = tenv.step(ts, torch.from_numpy(act), None)
        np.testing.assert_array_equal(tout.obs.numpy(), np.asarray(jout.obs))
        np.testing.assert_array_equal(tout.reward.numpy(), np.asarray(jout.reward))
        assert tout.reward.dtype == torch.float32
        np.testing.assert_array_equal(tout.terminated.numpy(), np.asarray(jout.terminated))
        np.testing.assert_array_equal(tout.truncated.numpy(), np.asarray(jout.truncated))
        rewards += int((np.asarray(jout.reward) != 0).sum())
        (js, jobs), (ts, tobs) = (jout.state, jout.obs), (tout.state, tout.obs)
        if bool(np.asarray(jout.truncated).all()):
            (js, jobs), (ts, tobs) = reset(jax.random.key(1000 + t))
            resets += 1
    assert frames == STEPS and resets == 1 and rewards == E * (200 // 40 + 50 // 40)
    assert not handed.resets and not handed.balls
