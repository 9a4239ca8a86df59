"""The port stands alone: no module of ``tianshou_tpu_torch``, nor
``chip_smoke.py``, ``scripts/torch_port_profile.py`` or
``scripts/seed_spread.py``, imports ``jax``,
``flax``, ``optax`` or the JAX package ``tianshou_tpu`` (read from each
file's syntax tree, imports inside functions included). Nor do they import
``cloudpickle``, ``gymnasium``, ``pettingzoo``, ``h5py``, TensorBoard or
``matplotlib``, which a GPU host need not have, apart from the functions of
``LAZY``, which import one when they are called; ``chip_smoke.py`` imports
none of them, nor ``tensorboardX`` or ``wandb``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "tianshou_tpu_torch").rglob("*.py"))
FILES += ["chip_smoke.py", "scripts/torch_port_profile.py", "scripts/seed_spread.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "tianshou_tpu"}
HOST_BANNED = {"cloudpickle", "gymnasium", "gym", "pettingzoo", "h5py", "tensorboard", "matplotlib"}
#: functions that import a host-only library when called: {file: {function name: the libraries}}
LAZY = {
    "tianshou_tpu_torch/env/atari.py": {"make_atari_env": {"gymnasium"}},
    "tianshou_tpu_torch/env/pettingzoo_env.py": {"__init__": {"pettingzoo"}},
    "tianshou_tpu_torch/evaluation/rliable_evaluation.py": {"from_log_dir": {"tensorboard"},
                                                           "plot_iqm_curve": {"matplotlib"}},
    "tianshou_tpu_torch/highlevel/env.py": {"_make": {"gymnasium"}, "make": {"gymnasium"}},
    "tianshou_tpu_torch/highlevel/experiment.py": {"save": {"cloudpickle"}},
    "tianshou_tpu_torch/utils/logger/tensorboard.py": {"restore_logged_data": {"tensorboard"}},
    "tianshou_tpu_torch/utils/persistence.py": {name: {"h5py"} for name in (
        "_read_tree", "save_buffer_hdf5", "load_buffer_hdf5", "load_d4rl_hdf5")},
}


def imported_roots(source: str) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax(path):
    assert not imported_roots((ROOT / path).read_text()) & BANNED


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_gymnasium_or_cloudpickle(path):
    tree = ast.parse((ROOT / path).read_text())
    lazy = LAZY.get(path, {})
    funcs = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name in lazy]
    assert {n.name for n in funcs} == set(lazy)
    for fn in funcs:  # each imports its library when it is called
        assert imported_roots(ast.unparse(fn)) & HOST_BANNED == lazy[fn.name], fn.name
    for fn in funcs:
        fn.body = [ast.Pass()]
    assert not imported_roots(ast.unparse(tree)) & HOST_BANNED


def test_chip_smoke_imports_no_host_only_library():
    """The card's machine has none of these: the script imports none, lazily or not."""
    banned = HOST_BANNED | {"tensorboardX", "wandb"}
    assert not imported_roots((ROOT / "chip_smoke.py").read_text()) & banned


def test_the_check_sees_imports():
    assert imported_roots("import jax.numpy as jnp\nfrom tianshou_tpu.data import batch\n") == {"jax", "tianshou_tpu"}
    assert imported_roots("def f():\n    from optax import adam\n") == {"optax"}
    assert imported_roots("from tianshou_tpu_torch.data import batch\nfrom . import x\n") == {"tianshou_tpu_torch"}
