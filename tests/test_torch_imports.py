"""The port stands alone: no module of ``tianshou_tpu_torch``, nor
``chip_smoke.py``, ``scripts/torch_port_profile.py`` or
``scripts/seed_spread.py``, imports ``jax``,
``flax``, ``optax`` or the JAX package ``tianshou_tpu`` (read from each
file's syntax tree, imports inside functions included). Nor do they import
``cloudpickle`` or ``gymnasium``, which a GPU host need not have, apart from
the lazy ``gymnasium`` import of ``env/atari.py:make_atari_env``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "tianshou_tpu_torch").rglob("*.py"))
FILES += ["chip_smoke.py", "scripts/torch_port_profile.py", "scripts/seed_spread.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "tianshou_tpu"}
HOST_BANNED = {"cloudpickle", "gymnasium", "gym"}


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
    if path == "tianshou_tpu_torch/env/atari.py":  # make_atari_env imports gymnasium when it is called
        make = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_atari_env")
        assert imported_roots(ast.unparse(make)) == {"gymnasium"}
        tree.body.remove(make)
    assert not imported_roots(ast.unparse(tree)) & HOST_BANNED


def test_the_check_sees_imports():
    assert imported_roots("import jax.numpy as jnp\nfrom tianshou_tpu.data import batch\n") == {"jax", "tianshou_tpu"}
    assert imported_roots("def f():\n    from optax import adam\n") == {"optax"}
    assert imported_roots("from tianshou_tpu_torch.data import batch\nfrom . import x\n") == {"tianshou_tpu_torch"}
