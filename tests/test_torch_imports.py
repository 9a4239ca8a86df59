"""The port stands alone: no module of ``tianshou_tpu_torch``, nor
``chip_smoke.py`` or ``scripts/torch_port_profile.py``, imports ``jax``,
``flax``, ``optax`` or the JAX package ``tianshou_tpu`` (read from each
file's syntax tree, imports inside functions included)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "tianshou_tpu_torch").rglob("*.py"))
FILES += ["chip_smoke.py", "scripts/torch_port_profile.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "tianshou_tpu"}


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


def test_the_check_sees_imports():
    assert imported_roots("import jax.numpy as jnp\nfrom tianshou_tpu.data import batch\n") == {"jax", "tianshou_tpu"}
    assert imported_roots("def f():\n    from optax import adam\n") == {"optax"}
    assert imported_roots("from tianshou_tpu_torch.data import batch\nfrom . import x\n") == {"tianshou_tpu_torch"}
