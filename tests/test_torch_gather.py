"""Parity of the port's replay row gather (tianshou_tpu_torch/ops/kernels/gather.py)
with the JAX package's (tianshou_tpu/ops/pallas/gather.py).

On the CPU the port's wrapper runs its plain version and the JAX side runs
``gather_rows_auto``, as the JAX package's own CPU tests do. A gather is a
pure copy, so every comparison is bit-exact. The CUDA kernel itself is held
against the plain version by ``tests/test_torch_cuda.py``, which skips
without a GPU, and by ``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.ops.pallas.gather import gather_rows_auto
from tianshou_tpu_torch.ops.kernels import gather as tg


def _src(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(dtype)


CASES = [
    # (src shape, dtype, number of rows gathered)
    ((64, 7056), np.uint8, 128),   # the 84*84*1 frame row of the replay ring
    ((1024, 5), np.float32, 300),
    ((513, 3), np.uint8, 1000),
    ((256, 128), np.int32, 17),
    # row widths around the kernel's 16-byte chunk and its block of 256 threads x 2 chunks
    ((50, 16), np.uint8, 40),
    ((50, 2032), np.uint8, 40),
    ((50, 2064), np.uint8, 40),
    ((50, 7057), np.uint8, 40),
    ((50, 8192 + 16), np.uint8, 40),
]


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape,dtype,rows", CASES)
def test_gather_rows_matches_jax_bit_exact(shape, dtype, rows, idx_dtype):
    rng = np.random.default_rng(0)
    src = _src(rng, shape, dtype)
    idx = rng.integers(0, shape[0], rows).astype(idx_dtype)
    want = np.asarray(gather_rows_auto(jnp.asarray(src), jnp.asarray(idx)))
    got = tg.gather_rows(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_rows_repeated_and_clamped_indices_match_jax():
    rng = np.random.default_rng(1)
    src = _src(rng, (40, 7056), np.uint8)
    # repeats, both ends, and indices past the end (JAX's src[idx] clamps them)
    idx = np.array([5, 5, 5, 0, 39, 39, 40, 1000, 7, 5], np.int64)
    want = np.asarray(gather_rows_auto(jnp.asarray(src), jnp.asarray(idx)))
    got = tg.gather_rows(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_rows_clamps_negative_indices_to_row_zero():
    src = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    out = tg.gather_rows(src, torch.tensor([-1, -100, 2]))
    torch.testing.assert_close(out, src[[0, 0, 2]], rtol=0, atol=0)


def test_gather_rows_cpu_uses_plain_version_and_counts_no_launch():
    tg.reset_launch_count()
    tg.gather_rows(torch.zeros(8, 16, dtype=torch.uint8), torch.tensor([1, 2]))
    assert tg.launch_count() == 0


@pytest.mark.parametrize(
    "src,idx,err",
    [
        (torch.zeros(2, 3, 4), torch.tensor([0]), ValueError),
        (torch.zeros(2, 3), torch.tensor([[0]]), ValueError),
        (torch.zeros(2, 3), torch.tensor([0.0]), TypeError),
        (torch.zeros(0, 3), torch.tensor([0]), ValueError),
    ],
)
def test_gather_rows_rejects_bad_arguments(src, idx, err):
    with pytest.raises(err):
        tg.gather_rows(src, idx)


def test_empty_launch_needs_the_built_library():
    import shutil

    if shutil.which("nvcc") or torch.cuda.is_available():
        pytest.skip("a machine with the CUDA toolkit builds the library")
    with pytest.raises(RuntimeError, match="nvcc"):
        tg.launch_noop(128, 256)
