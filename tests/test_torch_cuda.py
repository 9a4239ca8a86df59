"""Tests of the port's CUDA kernels that need the card; they skip without one.

This file imports only torch and the port (no JAX), so that it also runs on a
GPU machine without JAX, where the repo's ``tests/conftest.py`` (which imports
JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from tianshou_tpu_torch.ops.kernels import gather as tg


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("shape,dtype,rows", [((4096, 7056), torch.uint8, 128), ((1024, 5), torch.float32, 300),
                                              ((513, 3), torch.uint8, 1000)])
def test_gather_rows_kernel_bit_exact_on_cuda(shape, dtype, rows, idx_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    if dtype == torch.uint8:
        src = torch.randint(0, 256, shape, dtype=dtype, device="cuda", generator=g)
    else:
        src = torch.randn(shape, dtype=dtype, device="cuda", generator=g)
    idx = torch.randint(-2, shape[0] + 2, (rows,), device="cuda", generator=g).to(idx_dtype)
    before = tg.launch_count()
    out = tg.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert tg.launch_count() == before + 1
    assert torch.equal(out, tg.gather_rows_reference(src, idx))
