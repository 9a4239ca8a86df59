"""Tests of the port's CUDA kernels that need the card; they skip without one.

This file imports only torch and the port (no JAX), so that it also runs on a
GPU machine without JAX, where the repo's ``tests/conftest.py`` (which imports
JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from tianshou_tpu_torch.ops.kernels import gather as tg
from tianshou_tpu_torch.ops.kernels import sumtree as tsum
from tianshou_tpu_torch.ops.segtree import SegmentTree


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


@pytest.mark.cuda
@pytest.mark.parametrize("size,batch", [(131072, 32), (131072, 4096), (100000, 32), (16384, 257), (5, 64), (1, 7)])
def test_prefix_sum_idx_kernel_exact_on_cuda(size, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    st = SegmentTree(size)
    vals = torch.rand(size, device="cuda", generator=g)
    vals[torch.randint(0, size, (size // 4,), device="cuda", generator=g)] = 0.0  # zero-priority leaves
    # duplicate and dropped indices go through update's last-write-wins path
    idx = torch.cat([torch.arange(size, device="cuda"), torch.tensor([0, -1, size, 0], device="cuda")])
    tree = st.update(st.init("cuda"), idx, torch.cat([vals, torch.tensor([9.0, 9.0, 9.0, 0.5], device="cuda")]))
    total = st.total(tree)
    cum = torch.cumsum(tree[st.bound:st.bound + min(size, 64)], 0)  # values equal to a prefix sum go left
    q = torch.cat([torch.rand(batch, device="cuda", generator=g) * total, cum,
                   torch.stack([total, total * 2, total * 0, -total])])
    before = tsum.launch_count()
    out = st.get_prefix_sum_idx(tree, q)
    torch.cuda.synchronize()
    assert tsum.launch_count() == before + 1
    assert out.dtype == torch.int64 and out.device.type == "cuda"
    assert torch.equal(out, tsum.prefix_sum_idx_reference(tree, q, st.bound, st.depth, st.size))
    assert int(out.min()) >= 0 and int(out.max()) <= size - 1


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["HalfCheetah", "Ant"])
@pytest.mark.parametrize("num_envs", [6, 2053])
def test_fused_step_kernel_matches_plain_version_on_cuda(task, num_envs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    env = make(task)
    model = env.model
    g = torch.Generator(device="cuda").manual_seed(0)
    home = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda")
    q = home + 0.03 * torch.randn(num_envs, model.nq, device="cuda", generator=g)
    qd = 0.05 * torch.randn(num_envs, model.nq, device="cuda", generator=g)
    ctrl = torch.rand(num_envs, len(model.actuators), device="cuda", generator=g) * 2 - 1
    before = pf.launch_count()
    q_new, qd_new = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    torch.cuda.synchronize()
    assert pf.launch_count() == before + 1
    q_ref, qd_ref = pf.fused_step_reference(model, q, qd, ctrl, frame_skip=env.frame_skip)
    assert pf.launch_count() == before + 1  # the plain version launches nothing
    # the tolerances the JAX package holds its fused step to; near home every env is inside
    torch.testing.assert_close(q_new, q_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(qd_new, qd_ref, rtol=5e-3, atol=5e-3)


@pytest.mark.cuda
def test_mujoco_env_step_launches_the_kernel_once_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tianshou_tpu_torch.env.core import VectorDeviceEnv
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    g = torch.Generator(device="cuda").manual_seed(0)
    outs = {}
    for mode in ("auto", "fused", "plain"):
        venv = VectorDeviceEnv(make("Hopper", physics_mode=mode), 64, device="cuda")
        g.manual_seed(0)
        state, _ = venv.reset(g)
        before = pf.launch_count()
        outs[mode] = venv.step(state, venv.action_space.sample(64, g, venv.device), g)
        assert pf.launch_count() == before + (mode != "plain")
    assert torch.equal(outs["auto"].state.q, outs["fused"].state.q)
    torch.testing.assert_close(outs["auto"].state.q, outs["plain"].state.q, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(outs["auto"].reward, outs["plain"].reward, rtol=5e-3, atol=5e-3)
