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
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("width", [16, 2032, 2064, 7056, 7057, 8192, 8208, 65536])
def test_gather_rows_widths_around_chunk_and_block_edges_on_cuda(width, idx_dtype):
    """Row widths around the 16-byte chunk, one chunk per thread (up to 4096 B) and two, the block's
    512 chunks, the main path's 7056 B, an unaligned width (byte path) and several blocks per row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(width)
    src = torch.randint(0, 256, (300, width), dtype=torch.uint8, device="cuda", generator=g)
    for rows in (1, 200, 3000):
        idx = torch.randint(-2, 302, (rows,), device="cuda", generator=g).to(idx_dtype)
        out = tg.gather_rows(src, idx)
        torch.cuda.synchronize()
        assert torch.equal(out, tg.gather_rows_reference(src, idx))
    off = src.reshape(-1)[1:1 + 299 * width].reshape(299, width)  # a base pointer off the 16-byte grid
    idx = torch.randint(0, 299, (64,), device="cuda", generator=g)
    assert torch.equal(tg.gather_rows(off, idx), off[idx])


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
@pytest.mark.parametrize("shape", [(0, 1, 1), (0, 4, 3), (1, 3, 4), (2, 2, 4), (2, 6, 1), (3, 5, 7), (4, 8, 4),
                                   (5, 5, 4), (5, 7, 4), (5, 9, 32)])
def test_prefix_sum_idx_kernel_exact_for_any_launch_shape_on_cuda(shape):
    """(log2 lanes per query, levels per trip, warps per block): every split of the descent gives the same
    leaves, with ragged last warps and blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    for size in (131072, 100000, 5, 1):
        st = SegmentTree(size)
        tree = tsum.update_reference(st.init("cuda"), torch.arange(size, device="cuda"),
                                     torch.rand(size, device="cuda", generator=g), st.bound, st.depth, st.size)
        total = st.total(tree)
        cum = torch.cumsum(tree[st.bound:st.bound + min(size, 64)], 0)
        q = torch.cat([torch.rand(4099, device="cuda", generator=g) * total, cum, torch.stack([total, -total, total * 0])])
        out = tsum._descent(tree, q.contiguous(), st.bound, st.depth, st.size, shape)
        torch.cuda.synchronize()
        assert torch.equal(out, tsum.prefix_sum_idx_reference(tree, q, st.bound, st.depth, st.size)), size


def _update_cases_on_cuda(g):
    """(name, size, index, value) on the card: duplicates, -1 and out-of-range indices, k around the one-block
    size and above it (duplicates across chunks), zero priorities, an expanded (stride-0) value."""
    cases = [("[7, 7, -1, 7]", 131072, torch.tensor([7, 7, -1, 7]), torch.tensor([1.0, 2.0, 9.0, 4.0])),
             ("adjacent duplicates", 10, torch.tensor([4, 9, 9, 4, 4, 2, 2]), torch.arange(1.0, 8.0)),
             ("size 1", 1, torch.tensor([0, -1, 0, 1]), torch.tensor([1.0, 9.0, 2.5, 9.0]))]
    cases = [(n, s, i.cuda(), v.cuda()) for n, s, i, v in cases]
    for size, k in ((131072, 32), (131072, 256), (131072, 1024), (131072, 1025), (100000, 300000), (5, 40)):
        idx = torch.randint(-3, size + 3, (k,), device="cuda", generator=g)
        val = torch.rand(k, device="cuda", generator=g) * 5
        val[torch.rand(k, device="cuda", generator=g) < 0.2] = 0.0
        cases.append((f"size {size}, k {k}", size, idx, val))
    cases.append(("across chunks: a later chunk's write wins", 50, torch.arange(2100, device="cuda") % 50,
                  torch.rand(2100, device="cuda", generator=g)))
    cases.append(("expanded value", 131072, torch.randint(-1, 131072, (256,), device="cuda", generator=g),
                  torch.tensor(0.7, device="cuda").expand(256)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["empty", "filled"])
def test_tree_update_kernel_bit_exact_on_cuda(start):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    for name, size, index, value in _update_cases_on_cuda(g):
        st = SegmentTree(size)
        base = st.init("cuda")
        if start == "filled":
            tsum.update_reference(base, torch.arange(size, device="cuda"), torch.rand(size, device="cuda", generator=g),
                                  st.bound, st.depth, st.size)
        want = tsum.update_reference(base.clone(), index, value, st.bound, st.depth, st.size)
        before = tsum.update_launch_count()
        got = tsum.update(base.clone(), index, value, st.bound, st.depth, st.size)
        torch.cuda.synchronize()
        assert tsum.update_launch_count() == before + -(-index.shape[0] // tsum.ONE_BLOCK), name
        assert torch.equal(got, want), name
        assert torch.equal(got[1:st.bound], got[2::2] + got[3::2]) and got[0].item() == 0.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 32, 256, 1024])
def test_segtree_update_launches_the_kernel_once_on_cuda(k):
    """The training path's updates (32 and 256 leaves) are one launch and read nothing back to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(k)
    st = SegmentTree(131072)
    tree = st.init("cuda")
    index = torch.randint(-1, 131072, (k,), device="cuda", generator=g)
    value = torch.rand(k, device="cuda", generator=g)
    want = tsum.update_reference(tree.clone(), index, value, st.bound, st.depth, st.size)
    tsum.reset_launch_count()
    torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
    try:
        out = st.update(tree, index, value)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out is tree
    assert (tsum.update_launch_count(), tsum.launch_count()) == (1, 0)
    assert torch.equal(tree, want)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["HalfCheetah", "Ant", "Hopper"])
@pytest.mark.parametrize("num_envs", [1, 6, 31, 33, 2053])  # a lone team, ragged warps and a ragged last block
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


@pytest.mark.cuda
@pytest.mark.parametrize("team", [4, 32])
def test_fused_step_kernel_gives_the_same_bits_for_any_team_size_on_cuda(team, monkeypatch):
    """Each element of each sum belongs to one lane in a fixed order, so the lanes per env do not show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from tianshou_tpu_torch.env.mujoco import make
    from tianshou_tpu_torch.ops.kernels import physics_fused as pf

    env = make("Walker2d")
    model = env.model
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.as_tensor(model.qpos0, dtype=torch.float32, device="cuda") + 0.03 * torch.randn(257, model.nq, device="cuda", generator=g)
    qd = 0.05 * torch.randn(257, model.nq, device="cuda", generator=g)
    for _ in range(12):  # roll on until contacts and limits are active
        ctrl = torch.rand(257, len(model.actuators), device="cuda", generator=g) * 2 - 1
        q, qd = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    want = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    monkeypatch.setattr(pf, "_TEAM", team)
    got = pf.fused_step(model, q, qd, ctrl, frame_skip=env.frame_skip)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
