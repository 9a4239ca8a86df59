"""The sum-tree kernels' source (tianshou_tpu_torch/ops/kernels/csrc/sumtree.cu)
compiled as host C++ and held exactly against the plain versions,
``prefix_sum_idx_reference`` and ``update_reference``.

The host build runs the kernels' own functions: a phase between two barriers
loops over its lanes, and a second build (``-DTT_REVERSE_LANES``) loops the
other way, so a phase that read what another lane wrote in it would differ.
Tolerance: none. The descent does one strict compare and one subtract per
level in the plain loop's order, and the update adds ``tree[2p] + tree[2p+1]``
as the plain loop does, so indices and trees are held bit-equal.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tianshou_tpu_torch.ops.kernels import sumtree as ts
from tianshou_tpu_torch.ops.segtree import SegmentTree

SRC = Path(ts.__file__).resolve().parent / "csrc" / "sumtree.cu"
P = ctypes.c_void_p
I64 = ctypes.c_int64


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{"forward": lib, "reverse": lib}: the source built once per module in both lane orders."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    out = tmp_path_factory.mktemp("sumtree_host")
    libs = {}
    for name, flags in (("forward", []), ("reverse", ["-DTT_REVERSE_LANES"])):
        lib = out / f"libsumtree_{name}.so"
        subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", *flags, "-o", str(lib), str(SRC)],
                       check=True, capture_output=True)
        dll = ctypes.CDLL(str(lib))
        dll.tt_prefix_sum_idx_host.argtypes = [P, P, P, I64, ctypes.c_int, I64, I64, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int]
        dll.tt_tree_update_host.argtypes = [P, P, I64, P, I64, I64, ctypes.c_int, I64, I64,
                                            ctypes.POINTER(ctypes.c_int)]
        libs[name] = dll
    return libs


def host_descent(lib, st, tree, values, lanes_log2, per_trip, warps):
    out = torch.full(values.shape, -7, dtype=torch.int64)
    rc = lib.tt_prefix_sum_idx_host(tree.data_ptr(), values.data_ptr(), out.data_ptr(), values.shape[0], st.depth,
                                    st.bound, st.size, lanes_log2, per_trip, warps)
    assert rc == 0
    return out


def host_update(lib, st, tree, index, value):
    """In place, as the kernel; returns the launches the card would make."""
    launches = ctypes.c_int(-1)
    rc = lib.tt_tree_update_host(tree.data_ptr(), index.data_ptr(), index.stride(0), value.data_ptr(),
                                 value.stride(0), index.shape[0], st.depth, st.bound, st.size, ctypes.byref(launches))
    assert rc == 0
    return launches.value


def filled(size, rng, zero_share=0.0):
    st = SegmentTree(size)
    vals = rng.random(size).astype(np.float32) + 1e-3
    vals[rng.random(size) < zero_share] = 0.0
    tree = ts.update_reference(st.init("cpu"), torch.arange(size), torch.from_numpy(vals), st.bound, st.depth, st.size)
    return st, tree


def queries(st, tree, rng, n):
    """Uniform values over the mass, the exact prefix sums of the first leaves (a value equal to one goes
    left), 0, the total, values beyond it and negative ones."""
    total = tree[1]
    cum = torch.cumsum(tree[st.bound:st.bound + min(st.size, 200)], 0)
    return torch.cat([torch.from_numpy(rng.random(n).astype(np.float32)) * total, cum,
                      torch.stack([total * 0, total, total * 1.5, total + 1e9, -total - 1])]).contiguous()


# (log2 lanes per query, levels per trip, warps per block): the wrapper's rule for small and large batches,
# one level per trip (the old kernel's walk), every split between a team's lanes and a lane's candidates, and
# more levels per trip than the tree has
LAUNCH_SHAPES = [None, "large", (0, 1, 1), (0, 4, 3), (1, 3, 4), (2, 2, 4), (2, 6, 1), (3, 5, 7), (4, 8, 4),
                 (5, 5, 4), (5, 7, 4), (5, 9, 32)]


def launch_shape(shape, n):
    if shape in (None, "large"):
        return ts._descent_shape(n if shape is None else 4096)
    return shape


@pytest.mark.parametrize("size,zero_share", [(1, 0.0), (5, 0.0), (100, 0.3), (1024, 0.0), (16384, 0.5), (100000, 0.0)])
def test_host_descent_equals_plain_version(size, zero_share, host_libs, rng):
    st, tree = filled(size, rng, zero_share)
    values = queries(st, tree, rng, 300)
    want = ts.prefix_sum_idx_reference(tree, values, st.bound, st.depth, st.size)
    for shape in LAUNCH_SHAPES:
        for name, lib in host_libs.items():
            got = host_descent(lib, st, tree, values, *launch_shape(shape, values.shape[0]))
            assert torch.equal(got, want), (shape, name)


def test_host_descent_on_all_zero_and_sparse_trees(host_libs, rng):
    st = SegmentTree(131072)
    trees = {"all zero": st.init("cpu")}
    sparse = st.init("cpu")
    ts.update_reference(sparse, torch.tensor([3, 77, 131071]), torch.tensor([1.0, 3.0, 0.5]), st.bound, st.depth, st.size)
    trees["three leaves"] = sparse
    for name, tree in trees.items():
        values = torch.cat([torch.from_numpy(rng.random(64).astype(np.float32)) * 4.5,
                            torch.tensor([0.0, 1.0, 4.0, 4.5, -1.0, 1e9])])
        want = ts.prefix_sum_idx_reference(tree, values, st.bound, st.depth, st.size)
        for lib in host_libs.values():
            assert torch.equal(host_descent(lib, st, tree, values, *ts._descent_shape(70)), want), name
    assert set(want[:64].tolist()) <= {3, 77, 131071}


def test_host_descent_refuses_what_the_kernel_does_not_take(host_libs):
    st, tree = SegmentTree(8), torch.zeros(16)
    values, out = torch.zeros(4), torch.zeros(4, dtype=torch.int64)
    lib = host_libs["forward"]
    for n, bound, size, lanes_log2, per_trip, warps in [
        (0, 8, 8, 5, 5, 4), (4, 7, 8, 5, 5, 4), (4, 8, 9, 5, 5, 4), (4, 8, 8, 5, 0, 4), (4, 8, 8, 5, 10, 4),
        (4, 8, 8, 1, 6, 4), (4, 8, 8, 6, 5, 4), (4, 8, 8, -1, 1, 4), (4, 8, 8, 5, 5, 0), (4, 8, 8, 5, 5, 33),
    ]:
        assert lib.tt_prefix_sum_idx_host(tree.data_ptr(), values.data_ptr(), out.data_ptr(), n, st.depth, bound,
                                          size, lanes_log2, per_trip, warps) != 0


def _update_cases(rng):
    """(name, size, index, value): duplicates in any order, -1 and indices at and beyond size, k around the
    one-block size and above it (duplicates within a chunk and across chunks), zero priorities, an expanded
    (stride-0) value and a strided index."""
    cases = [("size 1", 1, torch.tensor([0, -1, 0, 1]), torch.tensor([1.0, 9.0, 2.5, 9.0]))]
    cases.append(("[7, 7, -1, 7]", 100, torch.tensor([7, 7, -1, 7]), torch.tensor([1.0, 2.0, 9.0, 4.0])))
    cases.append(("adjacent duplicates", 10, torch.tensor([4, 9, 9, 4, 4, 2, 2]), torch.arange(1.0, 8.0)))
    for size, k in ((5, 40), (100, 32), (1000, 256), (1000, 1024), (1000, 1025), (131072, 3000)):
        idx = torch.from_numpy(rng.integers(-3, size + 3, k))
        val = torch.from_numpy((rng.random(k) * 5).astype(np.float32))
        val[torch.from_numpy(rng.random(k) < 0.2)] = 0.0
        cases.append((f"size {size}, k {k}", size, idx, val))
    cases.append(("across chunks: a later chunk's write wins", 50, torch.arange(2100) % 50,
                  torch.from_numpy(rng.random(2100).astype(np.float32))))
    cases.append(("only dropped", 100, torch.tensor([-1, -1, 100, 1000]), torch.ones(4)))
    cases.append(("expanded value", 300, torch.from_numpy(rng.integers(-1, 300, 256)),
                  torch.tensor(0.7).expand(256)))
    cases.append(("strided index", 300, torch.from_numpy(rng.integers(0, 300, 64))[::2],
                  torch.from_numpy(rng.random(32).astype(np.float32))))
    return cases


@pytest.mark.parametrize("start", ["empty", "filled"])
def test_host_update_equals_plain_version(start, host_libs, rng):
    for name, size, index, value in _update_cases(rng):
        st = SegmentTree(size)
        base = st.init("cpu") if start == "empty" else filled(size, rng)[1]
        want = ts.update_reference(base.clone(), index, value, st.bound, st.depth, st.size)
        for lib_name, lib in host_libs.items():
            got = base.clone()
            launches = host_update(lib, st, got, index, value)
            assert torch.equal(got, want), (name, lib_name)
            assert launches == -(-index.shape[0] // ts.ONE_BLOCK), name
        assert got[0].item() == 0.0
        assert torch.equal(got[1:st.bound], got[2::2] + got[3::2]), name
        kept = (index >= 0) & (index < size)
        for i in index[kept].unique().tolist():  # the last write wins
            assert got[st.bound + i].item() == value[torch.nonzero(index == i)[-1, 0]].item(), name


def test_host_update_then_descent_equals_plain_versions(host_libs, rng):
    """A whole tree built by the host update in chunks of the training path's sizes, sampled by the host
    descent, against the plain versions doing the same."""
    st = SegmentTree(131072)
    got, want = st.init("cpu"), st.init("cpu")
    lib = host_libs["reverse"]
    for k in (131072, 256, 32, 256, 32):
        index = torch.from_numpy(rng.permutation(131072)[:k])
        value = torch.from_numpy((rng.random(k) + 1e-3).astype(np.float32))
        host_update(lib, st, got, index, value)
        ts.update_reference(want, index, value, st.bound, st.depth, st.size)
        assert torch.equal(got, want), k
    values = queries(st, want, rng, 4096)
    expect = ts.prefix_sum_idx_reference(want, values, st.bound, st.depth, st.size)
    assert torch.equal(host_descent(lib, st, got, values, *ts._descent_shape(values.shape[0])), expect)


def test_host_update_refuses_what_the_kernel_does_not_take(host_libs):
    lib = host_libs["forward"]
    tree, index, value = torch.zeros(16), torch.zeros(4, dtype=torch.int64), torch.zeros(4)
    launches = ctypes.c_int(0)
    for k, depth, bound, size in [(0, 3, 8, 8), (-1, 3, 8, 8), (4, 3, 7, 8), (4, 3, 8, 9), (4, 3, 8, 0), (4, -1, 8, 8)]:
        assert lib.tt_tree_update_host(tree.data_ptr(), index.data_ptr(), 1, value.data_ptr(), 1, k, depth, bound,
                                       size, ctypes.byref(launches)) != 0
        assert launches.value == 0
