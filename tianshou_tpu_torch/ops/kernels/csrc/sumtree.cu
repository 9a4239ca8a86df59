// Sum-tree prefix-sum descent for Hopper: for each query value, the largest
// leaf i with prefix_sum(i) <= value, clamped to size - 1.
//
// Replaces the TPU kernel tianshou_tpu/ops/pallas/sumtree.py:pallas_prefix_sum_idx
// (body _kernel). That kernel pins the whole tree in VMEM and replaces each
// per-query gather by a masked reduction over all 2*bound nodes, because the
// TPU has no vector gather; it is limited to bound <= 16384. A GPU thread
// simply loads tree[2*idx], so this kernel is the descent itself: one thread
// per query, start at the root (node 1), and at each of `depth` levels read
// the left child, go right if left < value (strict) and then subtract left.
// Any bound works: the tree is read from global memory through L2 (the main
// path's tree, 131072 leaves, is 1 MiB and does not fit in a block's 227 KB
// of shared memory).
//
// The body has one compare and one subtract per level, nothing to contract
// into an FMA, so the result equals the plain PyTorch loop exactly. Do not
// build with -use_fast_math.
//
// Bound on an H100 SXM (3.35 TB/s HBM): bytes moved are 4 per query value,
// 8 per result and 4 per distinct tree node the queries touch (at most
// depth per query). At the main path's shape (32 queries, depth 17) that is
// under 3 KB, below 0.001 us: the kernel is bound by the launch and by 17
// dependent loads per thread, not by bytes or operations. Staging the top
// levels of the tree in shared memory is later work.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void prefix_sum_idx_kernel(const float* __restrict__ tree,
                                      const float* __restrict__ values,
                                      int64_t* __restrict__ out,
                                      int64_t n_queries, int depth,
                                      int64_t bound, int64_t size) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n_queries) return;
  float v = values[q];
  int64_t idx = 1;
  for (int level = 0; level < depth; ++level) {
    const float left = __ldg(tree + 2 * idx);
    const bool go_right = left < v;
    if (go_right) v = __fsub_rn(v, left);
    idx = 2 * idx + (go_right ? 1 : 0);
  }
  const int64_t leaf = idx - bound;
  out[q] = leaf < size - 1 ? leaf : size - 1;
}

}  // namespace

extern "C" int tt_prefix_sum_idx(const void* tree, const void* values, void* out,
                                 int64_t n_queries, int depth, int64_t bound,
                                 int64_t size, void* stream) {
  if (n_queries <= 0 || depth < 0 || depth > 40 || bound != (int64_t{1} << depth) ||
      size < 1 || size > bound) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the descent is a chain of dependent loads, so small blocks spread the
  // queries over many SMs; large batches take fuller blocks
  const int threads = n_queries >= 132 * 128 ? 128 : 32;
  const int64_t blocks = (n_queries + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  prefix_sum_idx_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tree), static_cast<const float*>(values),
      static_cast<int64_t*>(out), n_queries, depth, bound, size);
  return static_cast<int>(cudaGetLastError());
}
