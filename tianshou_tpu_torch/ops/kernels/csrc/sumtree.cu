// The sum tree of prioritized replay on Hopper: its descent (the sampler) and
// its update (the priority writeback), two kernels.
//
// Layout: an implicit binary heap of 2 * bound float32 nodes, bound = 2^depth;
// node 1 is the root, leaves live at [bound, 2 * bound), node 0 is unused.
//
// 1. prefix_sum_idx: for each query value, the largest leaf i with
//    prefix_sum(i) <= value, clamped to size - 1. Replaces the TPU kernel
//    tianshou_tpu/ops/pallas/sumtree.py:pallas_prefix_sum_idx (body _kernel),
//    which pins the whole tree in VMEM and replaces each per-query gather by a
//    masked reduction over all 2 * bound nodes, because the TPU has no vector
//    gather (bound <= 16384 there). Here any bound works.
//
//    What bounds it: not bytes (a few KB at the main path's 32 queries) and
//    not operations (one compare and one subtract per level), but the chain of
//    dependent trips to L2: going down one level at a time is `depth` trips
//    (17 for the main path's 131072 leaves, about 160 ns each). So each query
//    has a team of 2^h lanes (h <= 5, 32 / 2^h queries per warp), and a trip
//    covers `per_trip` levels at once. The team's lanes split the 2^per_trip
//    paths down those levels: a lane's first min(per_trip, h) turns are the
//    bits of its number in the team, the rest (at most 4) those of its
//    candidates. Where a path turns does not depend on the value, so a lane
//    starts all its loads at once: the left children along its own turns and
//    the whole subtree below them. It then walks each candidate in registers,
//    subtracting where the candidate turns right, and the candidate is the
//    descent's path when every turn is the compare it makes there. Exactly
//    one path is; the team finds it with a ballot and takes its node and value
//    with two shuffles. Nothing goes through shared memory: a trip is one
//    round of loads from L2 plus a few hundred cycles of arithmetic, and 17
//    levels cost 3 trips in the shapes the wrapper picks. Wide teams give the
//    fewest trips; narrow ones ask L1 for fewer distinct addresses per query,
//    which a large batch needs.
//
//    Each level is one strict compare (go right where left < value) and one
//    round-to-nearest subtract of the left sum, in the plain loop's order, so
//    the result equals the plain PyTorch version exactly.
//
// 2. tree_update: set leaves index[e] <- value[e] (the last of duplicate
//    indices wins; indices outside [0, size) are dropped), then recompute each
//    ancestor of a written leaf as tree[2p] + tree[2p+1], in that order, a
//    level at a time. Replaces the JAX package's XLA code
//    tianshou_tpu/ops/segtree.py:SegmentTree.update (a stable sort, a scatter
//    and a loop of depth gather-add-scatters), which the port ran as about 90
//    small launches.
//
//    What bounds it: again not bytes (a few KB) but launches and the chain of
//    levels. A launch is one block of up to 1024 entries: entry e is thread e;
//    it keeps its leaf only if no later entry has the same index (a scan of
//    the indices in shared memory), writes it, and then for each level writes
//    its ancestor, with a block barrier between levels. Threads that share a
//    parent write the same sum of the same children. Node 0 is never written.
//    More entries (building a tree, never on the training path) take one such
//    launch per chunk of 1024, in input order on the stream: a later chunk's
//    write wins, and each ancestor it touches is recomputed from children that
//    are final by then, so the tree has the plain version's bits.
//
//    Nodes that the launch writes are read with plain loads after a barrier
//    (never through the read-only path). The sums are single adds, nothing to
//    contract; do not build with -use_fast_math.
//
// Both kernels also compile as host C++ (g++ -x c++): the code of a thread is
// written as functions of its lane, and a phase between two barriers loops
// over its lanes (-DTT_REVERSE_LANES: in the opposite order, so that a phase
// that read what another lane wrote in it would give another result).
// tt_prefix_sum_idx_host and tt_tree_update_host run the same functions on
// the CPU; the tests hold them against the plain versions.
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// caller's stream, allocate nothing and return the launch's error code.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TT_FN __device__ __forceinline__
#define TT_LOAD(p) __ldg(p)
#define TT_SUB(a, b) __fsub_rn(a, b)
#define TT_ADD(a, b) __fadd_rn(a, b)
#define TT_LOG2(x) (31 - __clz(x))
#define TT_UNROLL _Pragma("unroll")
#else
#define TT_FN inline
#define TT_LOAD(p) (*(p))
#define TT_SUB(a, b) ((a) - (b))
#define TT_ADD(a, b) ((a) + (b))
#define TT_LOG2(x) (31 - __builtin_clz(x))
#define TT_UNROLL
#ifdef TT_REVERSE_LANES
#define TT_LANES(l, n) for (int64_t l = (n) - 1; l >= 0; --l)
#else
#define TT_LANES(l, n) for (int64_t l = 0; l < (n); ++l)
#endif
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kCandMax = 4;      // levels per trip along a lane's candidates: up to 16 candidates
constexpr int kMaxWarps = 32;    // warps per block of the descent
constexpr int kOneBlock = 1024;  // entries per launch of the update

// ---------------------------------------------------------------------------
// descent
// ---------------------------------------------------------------------------

// One trip of the descent for one lane of a team: the `levels` levels below node idx, H = levels - R of them
// (at most the team's log2 size) along the bits of the lane's number in the team (from the highest), R along
// each of the lane's 2^R candidates.
// Loads first (none depends on the value), then the walks. Returns whether one of the lane's paths is the
// descent's, and then sets the node it reaches and what is left of the value.
template <int R>
TT_FN bool trip(const float* tree, int64_t idx, int levels, int lane, int64_t& node, float& v) {
  const int H = levels - R;
  const int bits = lane & ((1 << H) - 1);
  float pre[5];
  int64_t n = idx;
  TT_UNROLL
  for (int j = 0; j < 5; ++j) {
    if (j < H) {
      pre[j] = TT_LOAD(tree + 2 * n);
      n = 2 * n + ((bits >> (H - 1 - j)) & 1);
    }
  }
  float sub[1 << R];  // sub[e], e in [1, 2^R): left child of local node e of the subtree below n
  TT_UNROLL
  for (int e = 1; e < (1 << R); ++e) {
    const int j = TT_LOG2(e);
    sub[e] = TT_LOAD(tree + 2 * ((n << j) + (e - (1 << j))));
  }
  bool ok = true;
  float w = v;
  TT_UNROLL
  for (int j = 0; j < 5; ++j) {
    if (j < H) {
      const bool right = (bits >> (H - 1 - j)) & 1;
      ok = ok && ((pre[j] < w) == right);
      if (right) w = TT_SUB(w, pre[j]);
    }
  }
  bool found = false;
  TT_UNROLL
  for (int c = 0; c < (1 << R); ++c) {
    bool ok_c = ok;
    float x = w;
    int e = 1;
    TT_UNROLL
    for (int j = 0; j < R; ++j) {
      const bool right = (c >> (R - 1 - j)) & 1;
      ok_c = ok_c && ((sub[e] < x) == right);
      if (right) x = TT_SUB(x, sub[e]);
      e = 2 * e + (right ? 1 : 0);
    }
    if (ok_c) {
      found = true;
      node = (n << R) + c;
      v = x;
    }
  }
  return found;
}

TT_FN bool trip_any(const float* tree, int64_t idx, int levels, int lanes_log2, int lane, int64_t& node, float& v) {
  switch (levels > lanes_log2 ? levels - lanes_log2 : 0) {
    case 0: return trip<0>(tree, idx, levels, lane, node, v);
    case 1: return trip<1>(tree, idx, levels, lane, node, v);
    case 2: return trip<2>(tree, idx, levels, lane, node, v);
    case 3: return trip<3>(tree, idx, levels, lane, node, v);
    default: return trip<4>(tree, idx, levels, lane, node, v);
  }
}

TT_FN int64_t clamp_leaf(int64_t idx, int64_t bound, int64_t size) {
  const int64_t leaf = idx - bound;
  return leaf < size - 1 ? leaf : size - 1;
}

// lanes per query 2^lanes_log2, queries per block
int64_t queries_per_block(int lanes_log2, int warps_per_block) { return int64_t{warps_per_block} * (kWarp >> lanes_log2); }

bool descent_args_ok(int64_t n_queries, int depth, int64_t bound, int64_t size, int lanes_log2, int per_trip,
                     int warps_per_block) {
  if (!(n_queries > 0 && depth >= 0 && depth <= 40 && bound == (int64_t{1} << depth) && size >= 1 &&
        size <= bound && lanes_log2 >= 0 && lanes_log2 <= 5 && per_trip >= 1 &&
        per_trip <= lanes_log2 + kCandMax && warps_per_block >= 1 && warps_per_block <= kMaxWarps))
    return false;
  const int64_t per_block = queries_per_block(lanes_log2, warps_per_block);
  return (n_queries + per_block - 1) / per_block <= 0x7fffffffLL;
}

// ---------------------------------------------------------------------------
// update
// ---------------------------------------------------------------------------

// the leaf entry e writes, or -1: dropped (outside [0, size)) or overwritten by a later entry; the scan takes
// 8 entries per step, so that their loads from shared memory overlap
TT_FN int64_t winner_leaf(const int64_t* s_idx, int e, int k, int64_t size) {
  const int64_t i = s_idx[e];
  if (i < 0 || i >= size) return -1;
  int j = e + 1;
  for (; j + 8 <= k; j += 8) {
    bool later = false;
    TT_UNROLL
    for (int u = 0; u < 8; ++u) later |= s_idx[j + u] == i;  // no short cut: all 8 loads go out at once
    if (later) return -1;
  }
  for (; j < k; ++j)
    if (s_idx[j] == i) return -1;
  return i;
}

TT_FN void recompute(float* tree, int64_t p) { tree[p] = TT_ADD(tree[2 * p], tree[2 * p + 1]); }

bool update_args_ok(int64_t k, int depth, int64_t bound, int64_t size) {
  return k > 0 && (k + kOneBlock - 1) / kOneBlock <= 0x7fffffffLL && depth >= 0 && depth <= 40 &&
         bound == (int64_t{1} << depth) && size >= 1 && size <= bound;
}

// the chunk of entries [first, first + n) that one launch takes
int chunk_size(int64_t k, int64_t first) {
  return static_cast<int>(k - first < kOneBlock ? k - first : kOneBlock);
}

#ifdef __CUDACC__
// blockDim.x = 32 * warps per block, a team of 2^lanes_log2 lanes per query
__global__ void __launch_bounds__(kMaxWarps * kWarp)
    prefix_sum_idx_kernel(const float* __restrict__ tree, const float* __restrict__ values,
                          int64_t* __restrict__ out, int64_t n_queries, int depth, int64_t bound, int64_t size,
                          int lanes_log2, int per_trip) {
  const int lane = threadIdx.x % kWarp;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + threadIdx.x / kWarp)
                        << (5 - lanes_log2);  // the warp's first query
  if (first >= n_queries) return;  // a whole warp leaves; below, every lane takes part in every shuffle
  const int64_t q = first + (lane >> lanes_log2);
  const bool live = q < n_queries;  // a team past the end descends the last query and writes nothing
  const int team_lane = lane & ((1 << lanes_log2) - 1);
  const unsigned team_mask = static_cast<unsigned>((uint64_t{1} << (1 << lanes_log2)) - 1) << (lane - team_lane);
  float v = __ldg(values + (live ? q : n_queries - 1));
  int64_t idx = 1;
  for (int done = 0; done < depth; done += per_trip) {
    const int levels = depth - done < per_trip ? depth - done : per_trip;
    int64_t node = 0;
    float x = v;
    const bool found = trip_any(tree, idx, levels, lanes_log2, team_lane, node, x);
    const int src = __ffs(__ballot_sync(0xffffffffu, found) & team_mask) - 1;  // exactly one path is the descent's
    idx = __shfl_sync(0xffffffffu, node, src);
    v = __shfl_sync(0xffffffffu, x, src);
  }
  if (live && team_lane == 0) out[q] = clamp_leaf(idx, bound, size);
}

__global__ void __launch_bounds__(kOneBlock)
    tree_update_block_kernel(float* tree, const int64_t* __restrict__ index, int64_t is,
                             const float* __restrict__ value, int64_t vs, int k, int depth, int64_t bound,
                             int64_t size) {
  __shared__ int64_t s_idx[kOneBlock];
  const int e = threadIdx.x;
  float val = 0.0f;
  if (e < k) {
    s_idx[e] = index[e * is];
    val = value[e * vs];
  }
  __syncthreads();
  int64_t node = 0;  // 0: this thread writes nothing
  if (e < k) {
    const int64_t i = winner_leaf(s_idx, e, k, size);
    if (i >= 0) {
      node = bound + i;
      tree[node] = val;
    }
  }
  for (int l = 0; l < depth; ++l) {
    __syncthreads();  // the level below is written
    node >>= 1;
    if (node != 0) recompute(tree, node);
  }
}
#endif

}  // namespace

#ifdef __CUDACC__
extern "C" int tt_prefix_sum_idx(const void* tree, const void* values, void* out, int64_t n_queries, int depth,
                                 int64_t bound, int64_t size, int lanes_log2, int per_trip, int warps_per_block,
                                 void* stream) {
  if (!descent_args_ok(n_queries, depth, bound, size, lanes_log2, per_trip, warps_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_block = queries_per_block(lanes_log2, warps_per_block);
  prefix_sum_idx_kernel<<<static_cast<unsigned>((n_queries + per_block - 1) / per_block), warps_per_block * kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tree), static_cast<const float*>(values), static_cast<int64_t*>(out), n_queries,
      depth, bound, size, lanes_log2, per_trip);
  return static_cast<int>(cudaGetLastError());
}

// one launch per chunk of 1024 entries, in input order; *launches is set to the launches made
extern "C" int tt_tree_update(void* tree, const void* index, int64_t index_stride, const void* value,
                              int64_t value_stride, int64_t k, int depth, int64_t bound, int64_t size, int* launches,
                              void* stream) {
  *launches = 0;
  if (!update_args_ok(k, depth, bound, size)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* t = static_cast<float*>(tree);
  const int64_t* idx = static_cast<const int64_t*>(index);
  const float* val = static_cast<const float*>(value);
  for (int64_t first = 0; first < k; first += kOneBlock) {
    const int n = chunk_size(k, first);
    tree_update_block_kernel<<<1, (n + kWarp - 1) / kWarp * kWarp, 0, st>>>(
        t, idx + first * index_stride, index_stride, val + first * value_stride, value_stride, n, depth, bound, size);
    ++*launches;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
#else
// the descent's launch, team by team: a trip loops over the team's lanes, and the ballot takes the lowest lane
// whose path is the descent's (2: no lane's was, which cannot happen)
extern "C" int tt_prefix_sum_idx_host(const float* tree, const float* values, int64_t* out, int64_t n_queries,
                                      int depth, int64_t bound, int64_t size, int lanes_log2, int per_trip,
                                      int warps_per_block) {
  if (!descent_args_ok(n_queries, depth, bound, size, lanes_log2, per_trip, warps_per_block)) return 1;
  const int lanes = 1 << lanes_log2;
  for (int64_t q = 0; q < n_queries; ++q) {
    float v = values[q];
    int64_t idx = 1;
    for (int done = 0; done < depth; done += per_trip) {
      const int levels = depth - done < per_trip ? depth - done : per_trip;
      bool found[kWarp];
      int64_t node[kWarp];
      float x[kWarp];
      TT_LANES(l, lanes) {
        node[l] = 0;
        x[l] = v;
        found[l] = trip_any(tree, idx, levels, lanes_log2, static_cast<int>(l), node[l], x[l]);
      }
      int src = 0;
      while (src < lanes && !found[src]) ++src;
      if (src == lanes) return 2;
      idx = node[src];
      v = x[src];
    }
    out[q] = clamp_leaf(idx, bound, size);
  }
  return 0;
}

// the update's launches, a thread's code looping over the block's threads phase by phase; *launches as on the
// card
extern "C" int tt_tree_update_host(float* tree, const int64_t* index, int64_t is, const float* value, int64_t vs,
                                   int64_t k, int depth, int64_t bound, int64_t size, int* launches) {
  *launches = 0;
  if (!update_args_ok(k, depth, bound, size)) return 1;
  for (int64_t first = 0; first < k; first += kOneBlock) {
    const int n = chunk_size(k, first);
    int64_t s_idx[kOneBlock], node[kOneBlock];
    float val[kOneBlock];
    TT_LANES(e, n) {
      s_idx[e] = index[(first + e) * is];
      val[e] = value[(first + e) * vs];
    }
    TT_LANES(e, n) {
      const int64_t i = winner_leaf(s_idx, static_cast<int>(e), n, size);
      node[e] = i >= 0 ? bound + i : 0;
      if (i >= 0) tree[node[e]] = val[e];
    }
    for (int l = 0; l < depth; ++l) {
      TT_LANES(e, n) {
        node[e] >>= 1;
        if (node[e] != 0) recompute(tree, node[e]);
      }
    }
    ++*launches;
  }
  return 0;
}
#endif
