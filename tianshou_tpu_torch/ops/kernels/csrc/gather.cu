// Replay row gather for Hopper: out[b, :] = src[clamp(idx[b], 0, N-1), :].
//
// Replaces the TPU kernel tianshou_tpu/ops/pallas/gather.py:gather_rows (one
// HBM->HBM DMA per row with a ring of in-flight copies). It is a pure copy,
// bound by bytes: 2 * rows * row_bytes over 3.35 TB/s on an H100 SXM.
//   main path, 128 rows x 7056 B:         1.81 MB -> 0.54 us
//   update burst (batch 1024), 4096 rows: 57.8 MB -> 17.3 us
// At 128 rows the time is not the bytes but the trips to device memory that
// follow one another: the index, then the row. So every byte of the launch is
// asked for in the first trip after the index: a row is spread over the grid,
// grid = (rows, ceil(chunks / (threads * U))); a thread loads its row's index
// (a broadcast within the block), then starts its U 16-byte loads before the
// first store; offsets inside a row are 32-bit. With 256 threads and U = 2 one
// block covers the 441 chunks of a 7056-byte row and no load waits for another.
// (The TPU kernel's own idea on Hopper's copy engine, a ring of cp.async.bulk
// row copies through shared memory driven by one thread per block, was built
// and measured beside this one and was slower at both sizes; PERF.md has the
// times.)
//
// Rows or bases that are not 16-byte aligned are copied byte by byte (one
// block per row). Rows may be any width in bytes; the frame rows of the main
// path are 84*84*1 = 7056 B, a multiple of 16 but not of 128, so the TPU
// kernel's F % 128 rule does not apply here. Measured times are in PERF.md.
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// caller's stream, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename IdxT>
__device__ __forceinline__ int64_t clamped_row(const IdxT* __restrict__ idx, int64_t b, int64_t n_rows) {
  const int64_t r = static_cast<int64_t>(idx[b]);
  return r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
}

// U chunks of 16 bytes per thread, every load started before the first store
template <typename IdxT, int U>
__global__ void gather_spread_kernel(const uint8_t* __restrict__ src, const IdxT* __restrict__ idx,
                                     uint8_t* __restrict__ out, int64_t n_rows, int64_t row_bytes, int n16) {
  const int64_t b = blockIdx.x;
  const int first = blockIdx.y * (blockDim.x * U) + threadIdx.x;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + clamped_row(idx, b, n_rows) * row_bytes);
  uint4* o4 = reinterpret_cast<uint4*>(out + b * row_bytes);
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = first + u * blockDim.x;
    if (i < n16) v[u] = __ldg(s4 + i);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = first + u * blockDim.x;
    if (i < n16) o4[i] = v[u];
  }
}

// rows or bases off the 16-byte grid: one block per row, byte by byte
template <typename IdxT>
__global__ void gather_bytes_kernel(const uint8_t* __restrict__ src, const IdxT* __restrict__ idx,
                                    uint8_t* __restrict__ out, int64_t n_rows, int64_t row_bytes) {
  const int64_t b = blockIdx.x;
  const uint8_t* s = src + clamped_row(idx, b, n_rows) * row_bytes;
  uint8_t* o = out + b * row_bytes;
  for (int64_t i = threadIdx.x; i < row_bytes; i += blockDim.x) o[i] = __ldg(s + i);
}

__global__ void noop_kernel() {}

template <typename IdxT>
cudaError_t launch(const void* src, const void* idx, void* out, int64_t n_rows, int64_t row_bytes, int64_t n_out,
                   cudaStream_t stream) {
  const bool aligned = (row_bytes % 16 == 0) && (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* ix = static_cast<const IdxT*>(idx);
  auto* o = static_cast<uint8_t*>(out);
  const int64_t n16 = row_bytes / 16;
  const int threads = n16 >= 256 ? 256 : (n16 >= 128 ? 128 : (n16 >= 64 ? 64 : 32));
  const int64_t across = (n16 + 2 * threads - 1) / (2 * threads);  // blocks along a row at two chunks per thread
  if (!aligned || across > 65535) {
    const int t = row_bytes >= 128 ? 128 : (row_bytes >= 64 ? 64 : 32);
    gather_bytes_kernel<IdxT><<<static_cast<unsigned>(n_out), t, 0, stream>>>(s, ix, o, n_rows, row_bytes);
  } else if (n16 > threads) {
    const dim3 grid(static_cast<unsigned>(n_out), static_cast<unsigned>(across));
    gather_spread_kernel<IdxT, 2><<<grid, threads, 0, stream>>>(s, ix, o, n_rows, row_bytes, static_cast<int>(n16));
  } else {
    gather_spread_kernel<IdxT, 1><<<static_cast<unsigned>(n_out), threads, 0, stream>>>(s, ix, o, n_rows, row_bytes,
                                                                                       static_cast<int>(n16));
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int tt_gather_rows(const void* src, const void* idx, int idx_is_int64, void* out, int64_t n_rows,
                              int64_t row_bytes, int64_t n_out, void* stream) {
  if (n_out <= 0 || n_out > 0x7fffffffLL || n_rows <= 0 || row_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(idx_is_int64 ? launch<int64_t>(src, idx, out, n_rows, row_bytes, n_out, s)
                                       : launch<int32_t>(src, idx, out, n_rows, row_bytes, n_out, s));
}

// an empty kernel of the given launch shape: what a launch costs with nothing to copy
extern "C" int tt_gather_noop(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  noop_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
