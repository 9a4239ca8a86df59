// Replay row gather for Hopper: out[b, :] = src[clamp(idx[b], 0, N-1), :].
//
// Replaces the TPU kernel tianshou_tpu/ops/pallas/gather.py:gather_rows (one
// HBM->HBM DMA per row with a ring of in-flight copies). On the GPU the same
// pure copy is one thread block per output row: the block loads its own
// index, clamps it as the reference's src[idx] clamps, and streams the row
// with 16-byte vector loads and stores when the row width and both base
// pointers are 16-byte aligned, else byte by byte. Rows may be any width in
// bytes; the frame rows of the main path are 84*84*1 = 7056 B, a multiple of
// 16 but not of 128, so the TPU kernel's F % 128 rule does not apply here.
//
// Bound on an H100 SXM (3.35 TB/s HBM): the kernel moves 2*rows*F bytes.
//   main path, 128 rows x 7056 B:         1.81 MB -> 0.54 us (launch dominates)
//   update burst (batch 1024), 4096 rows: 57.8 MB -> 17.3 us
// It is bound by bytes; making it fast (TMA bulk copies, fusing the cast to
// bf16 into the first convolution) is later work.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename IdxT, bool kVec>
__global__ void gather_rows_kernel(const uint8_t* __restrict__ src,
                                   const IdxT* __restrict__ idx,
                                   uint8_t* __restrict__ out,
                                   int64_t n_rows, int64_t row_bytes) {
  const int64_t b = blockIdx.x;
  int64_t r = static_cast<int64_t>(idx[b]);
  r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
  const uint8_t* s = src + r * row_bytes;
  uint8_t* o = out + b * row_bytes;
  if (kVec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    const int64_t n4 = row_bytes >> 4;
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) o4[i] = __ldg(s4 + i);
  } else {
    for (int64_t i = threadIdx.x; i < row_bytes; i += blockDim.x) o[i] = __ldg(s + i);
  }
}

template <typename IdxT>
void launch(const void* src, const void* idx, void* out, int64_t n_rows,
            int64_t row_bytes, int64_t n_out, cudaStream_t stream) {
  const bool vec = (row_bytes % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t chunks = vec ? row_bytes / 16 : row_bytes;
  // 128 threads cover the 441 16-byte chunks of a 7056-byte row in 4 passes
  const int threads = chunks >= 128 ? 128 : (chunks >= 32 ? 64 : 32);
  const dim3 grid(static_cast<unsigned>(n_out));
  const auto* s = static_cast<const uint8_t*>(src);
  const auto* ix = static_cast<const IdxT*>(idx);
  auto* o = static_cast<uint8_t*>(out);
  if (vec) {
    gather_rows_kernel<IdxT, true><<<grid, threads, 0, stream>>>(s, ix, o, n_rows, row_bytes);
  } else {
    gather_rows_kernel<IdxT, false><<<grid, threads, 0, stream>>>(s, ix, o, n_rows, row_bytes);
  }
}

}  // namespace

extern "C" int tt_gather_rows(const void* src, const void* idx, int idx_is_int64,
                              void* out, int64_t n_rows, int64_t row_bytes,
                              int64_t n_out, void* stream) {
  if (n_out <= 0 || n_out > 0x7fffffffLL || n_rows <= 0 || row_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_is_int64) {
    launch<int64_t>(src, idx, out, n_rows, row_bytes, n_out, s);
  } else {
    launch<int32_t>(src, idx, out, n_rows, row_bytes, n_out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
