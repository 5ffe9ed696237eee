// Segment sum of Gaussian-sorted pair-gradient rows for Hopper (sm_90a).
//
// Replaces the TPU kernel gs_tpu/ops/pairmove.py::_segred_kernel (entered
// through segment_reduce_packed). Same contract, in the port's row-major
// layout: rows [B, K] f32 sorted by owning Gaussian and the inclusive
// cumulative pair count seg_cum [N] i32 give
//   out[g] = sum of rows[seg_cum[g-1] : seg_cum[g]]   (seg_cum[-1] = 0),
// exactly 0 for a Gaussian with no pairs. Rows past seg_cum[N-1] (the null
// row's pairs, which sort last) are never read.
//
// Design. The TPU kernel streams each block of 256 Gaussians' contiguous
// row window through VMEM and contracts it on the matrix unit against an
// interval indicator, splitting every value into three bf16 terms so that
// the products are exact. None of that is needed here: one warp owns one
// Gaussian. Its 32 lanes stride the segment (lane l sums rows lo + l,
// lo + l + 32, ...) into K double accumulators, then a fixed xor-shuffle
// tree combines the lanes and lane c writes column c, rounded once to
// float. No atomics and a fixed order: the same inputs give the same bits
// on every run. Accumulating in double keeps the result within one float
// rounding of the exact sum, as the plain version (a float64 index_add_,
// rounded once) is.
//
// Load balance: segments run from 0 rows to hundreds (a large splat
// covers hundreds of tiles). A warp per Gaussian keeps a long segment a
// strided loop of one warp (ceil(len / 32) iterations) while the short
// ones retire and free their slot; the grid has N warps, far more than
// the card holds at once.
//
// What bounds it: bytes. Each row is read once (36 B at K = 9) and each
// output row written once, against ~K adds per row. On segments of ~5-20
// rows the per-warp work (two seg_cum loads, the 5-step shuffle tree over
// K double columns) costs more than those bytes; PERF.md has the times.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kWarps = 8;  // warps (Gaussians) per 256-thread block

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
segment_reduce_kernel(const float* __restrict__ rows, const int* __restrict__ seg_cum,
                      float* __restrict__ out, int num_rows, int n) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n) return;  // the whole warp leaves together
  const int lo = g == 0 ? 0 : min(seg_cum[g - 1], num_rows);
  const int hi = min(seg_cum[g], num_rows);

  double acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.0;
  for (long long r = lo + lane; r < hi; r += 32) {  // 64-bit: no overflow near 2^31
    const float* row = rows + r * K;
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] += static_cast<double>(row[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  }
  // every lane now holds the same sums; lane c stores column c
  float* dst = out + static_cast<size_t>(g) * K;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (lane == c) dst[c] = static_cast<float>(acc[c]);
  }
}

template <int K>
cudaError_t launch(const float* rows, const int* seg_cum, float* out, int num_rows, int n,
                   cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  segment_reduce_kernel<K><<<blocks, kWarps * 32, 0, stream>>>(rows, seg_cum, out, num_rows,
                                                                n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rows [num_rows, k] f32 sorted by Gaussian; seg_cum [n] i32 inclusive;
// out [n, k] f32; all contiguous on the device; 1 <= k <= 16.
int gs_segment_reduce(const float* rows, const int* seg_cum, float* out, int num_rows, int n,
                      int k, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_SEGRED_CASE(K) \
  case K: return static_cast<int>(launch<K>(rows, seg_cum, out, num_rows, n, s));
  switch (k) {
    GS_SEGRED_CASE(1)
    GS_SEGRED_CASE(2)
    GS_SEGRED_CASE(3)
    GS_SEGRED_CASE(4)
    GS_SEGRED_CASE(5)
    GS_SEGRED_CASE(6)
    GS_SEGRED_CASE(7)
    GS_SEGRED_CASE(8)
    GS_SEGRED_CASE(9)
    GS_SEGRED_CASE(10)
    GS_SEGRED_CASE(11)
    GS_SEGRED_CASE(12)
    GS_SEGRED_CASE(13)
    GS_SEGRED_CASE(14)
    GS_SEGRED_CASE(15)
    GS_SEGRED_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GS_SEGRED_CASE
}

}  // extern "C"
