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
// Design. As the TPU kernel does, a block owns 256 consecutive Gaussians,
// whose rows form one contiguous window [seg_cum[g0-1], seg_cum[g0+255]).
// The block loads its 257 bounds once, coalesced, and splits its segments
// by length:
//   - short segments (at most kLongRows = 512 rows, a staged piece): the
//     block streams the window in pieces of 512 rows, jumping over the
//     long segments' rows. Its threads load a piece's floats coalesced into
//     registers (the next piece's loads are in flight while the current one
//     is summed), convert them to float64 with every lane busy and store
//     them to shared memory. Thread t owns Gaussian g0 + t and adds the rows
//     of its segment that lie in the piece, in row order, into K double
//     accumulators: one thread's sequential float64 sum, in the order of
//     the plain version's CPU index_add_, so its float result is the plain
//     version's bit for bit;
//   - long segments (over 512 rows), one after another in Gaussian order,
//     by the whole block: thread t adds rows lo + t, lo + t + 256, ... in
//     that order in float64, each warp's 32 sums meet in a fixed shuffle
//     tree and the 8 warps' totals are added in warp order. The order is
//     fixed but is not the sequential one, so the float result can differ
//     from the plain version's by one rounding, where the two float64 sums
//     fall on the two sides of a float rounding boundary (a chance of about
//     the float64 sums' difference over a float ulp).
// The sums are rounded once to float and leave through shared memory as
// coalesced [256, K] stores. There is no atomic and no sum across blocks:
// the same inputs give the same bits on every run, and every result is
// within one float rounding of its float64 sum. Each bound is clamped to
// [0, num_rows].
//
// Converting in the staging pass matters: the float -> double conversion
// runs at a quarter of the float64 add rate on this card, and a thread
// summing its own rows leaves most lanes of its warp idle (~256 / mean
// segment length of the block's threads have rows in a piece), so
// converting there, as a cp.async copy of the raw floats would have it, is
// paid for all 32 lanes. Pieces of 512 rows keep more of each warp's lanes
// busy than pieces of 256.
//
// Load balance: a short segment costs its thread up to 512 dependent row
// steps, the block's tail; a long one costs the block ~L / 512 steps of
// two row loads a thread, plus a shuffle tree. A block's segments still run
// on one SM, so a layout whose long segments crowd a few blocks leaves the
// other SMs idle (chip_smoke.py times such layouts; PERF.md has the times).
//
// What bounds it: bytes, and the latency of one piece in flight per block.
// Each row of the segments is read once (36 B at K = 9), seg_cum once and
// each output row written once, against K float64 adds per row.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;    // Gaussians per block, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kPieceRows = 512;  // rows per staged piece
// segments of more rows than this are summed by the whole block
constexpr int kLongRows = kPieceRows;
constexpr int kLongAhead = 2;  // rows a thread loads per step of the long loop
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ rows, const int* __restrict__ seg_cum,
                      float* __restrict__ out, int num_rows, int n) {
  constexpr int kPer = kPieceRows * K / kThreads;  // floats a thread loads per piece
  extern __shared__ __align__(16) double s_piece[];  // [kPieceRows, K], as float64
  __shared__ int s_bound[kThreads + 1];
  __shared__ int s_long[kThreads];  // the block's long segments, in Gaussian order
  __shared__ int s_warp_long[kWarps];
  __shared__ double s_red[kWarps][K];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g0 = blockIdx.x * kThreads;
  // s_bound[t + 1]: the end of Gaussian g0 + t's rows; past n, the last
  // Gaussian's end, which leaves those threads empty segments
  s_bound[t + 1] = min(max(seg_cum[min(g0 + t, n - 1)], 0), num_rows);
  if (t == 0) s_bound[0] = g0 == 0 ? 0 : min(max(seg_cum[g0 - 1], 0), num_rows);
  __syncthreads();
  const int lo = s_bound[t];
  const int hi = s_bound[t + 1];
  const int w0 = s_bound[0];
  const int w1 = s_bound[kThreads];
  const bool is_long = hi - lo > kLongRows;
  const unsigned long_lanes = __ballot_sync(kFull, is_long);
  if (lane == 0) s_warp_long[warp] = __popc(long_lanes);
  __syncthreads();
  int n_long = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp_long[w] : 0;
    n_long += s_warp_long[w];
  }
  if (is_long) s_long[before + __popc(long_lanes & ((1u << lane) - 1u))] = t;
  __syncthreads();

  // The first row at or past r that no long segment holds; k counts the
  // long segments passed (the same on every thread).
  int k = 0;
  auto skip_long = [&](int r) {
    for (; k < n_long; ++k) {
      const int g = s_long[k];
      if (r < s_bound[g]) break;
      r = max(r, s_bound[g + 1]);
    }
    return r;
  };

  // a piece's floats, coalesced, into registers: element t + i * kThreads
  float buf[kPer];
  auto load = [&](int r0) {
    const float* src = rows + static_cast<size_t>(r0) * K;
    const int nf = min(kPieceRows, w1 - r0) * K;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + i * kThreads;
      buf[i] = e < nf ? src[e] : 0.0f;
    }
  };

  // 1. the short segments: pieces of the window, past the long segments' rows
  double acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.0;
  const int my_hi = is_long ? lo : hi;  // a long segment's thread sums nothing here
  int r0 = skip_long(w0);
  if (r0 < w1) load(r0);
  while (r0 < w1) {
    __syncthreads();  // the previous piece's sums are done with s_piece
#pragma unroll
    for (int i = 0; i < kPer; ++i) s_piece[t + i * kThreads] = static_cast<double>(buf[i]);
    // the next piece (no overflow near 2^31: r0 + kPieceRows only when below w1)
    const int r1 = w1 - r0 > kPieceRows ? skip_long(r0 + kPieceRows) : w1;
    if (r1 < w1) load(r1);  // in flight while this piece is summed
    __syncthreads();
    const int end = min(my_hi - r0, kPieceRows);  // relative to r0
    // two rows a step: the next row's loads issue beside this row's adds
#pragma unroll 2
    for (int r = max(lo - r0, 0); r < end; ++r) {
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += s_piece[r * K + c];
    }
    r0 = r1;
  }
  float* s_out = reinterpret_cast<float*>(s_piece);  // [kThreads, K]
  __syncthreads();
#pragma unroll
  for (int c = 0; c < K; ++c) s_out[t * K + c] = static_cast<float>(acc[c]);

  // 2. the long segments, one after another, by the whole block: thread t
  // sums rows lo + t, lo + t + 256, ... in that order, then the warps' sums
  // meet in a fixed tree and the warps' totals in warp order
  for (int i = 0; i < n_long; ++i) {
    const int g = s_long[i];
    const float* seg = rows + static_cast<size_t>(s_bound[g]) * K;
    const long long len = s_bound[g + 1] - s_bound[g];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = 0.0;
    for (long long r = t; r < len; r += kLongAhead * kThreads) {  // 64-bit: no overflow
      float v[kLongAhead][K];
#pragma unroll
      for (int u = 0; u < kLongAhead; ++u) {
        const bool in = r + u * kThreads < len;
        const float* row = seg + (r + u * kThreads) * K;
#pragma unroll
        for (int c = 0; c < K; ++c) v[u][c] = in ? row[c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLongAhead; ++u) {
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] += static_cast<double>(v[u][c]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] += __shfl_down_sync(kFull, acc[c], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) s_red[warp][c] = acc[c];
    }
    __syncthreads();
    if (t < K) {
      double sum = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_red[w][t];
      s_out[g * K + t] = static_cast<float>(sum);
    }
    __syncthreads();  // s_red is free again
  }

  // 3. the [256, K] sums, coalesced
  __syncthreads();
  const int count = min(kThreads, n - g0) * K;
  float* dst = out + static_cast<size_t>(g0) * K;
  for (int e = t; e < count; e += kThreads) dst[e] = s_out[e];
}

template <int K>
cudaError_t launch(const float* rows, const int* seg_cum, float* out, int num_rows, int n,
                   cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(kPieceRows) * K * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_reduce_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  segment_reduce_kernel<K><<<blocks, kThreads, smem, stream>>>(rows, seg_cum, out, num_rows,
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
