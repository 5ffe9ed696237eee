// Interval expansion for Hopper (sm_90a): each output slot takes the values
// of the interval that owns it.
//
// Replaces the TPU kernel gs_tpu/ops/pairmove.py::_expand_kernel (entered
// through expand_intervals). Same contract, in the port's layout: offsets
// and ends [N] i32 (offsets non-decreasing, intervals disjoint:
// ends[n] <= offsets[n + 1]) and K value columns cols [K, N] of 32-bit
// words give
//   out[c, p] = cols[c, n] for the unique n with offsets[n] <= p < ends[n],
//   out[c, p] = 0 where no interval owns p,            p in [0, total).
// Values are copied as 32-bit words, so int32 and float32 columns come out
// bitwise equal to their input.
//
// Design. The TPU kernel walks each block of output slots' window of
// intervals and expands it on the matrix unit against an interval
// indicator, with every value split into three bf16 terms to stay exact.
// Here one thread owns one slot: a binary search over offsets finds the
// last n with offsets[n] <= p (zero-length intervals that share an offset
// resolve to the last of them, the one that can own p), the thread tests
// p < ends[n], and stores its K words, each column's store coalesced across
// the warp. Neighbouring slots mostly share an owner, so a warp's search
// steps hit the same few offsets and are served from L1 / L2. A giant
// interval (a splat over many tiles) is just many threads with the same
// owner; runs of zero-length intervals cost nothing beyond the search.
//
// What bounds it: bytes. K words written per slot; offsets, ends and the
// columns read (each at least once).

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
expand_intervals_kernel(const int* __restrict__ offsets, const int* __restrict__ ends,
                        const int* __restrict__ cols, int* __restrict__ out, int n,
                        int total) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= total) return;
  // last n with offsets[n] <= p: upper_bound - 1
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(offsets + mid) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int owner = lo - 1;
  const bool owned = owner >= 0 && p < __ldg(ends + owner);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    out[static_cast<long long>(c) * total + p] =
        owned ? __ldg(cols + static_cast<size_t>(c) * n + owner) : 0;
  }
}

template <int K>
cudaError_t launch(const int* offsets, const int* ends, const int* cols, int* out, int n,
                   int total, cudaStream_t stream) {
  const int blocks = (total + kThreads - 1) / kThreads;
  expand_intervals_kernel<K><<<blocks, kThreads, 0, stream>>>(offsets, ends, cols, out, n,
                                                              total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// offsets, ends [n] i32; cols [k, n] and out [k, total] of 32-bit words;
// all contiguous on the device; 1 <= k <= 16.
int gs_expand_intervals(const int* offsets, const int* ends, const int* cols, int* out, int n,
                        int k, int total, void* stream) {
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_EXPAND_CASE(K) \
  case K: return static_cast<int>(launch<K>(offsets, ends, cols, out, n, total, s));
  switch (k) {
    GS_EXPAND_CASE(1)
    GS_EXPAND_CASE(2)
    GS_EXPAND_CASE(3)
    GS_EXPAND_CASE(4)
    GS_EXPAND_CASE(5)
    GS_EXPAND_CASE(6)
    GS_EXPAND_CASE(7)
    GS_EXPAND_CASE(8)
    GS_EXPAND_CASE(9)
    GS_EXPAND_CASE(10)
    GS_EXPAND_CASE(11)
    GS_EXPAND_CASE(12)
    GS_EXPAND_CASE(13)
    GS_EXPAND_CASE(14)
    GS_EXPAND_CASE(15)
    GS_EXPAND_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GS_EXPAND_CASE
}

}  // extern "C"
