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
// indicator, with every value split into three bf16 terms to stay exact;
// its wrapper finds the windows with two searchsorted calls. Here a block
// of 256 threads owns kBlockSlots = 1,024 consecutive slots, 4 a thread,
// and finds its window itself:
//   - two warps search offsets for the block's first and last slot at
//     once, 32 probes a round (a 32-ary search: 4 rounds at N = 2^20, the
//     first rounds' probes shared by every block and served from L2). The
//     window is the intervals from the last one starting at or before the
//     first slot to the last one starting at or before the last slot;
//   - a window of at most kPiece intervals is staged in shared memory:
//     its offsets, ends and every column's values, each read once a block
//     with coalesced loads. Each thread then finds the owners of its 4
//     slots: the last interval starting at or before the
//     slot (zero-length intervals sharing an offset resolve to the last of
//     them, the one that can own the slot), which owns it if the slot lies
//     below its end. A binary search over the staged offsets gives the
//     first slot's owner; the next slots keep it until the next interval's
//     start, where they search again;
//   - a larger window (a run of zero-length intervals: binning's culled
//     Gaussians all start at the same offset) is searched the same way in
//     device memory, a few dependent loads a slot, and its values read
//     from there: a search, never a walk;
//   - each column's row is written with 16-byte stores, a warp's 32 stores
//     side by side. Row c starts at word c x total, which lies on a 16-byte
//     boundary only when c x total does (with out 16-byte aligned), so a
//     row whose block range starts off one takes a scalar head of up to 3
//     words and a tail; its 16-byte stores then read the owners from
//     shared memory, where the aligned ones use the thread's own.
//
// What bounds it: bytes. K words written per slot; offsets, ends and the
// columns read (each at least once).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSlots = kThreads * 4;  // 1,024 slots a block, 4 a thread
constexpr int kPiece = 640;                // staged window intervals

// Blocks an SM for K columns: 8 (all 64 warps; 32 registers) where shared
// memory holds them, else 4; 6 for one column, which spilled at 32
// registers. Residency is what sets B6's pace: each block spends most of
// its life waiting on its window search and staging loads, so the card
// writes at full rate only with many blocks in flight (PERF.md).
__host__ __device__ constexpr int min_blocks(int k) { return k == 1 ? 6 : k <= 6 ? 8 : 4; }
constexpr unsigned kFull = 0xffffffffu;

// Shared memory, in words: the block's owners, the staged offsets, ends and
// K columns of the window.
constexpr size_t smem_words(int k) { return kBlockSlots + static_cast<size_t>(2 + k) * kPiece; }

// The number of n < count with offsets[n] <= x (upper bound), by one warp
// (warp-uniform): each round probes 32 evenly spaced offsets of the
// remaining range and keeps the part between the last probe at or below x
// and the first above it.
__device__ int upper_bound_warp(const int* __restrict__ offsets, int count, int x) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = count;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo - 1) / 32 + 1;
    const long long probe = lo + static_cast<long long>(lane + 1) * step - 1;
    const bool below = probe < hi && __ldg(offsets + probe) <= x;
    const int k = __popc(__ballot_sync(kFull, below));
    const long long top = lo + static_cast<long long>(k + 1) * step - 1;
    lo += k * step;
    hi = static_cast<int>(top < hi ? top : hi);
  }
  return lo;
}

// The first i in [lo, hi) with off[i] > p, hi if none (off in shared
// memory, or in device memory).
template <bool kStaged>
__device__ __forceinline__ int first_above(int p, int lo, int hi, const int* off) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((kStaged ? off[mid] : __ldg(off + mid)) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The window-local owners of the 4 slots p .. p + 3 (-1 where no interval
// owns one or the slot lies past `last`) among the w window intervals off /
// end: the last interval starting at or before the slot, if the slot lies
// below its end. One search for the first slot; the next ones search again
// only past the next interval's start, so a run of zero-length intervals
// costs a search, never a walk.
template <bool kStaged>
__device__ __forceinline__ void owners4(int p, int last, int w, const int* off, const int* end,
                                        int (&own)[4]) {
  auto load = [&](const int* a, int i) { return kStaged ? a[i] : __ldg(a + i); };
  int o = first_above<kStaged>(p, 0, w, off) - 1;
  int next = o + 1 < w ? load(off, o + 1) : INT_MAX;
  int stop = o >= 0 ? load(end, o) : INT_MIN;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = p + e;
    if (q >= next) {
      o = first_above<kStaged>(q, o + 1, w, off) - 1;
      next = o + 1 < w ? load(off, o + 1) : INT_MAX;
      stop = load(end, o);
    }
    own[e] = q <= last && q < stop ? o : -1;
  }
}

// Writes the block's slots of one row (row: its first slot) from the
// owners: 16-byte stores where the row's slots allow, scalar ones at its
// ragged ends. `own` holds the owners of the thread's own slots 4 t .. 4 t
// + 3, used when the row starts on a 16-byte boundary (no shared-memory
// reads, and fewer registers than the general path); else s_own (by slot)
// gives them.
template <class Value>
__device__ __forceinline__ void store_row(int* row, int slots, const int (&own)[4],
                                          const int* s_own, Value value) {
  const int head = static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(row) >> 2) & 3)) & 3);
  if (head == 0) {
    const int q = 4 * threadIdx.x;
    if (q + 3 < slots) {
      *reinterpret_cast<int4*>(row + q) =
          make_int4(value(own[0]), value(own[1]), value(own[2]), value(own[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (q + e < slots) row[q + e] = value(own[e]);
      }
    }
    return;
  }
  const int h = min(head, slots);
  if (static_cast<int>(threadIdx.x) < h) row[threadIdx.x] = value(s_own[threadIdx.x]);
  const int nvec = (slots - h) >> 2;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const int q = h + 4 * v;
    *reinterpret_cast<int4*>(row + q) = make_int4(value(s_own[q]), value(s_own[q + 1]),
                                                  value(s_own[q + 2]), value(s_own[q + 3]));
  }
  const int t = h + 4 * nvec + threadIdx.x;
  if (t < slots) row[t] = value(s_own[t]);
}

template <int K, bool kStaged>
__device__ __forceinline__ void expand_block(const int* __restrict__ offsets,
                                             const int* __restrict__ ends,
                                             const int* __restrict__ cols, int* __restrict__ out,
                                             int n, int total, int p0, int slots, int wlo, int w,
                                             int* s_own, const int* s_off, const int* s_end,
                                             const int* s_val) {
  const int* off = kStaged ? s_off : offsets + wlo;
  const int* end = kStaged ? s_end : ends + wlo;
  int own[4];
  const int q = 4 * threadIdx.x;
  owners4<kStaged>(p0 + q, p0 + slots - 1, w, off, end, own);
#pragma unroll
  for (int e = 0; e < 4; ++e) s_own[q + e] = own[e];
  __syncthreads();  // s_own is in
#pragma unroll 1
  for (int c = 0; c < K; ++c) {
    const int* val = kStaged ? s_val + c * kPiece : cols + static_cast<size_t>(c) * n + wlo;
    store_row(out + static_cast<size_t>(c) * total + p0, slots, own, s_own, [&](int o) {
      return o < 0 ? 0 : (kStaged ? val[o] : __ldg(val + o));
    });
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, min_blocks(K))
expand_intervals_kernel(const int* __restrict__ offsets, const int* __restrict__ ends,
                        const int* __restrict__ cols, int* __restrict__ out, int n, int total) {
  extern __shared__ int smem[];
  int* s_own = smem;                   // [kBlockSlots]
  int* s_off = s_own + kBlockSlots;    // [kPiece]
  int* s_end = s_off + kPiece;         // [kPiece]
  int* s_val = s_end + kPiece;         // [K][kPiece]
  __shared__ int s_bound[2];
  const int p0 = blockIdx.x * kBlockSlots;
  const int slots = min(kBlockSlots, total - p0);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int ub = upper_bound_warp(offsets, n, warp == 0 ? p0 : p0 + slots - 1);
    if ((threadIdx.x & 31) == 0) s_bound[warp] = ub;
  }
  __syncthreads();
  // the window: the intervals that can own one of the block's slots
  const int wlo = max(s_bound[0] - 1, 0);
  const int w = s_bound[1] - wlo;
  if (w <= kPiece) {
    for (int e = threadIdx.x; e < w; e += kThreads) {
      s_off[e] = __ldg(offsets + wlo + e);
      s_end[e] = __ldg(ends + wlo + e);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        s_val[c * kPiece + e] = __ldg(cols + static_cast<size_t>(c) * n + wlo + e);
      }
    }
    __syncthreads();
    expand_block<K, true>(offsets, ends, cols, out, n, total, p0, slots, wlo, w, s_own, s_off,
                          s_end, s_val);
  } else {
    expand_block<K, false>(offsets, ends, cols, out, n, total, p0, slots, wlo, w, s_own, s_off,
                           s_end, s_val);
  }
}

template <int K>
cudaError_t launch(const int* offsets, const int* ends, const int* cols, int* out, int n,
                   int total, cudaStream_t stream) {
  const size_t smem = smem_words(K) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expand_intervals_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (total + kBlockSlots - 1) / kBlockSlots;
  expand_intervals_kernel<K><<<blocks, kThreads, smem, stream>>>(offsets, ends, cols, out, n,
                                                                 total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Slots a block owns, and the largest window it stages in shared memory.
int gs_expand_intervals_block_slots() { return kBlockSlots; }
int gs_expand_intervals_window_piece() { return kPiece; }

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
