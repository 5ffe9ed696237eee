// Asynchronous staging of packed pair rows into shared memory (cp.async),
// shared by the tile-walk compositing kernels composite_{fwd,bwd}_tile.cu.
//
// A slot holds up to `rows` rows of the [B, 9] float32 attribute table. A
// run of rows starts anywhere within 16 bytes, so it is placed in its slot
// shifted by the source's misalignment (0-3 floats): source and destination
// then share their alignment, the body goes as 16-byte cp.async.cg copies
// and only a ragged head and tail (when a run does not start or end on a
// 16-byte boundary) as 4-byte cp.async.ca copies. For chunk-aligned runs of
// a multiple of 4 rows in a 16-byte-aligned table there is no head or tail.

#pragma once

#include <cstddef>
#include <cstdint>

namespace gs_stage {

constexpr int kAttrW = 9;

// floats of one slot for `rows` rows: the rows, up to 3 floats of shift,
// rounded to a whole 16 bytes so that consecutive slots stay aligned
__host__ __device__ constexpr int slot_floats(int rows) {
  return (rows * kAttrW + 3 + 3) / 4 * 4;
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_address(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_address(dst)),
               "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where row `row0` of `attr` lands in `slot`.
__device__ __forceinline__ const float* staged(const float* slot, const float* attr, int row0) {
  const float* src = attr + static_cast<size_t>(row0) * kAttrW;
  return slot + ((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Issues (does not wait for) the copies of rows [row0, row0 + rows) of attr
// into slot; every thread of the block calls it with the same arguments.
__device__ __forceinline__ void stage_async(float* slot, const float* attr, int row0, int rows,
                                            int threads) {
  const float* src = attr + static_cast<size_t>(row0) * kAttrW;
  float* dst = const_cast<float*>(staged(slot, attr, row0));
  const int nf = rows * kAttrW;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - mis) & 3, nf);
  const int nvec = (nf - head) >> 2;
  for (int e = threadIdx.x; e < head; e += threads) copy4(dst + e, src + e);
  for (int v = threadIdx.x; v < nvec; v += threads) {
    copy16(dst + head + 4 * v, src + head + 4 * v);
  }
  for (int e = head + 4 * nvec + threadIdx.x; e < nf; e += threads) copy4(dst + e, src + e);
}

}  // namespace gs_stage
