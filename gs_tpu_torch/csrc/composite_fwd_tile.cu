// Forward tile compositing for Hopper (sm_90a), tile-walk form: front-to-back
// alpha blending of each tile's depth-ordered (tile, splat) pairs, streamed
// through a two-slot shared-memory ring.
//
// Replaces the TPU kernel gs_tpu/ops/rasterize_pallas.py::_fwd_tile_kernel
// (entered through _composite_fwd_pallas_tile; gs_tpu runs it instead of
// _fwd_kernel when the pair buffer is large, rasterize_tiled._pick_kernel_mode).
// Same contract as composite_fwd.cu (B1): per tile of P = tile_w * tile_h
// pixels, walk the pairs [starts[m], ends[m]) of the packed [B, 9] attribute
// table (mean xy | conic abc | rgb | opacity) in depth order and return
//   color [M, P, 3], t_final [M, P], ncon [M, P] (last contributor + 1).
//
// Design. The Pallas kernel gives each tile one grid step, streams the
// tile's pair rows in double-buffered "supersteps" of DMA_SUBCHUNKS chunks
// (make_async_copy into two VMEM slots, the next superstep's copy started
// before the current one is computed), tests deaths at chunk granularity,
// leaves the whole tile early, and drains the copy still in flight. Here:
//   - one 256-thread block owns one tile, with ceil(P / 256) pixels per
//     thread in registers (T, rgb, ncon, died), as in B1;
//   - the tile's range goes through a two-slot shared-memory ring of
//     supersteps of 4 chunks (9,216 B a slot at chunk 64). Each slot is
//     filled with cp.async (16-byte cp.async.cg, one commit group per
//     superstep, see stage_rows.cuh); superstep i + 1's copy is issued before
//     superstep i is computed, and only rows below the range's end are
//     copied, so nothing past the buffer is read (gs_tpu pads the buffer by a
//     superstep instead);
//   - the pair-by-pair compute and the per-chunk __syncthreads_and death
//     test are B1's, so B3 and B1 return the same bits on the same input;
//   - before the block leaves, it waits for its outstanding copy group.
// TMA, mbarriers and warp specialisation are left for later.
//
// What bounds it: arithmetic, as B1 (~22 fp32 operations and one expf per
// pair x pixel evaluation against 36 bytes per pair read once per tile). The
// ring hides the latency of the next superstep's load behind the current
// superstep's compute, which matters for the long per-tile ranges of the
// scenes that select this form.

#include <cuda_runtime.h>

#include <cstddef>

#include "stage_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPixelsPerThread = 8;  // P <= 2,048 pixels per tile
constexpr int kAttrW = gs_stage::kAttrW;
constexpr int kSubchunks = 4;  // chunks per superstep (gs_tpu DMA_SUBCHUNKS)

// the same float32 roundings of the constants as the PyTorch side
__device__ __forceinline__ float alpha_skip() { return static_cast<float>(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return static_cast<float>(0.99); }
__device__ __forceinline__ float t_eps() { return static_cast<float>(1e-4); }

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_fwd_tile_kernel(const float* __restrict__ attr, const int* __restrict__ tile_ids,
                          const int* __restrict__ starts, const int* __restrict__ ends,
                          float* __restrict__ color, float* __restrict__ t_final,
                          int* __restrict__ ncon, int tiles_x, int tile_w, int tile_h,
                          int chunk) {
  extern __shared__ __align__(16) float smem[];  // ring of 2 slots
  const int sup = kSubchunks * chunk;
  const int slot_stride = gs_stage::slot_floats(sup);
  const int m = blockIdx.x;
  const int num_pix = tile_w * tile_h;
  const int tid = tile_ids[m];
  const int start = starts[m];
  const int end = ends[m];
  const int x0 = (tid % tiles_x) * tile_w;
  const int y0 = (tid / tiles_x) * tile_h;

  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT];
  int nc[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(x0 + p % tile_w);
    py[k] = static_cast<float>(y0 + p / tile_w);
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    nc[k] = 0;
    done[k] = p >= num_pix;  // lanes past the tile count as dead
  }

  const int nsup = end > start ? (end - start + sup - 1) / sup : 0;
  if (nsup > 0) gs_stage::stage_async(smem, attr, start, min(sup, end - start), kThreads);
  gs_stage::commit();
  bool stopped = false;
  for (int i = 0; i < nsup && !stopped; ++i) {
    const int row0 = start + i * sup;
    if (i + 1 < nsup) {  // slot (i + 1) & 1 was last read in superstep i - 1
      const int next = row0 + sup;
      gs_stage::stage_async(smem + ((i + 1) & 1) * slot_stride, attr, next,
                            min(sup, end - next), kThreads);
    }
    gs_stage::commit();
    gs_stage::wait<1>();  // superstep i's group has landed
    __syncthreads();      // ... for every thread's copies
    const float* s_sup = gs_stage::staged(smem + (i & 1) * slot_stride, attr, row0);

    for (int ci = 0; ci < kSubchunks; ++ci) {
      const int i0 = row0 + ci * chunk;
      if (i0 >= end) break;  // the range's last superstep may be partial
      const int n = min(chunk, end - i0);
      const float* s_attr = s_sup + ci * chunk * kAttrW;
      for (int j = 0; j < n; ++j) {
        const float* a = s_attr + j * kAttrW;
        const float mx = a[0], my = a[1], ca = a[2], cbb = a[3], cc = a[4];
        const float r = a[5], g = a[6], b = a[7], opac = a[8];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (done[k]) continue;
          const float dx = mx - px[k];
          const float dy = my - py[k];
          const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbb * dx * dy;
          if (power > 0.0f) continue;
          const float alpha = fminf(alpha_max(), opac * expf(power));
          if (alpha < alpha_skip()) continue;
          const float t_next = T[k] * (1.0f - alpha);
          if (t_next < t_eps()) {  // dies; T keeps its value before the stop
            done[k] = true;
            continue;
          }
          const float w = alpha * T[k];
          cr[k] += w * r;
          cg[k] += w * g;
          cb[k] += w * b;
          T[k] = t_next;
          nc[k] = i0 + j + 1;
        }
      }

      bool all_done = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) all_done = all_done && done[k];
      // also the barrier before the slot is refilled
      if (__syncthreads_and(all_done)) {
        stopped = true;
        break;
      }
    }
  }
  gs_stage::wait<0>();  // an early exit leaves the prefetched superstep in flight

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p >= num_pix) continue;
    const size_t o = static_cast<size_t>(m) * num_pix + p;
    color[o * 3 + 0] = cr[k];
    color[o * 3 + 1] = cg[k];
    color[o * 3 + 2] = cb[k];
    t_final[o] = T[k];
    ncon[o] = nc[k];
  }
}

template <int PPT>
cudaError_t launch(const float* attr, const int* tile_ids, const int* starts, const int* ends,
                   float* color, float* t_final, int* ncon, int m, int tiles_x, int tile_w,
                   int tile_h, int chunk, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(gs_stage::slot_floats(kSubchunks * chunk)) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_fwd_tile_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  composite_fwd_tile_kernel<PPT><<<m, kThreads, smem, stream>>>(
      attr, tile_ids, starts, ends, color, t_final, ncon, tiles_x, tile_w, tile_h, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_fwd_tile_max_pixels() { return kThreads * kMaxPixelsPerThread; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// attr [B, 9] f32; tile_ids/starts/ends [m] i32; color [m, P, 3] f32;
// t_final [m, P] f32; ncon [m, P] i32; all contiguous on the device.
int gs_composite_fwd_tile(const float* attr, const int* tile_ids, const int* starts,
                          const int* ends, float* color, float* t_final, int* ncon, int m,
                          int tiles_x, int tile_w, int tile_h, int chunk, void* stream) {
  if (m == 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ppt = (tile_w * tile_h + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_FWD_TILE_CASE(K) \
  case K: return launch<K>(attr, tile_ids, starts, ends, color, t_final, ncon, m, tiles_x, \
                           tile_w, tile_h, chunk, s);
  switch (ppt) {
    GS_FWD_TILE_CASE(1)
    GS_FWD_TILE_CASE(2)
    GS_FWD_TILE_CASE(3)
    GS_FWD_TILE_CASE(4)
    GS_FWD_TILE_CASE(5)
    GS_FWD_TILE_CASE(6)
    GS_FWD_TILE_CASE(7)
    GS_FWD_TILE_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GS_FWD_TILE_CASE
}

}  // extern "C"
