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
//   - one block owns one tile, with the warp layout of composite_warps.cuh:
//     the fewest warps whose 8x4-pixel cells cover the tile (8 warps of 24x8
//     pixels at 48x32, 2 of 16x8 at 16x16); each lane keeps its pixels' T,
//     rgb, ncon and died in registers;
//   - the tile's range goes through a two-slot shared-memory ring of
//     supersteps of 4 chunks (9,232 B a slot at chunk 64), filled with
//     cp.async (stage_rows.cuh); superstep i + 1's copy is issued before
//     superstep i is computed, and only rows below the range's end are
//     copied, so nothing past the buffer is read (gs_tpu pads the buffer by
//     a superstep instead);
//   - once a superstep has landed, one thread a pair computes the pair's
//     extent (pair_extent) and from it the pair's warp mask: the warps whose
//     pixel rectangles the extent reaches;
//   - each warp walks the superstep's chunks front to back, in depth order,
//     over the pairs whose mask has its bit, found 32 at a ballot. A pixel
//     outside a pair's extent fails power <= 0 or alpha >= 1/255, which the
//     walk passes over without touching T, the colour or ncon, so the skips
//     change no bit. A warp whose pixels have all died skips the chunk (it
//     still meets the block's barriers, which guard the ring);
//   - per pixel, B1's rules in B1's order (power > 0 cull, alpha < 1/255
//     skip, T * (1 - alpha) < 1e-4 stop with T kept at its value before the
//     stop, ncon = position + 1), and B1's per-chunk __syncthreads_and death
//     test that leaves the tile, so B3 and B1 return the same bits;
//   - before the block leaves, it waits for its outstanding copy group.
// TMA, mbarriers and warp specialisation are left for later.
//
// What bounds it: instruction issue of the pair x pixel evaluations, as B1
// (~22 fp32 operations and one expf each, against 36 bytes per pair read
// once per tile). B1 evaluates every pair at every live pixel of the tile,
// though for most pairs most of the tile lies outside the extent; here a
// warp evaluates only the pairs that reach its rectangle (on the heavy
// scene ~6% of them, tests/test_torch_cull.py), and what is left is those
// evaluations, the float64 extents, and the per-chunk barrier, at which the
// block waits for its busiest warp.

#include <cuda_runtime.h>

#include <cstddef>

#include "composite_warps.cuh"
#include "stage_rows.cuh"

namespace {

using namespace gs_warps;

constexpr int kSubchunks = 4;  // chunks per superstep (gs_tpu DMA_SUBCHUNKS)

// The bits w < WARPS of the warps whose rectangles s_wrect[w] extent b
// reaches.
template <int WARPS>
__device__ __forceinline__ unsigned warp_mask(float4 b, const float4* s_wrect) {
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) mask |= static_cast<unsigned>(reaches(b, s_wrect[w])) << w;
  return mask;
}

// How a warp finds the pairs of a chunk whose extent reaches its rectangle
// (the others cannot change its pixels): from each pair's warp mask
// (warp_mask, computed once a pair for the whole block), 32 pairs at a
// ballot, so a pair a warp skips costs it a thirty-second of a mask test.
// next(j, n) is the first such pair at or above j, n if none.
// Warp-uniform. (The backward kernels test each pair's extent in turn,
// which measured faster there: PERF.md.)
struct MaskWalk {
  const unsigned* mask;  // the chunk's warp masks
  unsigned bit;          // the warp's bit
  __device__ __forceinline__ int next(int j, int n) const {
    const int lane = threadIdx.x & 31;
    for (int g = j; g < n; g += 32) {
      const unsigned hits = __ballot_sync(kFull, g + lane < n && (mask[g + lane] & bit) != 0);
      if (hits != 0) return g + __ffs(hits) - 1;
    }
    return n;
  }
};

// Shared memory, in 4-byte words: the load ring, the warps' rectangles
// (float4, 16-byte aligned as every slot is a whole 16 bytes), the
// superstep's warp masks.
__host__ __device__ constexpr size_t rect_offset(int chunk) {
  return 2 * static_cast<size_t>(gs_stage::slot_floats(kSubchunks * chunk));
}
__host__ __device__ constexpr size_t mask_offset(int chunk) {
  return rect_offset(chunk) + 4 * kMaxWarps;
}
__host__ __device__ constexpr size_t smem_words(int chunk) {
  return mask_offset(chunk) + static_cast<size_t>(kSubchunks) * chunk;
}

template <int PPT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, min_blocks(PPT, WARPS))
composite_fwd_tile_kernel(const float* __restrict__ attr, const int* __restrict__ tile_ids,
                          const int* __restrict__ starts, const int* __restrict__ ends,
                          float* __restrict__ color, float* __restrict__ t_final,
                          int* __restrict__ ncon, int tiles_x, int tile_w, int tile_h, int chunk,
                          Layout layout) {
  constexpr int kThreads = WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  const int sup = kSubchunks * chunk;
  const int slot_stride = gs_stage::slot_floats(sup);
  float4* s_wrect = reinterpret_cast<float4*>(smem + rect_offset(chunk));  // [WARPS]
  unsigned* s_mask = reinterpret_cast<unsigned*>(smem + mask_offset(chunk));  // [sup]
  const int m = blockIdx.x;
  const int num_pix = tile_w * tile_h;
  const int tile = tile_ids[m];
  const int start = starts[m];
  const int end = ends[m];
  const int x0 = (tile % tiles_x) * tile_w;
  const int y0 = (tile / tiles_x) * tile_h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT];
  int nc[PPT];
  bool done[PPT];
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int2 q = slot_pixel(layout, warp, lane, k, kThreads, tile_w);
    px[k] = static_cast<float>(x0 + q.x);
    py[k] = static_cast<float>(y0 + q.y);
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    nc[k] = 0;
    done[k] = !in_tile(q, tile_w, tile_h);  // slots past the tile count as dead
    if (!done[k]) {
      bx0 = min(bx0, x0 + q.x);
      bx1 = max(bx1, x0 + q.x);
      by0 = min(by0, y0 + q.y);
      by1 = max(by1, y0 + q.y);
    }
  }
  const float4 wrect = warp_rect(bx0, bx1, by0, by1);
  if (lane == 0) s_wrect[warp] = wrect;  // read after the first barrier

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
    const int rows = min(sup, end - row0);
    for (int e = threadIdx.x; e < rows; e += kThreads) {
      s_mask[e] = warp_mask<WARPS>(pair_extent(s_sup + e * kAttrW), s_wrect);
    }
    __syncthreads();  // the masks are in

    for (int ci = 0; ci < kSubchunks; ++ci) {
      const int i0 = row0 + ci * chunk;
      if (i0 >= end) break;  // the range's last superstep may be partial
      const int n = min(chunk, end - i0);
      bool all_done = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) all_done = all_done && done[k];
      if (!__all_sync(kFull, all_done)) {  // a warp whose pixels all died skips the chunk
        const MaskWalk walk{s_mask + ci * chunk, 1u << warp};
        for (int j = walk.next(0, n); j < n; j = walk.next(j + 1, n)) {
          const float* a = s_sup + (ci * chunk + j) * kAttrW;
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
        all_done = true;
#pragma unroll
        for (int k = 0; k < PPT; ++k) all_done = all_done && done[k];
      }
      // also the barrier before the ring slot and the masks are refilled
      if (__syncthreads_and(all_done)) {
        stopped = true;
        break;
      }
    }
  }
  gs_stage::wait<0>();  // an early exit leaves the prefetched superstep in flight

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int2 q = slot_pixel(layout, warp, lane, k, kThreads, tile_w);
    if (!in_tile(q, tile_w, tile_h)) continue;
    const size_t o = static_cast<size_t>(m) * num_pix + q.y * tile_w + q.x;
    color[o * 3 + 0] = cr[k];
    color[o * 3 + 1] = cg[k];
    color[o * 3 + 2] = cb[k];
    t_final[o] = T[k];
    ncon[o] = nc[k];
  }
}

template <int PPT, int WARPS>
cudaError_t launch(const float* attr, const int* tile_ids, const int* starts, const int* ends,
                   float* color, float* t_final, int* ncon, int m, int tiles_x, int tile_w,
                   int tile_h, int chunk, Layout layout, cudaStream_t stream) {
  const size_t smem = smem_words(chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_fwd_tile_kernel<PPT, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  composite_fwd_tile_kernel<PPT, WARPS><<<m, WARPS * 32, smem, stream>>>(
      attr, tile_ids, starts, ends, color, t_final, ncon, tiles_x, tile_w, tile_h, chunk, layout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_fwd_tile_max_pixels() { return 32 * kMaxWarps * kMaxPixelsPerThread; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// attr [B, 9] f32; tile_ids/starts/ends [m] i32; color [m, P, 3] f32;
// t_final [m, P] f32; ncon [m, P] i32; all contiguous on the device.
int gs_composite_fwd_tile(const float* attr, const int* tile_ids, const int* starts,
                          const int* ends, float* color, float* t_final, int* ncon, int m,
                          int tiles_x, int tile_w, int tile_h, int chunk, void* stream) {
  if (m == 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int warps;
  Layout layout;
  const int ppt = choose_layout(tile_w, tile_h, &warps, &layout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GS_FWD_TILE_CASE(P, W)                                                                 \
  if (ppt == P && warps == W)                                                                  \
    return launch<P, W>(attr, tile_ids, starts, ends, color, t_final, ncon, m, tiles_x, tile_w, \
                        tile_h, chunk, layout, s);
  // the (pixels a thread, warps) pairs choose_layout can return
  GS_FWD_TILE_CASE(1, 1) GS_FWD_TILE_CASE(2, 1) GS_FWD_TILE_CASE(3, 1) GS_FWD_TILE_CASE(4, 1)
  GS_FWD_TILE_CASE(3, 2) GS_FWD_TILE_CASE(4, 2)
  GS_FWD_TILE_CASE(3, 4) GS_FWD_TILE_CASE(4, 4)
  GS_FWD_TILE_CASE(2, 8) GS_FWD_TILE_CASE(3, 8) GS_FWD_TILE_CASE(4, 8) GS_FWD_TILE_CASE(5, 8)
  GS_FWD_TILE_CASE(6, 8) GS_FWD_TILE_CASE(7, 8) GS_FWD_TILE_CASE(8, 8)
#undef GS_FWD_TILE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
