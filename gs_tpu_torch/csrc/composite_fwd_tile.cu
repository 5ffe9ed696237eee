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
//   - per pixel, the rules of B1, whose pixel state, per-pair step and mask
//     walk it shares (composite_warps.cuh's FwdPixels: power > 0 cull, alpha
//     < 1/255 skip, T * (1 - alpha) < 1e-4 stop with T kept at its value
//     before the stop, ncon = position + 1), and B1's per-chunk
//     __syncthreads_and death test that leaves the tile, so B3 and B1
//     return the same bits;
//   - before the block leaves, it waits for its outstanding copy group.
// TMA, mbarriers and warp specialisation are left for later.
//
// What bounds it: instruction issue of the pair x pixel evaluations, as B1
// (~22 fp32 operations and one expf each, against 36 bytes per pair read
// once per tile). A warp evaluates only the pairs that reach its rectangle
// (on the heavy scene ~6% of them, tests/test_torch_cull.py), and what is
// left is those evaluations, the float64 extents, and the per-chunk
// barrier, at which the block waits for its busiest warp.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "composite_warps.cuh"
#include "stage_rows.cuh"

namespace {

using namespace gs_warps;

constexpr int kSubchunks = 4;  // chunks per superstep (gs_tpu DMA_SUBCHUNKS)

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
  const int tile = tile_ids[m];
  const int start = starts[m];
  const int end = ends[m];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  FwdPixels<PPT> pix;
  const float4 wrect = pix.template init<kThreads>(layout, tile, tiles_x, tile_w, tile_h);
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
      const bool all_done = pix.walk_chunk(s_sup + ci * chunk * kAttrW, s_mask + ci * chunk,
                                           1u << warp, min(chunk, end - i0), i0);
      // also the barrier before the ring slot and the masks are refilled
      if (__syncthreads_and(all_done)) {
        stopped = true;
        break;
      }
    }
  }
  gs_stage::wait<0>();  // an early exit leaves the prefetched superstep in flight

  pix.template store<kThreads>(layout, m, tile_w, tile_h, color, t_final, ncon);
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

// f(integral_constant PPT, integral_constant WARPS) for the instantiation of
// the (pixels a thread, warps) pair, `otherwise` if there is none
template <class F>
int with_layout(int ppt, int warps, int otherwise, F f) {
#define GS_FWD_TILE_CASE(P, W) \
  if (ppt == P && warps == W)  \
    return f(std::integral_constant<int, P>{}, std::integral_constant<int, W>{});
  // the (pixels a thread, warps) pairs choose_layout can return
  GS_FWD_TILE_CASE(1, 1) GS_FWD_TILE_CASE(2, 1) GS_FWD_TILE_CASE(3, 1) GS_FWD_TILE_CASE(4, 1)
  GS_FWD_TILE_CASE(3, 2) GS_FWD_TILE_CASE(4, 2)
  GS_FWD_TILE_CASE(3, 4) GS_FWD_TILE_CASE(4, 4)
  GS_FWD_TILE_CASE(2, 8) GS_FWD_TILE_CASE(3, 8) GS_FWD_TILE_CASE(4, 8) GS_FWD_TILE_CASE(5, 8)
  GS_FWD_TILE_CASE(6, 8) GS_FWD_TILE_CASE(7, 8) GS_FWD_TILE_CASE(8, 8)
#undef GS_FWD_TILE_CASE
  return otherwise;
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_fwd_tile_max_pixels() { return 32 * kMaxWarps * kMaxPixelsPerThread; }

// Warps an SM holds at once for this tile size and chunk (the occupancy
// calculator's blocks an SM times the block's warps), -1 on an error.
int gs_composite_fwd_tile_resident_warps(int tile_w, int tile_h, int chunk) {
  int warps;
  Layout layout;
  const int ppt = choose_layout(tile_w, tile_h, &warps, &layout);
  return with_layout(ppt, warps, -1, [&](auto P, auto W) {
    constexpr int kWarps = decltype(W)::value;
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, composite_fwd_tile_kernel<decltype(P)::value, kWarps>, kWarps * 32,
        smem_words(chunk) * sizeof(float));
    return err == cudaSuccess ? blocks * kWarps : -1;
  });
}

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
  return with_layout(ppt, warps, static_cast<int>(cudaErrorInvalidValue), [&](auto P, auto W) {
    return static_cast<int>(launch<decltype(P)::value, decltype(W)::value>(
        attr, tile_ids, starts, ends, color, t_final, ncon, m, tiles_x, tile_w, tile_h, chunk,
        layout, s));
  });
}

}  // extern "C"
