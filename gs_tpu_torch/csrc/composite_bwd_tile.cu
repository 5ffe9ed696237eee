// Backward tile compositing for Hopper (sm_90a), tile-walk form: the
// gradient of each (tile, splat) pair's packed attributes, walked back to
// front through a two-slot shared-memory ring.
//
// Replaces the TPU kernel gs_tpu/ops/rasterize_pallas.py::_bwd_tile_kernel
// (entered through _composite_bwd_pallas_tile; gs_tpu runs it instead of
// _bwd_kernel when the pair buffer is large). Same contract as
// composite_bwd.cu (B2): for tile m, walk the pairs [starts[m], ends[m]) of
// the packed [B, 9] attribute table (ends trimmed to the tile's last
// contributor) from the back, and return
//   d_attr [B, 9] = d mean xy | d conic abc | d rgb | d opacity,
// exactly 0 in every row that no tile's trimmed range covers. The per-pixel
// math (T rebuilt from T_final, the suffix sum of w * b, d_alpha, d_power
// and the chains) is B2's; composite_bwd.cu's header derives it.
//
// Design. The Pallas kernel gives each tile one grid step and walks its
// supersteps of DMA_SUBCHUNKS chunks last to first, with double-buffered
// loads and double-buffered stores of each superstep's gradient block. A
// tile's top (partial) superstep stores zero rows past its own range, into
// rows of later tiles: the TPU's in-order grid lets those tiles rewrite them
// afterwards, and a mask pass zeroes rows no step wrote. CUDA blocks run
// at the same time, so that store would race with the next tile's block.
// Here B2's design walks the rows of the Pallas kernel's ring:
//   - one block owns one tile, with B2's layout (composite_warps.cuh): the
//     fewest warps whose 8x4-pixel cells cover the tile, 8 warps of 24x8
//     pixels at 48x32, 2 of 16x8 at 16x16, each lane holding its pixels'
//     state in registers (T, the suffix sum, g_color, g_T * T_final, ncon);
//   - blocks take the tiles longest range first (`order`, from the
//     wrapper): the heavy scene's trimmed ranges run from 192 to 832 pairs,
//     and in index order the last wave of blocks waits on whichever long
//     tiles come last;
//   - supersteps of 4 chunks are loaded last to first through the cp.async
//     two-slot ring of stage_rows.cuh: superstep k - 1's copy is issued
//     before superstep k is computed;
//   - once a superstep has landed, one thread a pair computes the pair's
//     extent (pair_extent) into shared memory beside the ring;
//   - per chunk, last first, each warp walks the chunk's pairs back to
//     front, skips those whose extent misses its rectangle, and sends the
//     9 sums of 3 counted pairs through B2's 31-shuffle reduce-scatter into
//     the warp's partials (zeroed per chunk), which are summed in warp order
//     into the chunk's rows of d_attr, inside [start, end). Chunks, batches,
//     reduction and warp order are B2's, and a skipped pair is one no lane
//     of the warp counts, so B4 returns B2's bits on the same inputs;
//   - the wrapper zeroes d_attr on the stream first, which gives gs_tpu's
//     masked result without a mask pass: no block writes outside its range.
// TMA, mbarriers and warp specialisation are left for later.
//
// What bounds it: instruction issue of the pair x pixel evaluations, as B2
// (~50 fp32 operations, an expf and two IEEE divisions per counted
// evaluation, against 36 bytes per pair read and 36 written). The extent
// test keeps warps away from pairs that cannot reach their pixels; what is
// left is the divergent evaluation of the reached ones.

#include <cuda_runtime.h>

#include <cstddef>

#include "composite_warps.cuh"
#include "stage_rows.cuh"

namespace {

using namespace gs_warps;

constexpr int kSubchunks = 4;  // chunks per superstep (gs_tpu DMA_SUBCHUNKS)

// Shared memory, in 4-byte words: the load ring, the superstep's extents
// (float4, 16-byte aligned as every slot is a whole 16 bytes), the warps'
// partials.
__host__ __device__ constexpr size_t box_offset(int chunk) {
  return 2 * static_cast<size_t>(gs_stage::slot_floats(kSubchunks * chunk));
}
__host__ __device__ constexpr size_t part_offset(int chunk) {
  return box_offset(chunk) + 4 * static_cast<size_t>(kSubchunks) * chunk;
}
__host__ __device__ constexpr size_t smem_words(int chunk, int warps) {
  return part_offset(chunk) + static_cast<size_t>(warps) * chunk * kAttrW;
}

template <int PPT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, min_blocks(PPT, WARPS))
composite_bwd_tile_kernel(const float* __restrict__ attr, const int* __restrict__ order,
                          const int* __restrict__ tile_ids, const int* __restrict__ starts,
                          const int* __restrict__ ends, const float* __restrict__ t_final,
                          const int* __restrict__ ncon, const float* __restrict__ g_color,
                          const float* __restrict__ gt_term, float* __restrict__ d_attr,
                          int tiles_x, int tile_w, int tile_h, int chunk, Layout layout) {
  constexpr int kThreads = WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  const int sup = kSubchunks * chunk;
  const int slot_stride = gs_stage::slot_floats(sup);
  float4* s_box = reinterpret_cast<float4*>(smem + box_offset(chunk));  // [sup]
  float* s_part = smem + part_offset(chunk);                             // [WARPS, chunk, 9]
  const int m = order[blockIdx.x];
  const int start = starts[m];
  const int end = ends[m];
  if (end <= start) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  Pixels<PPT> pix;
  const float4 wrect = pix.template load<kThreads>(layout, m, tile_ids[m], tiles_x, tile_w,
                                                   tile_h, t_final, ncon, g_color, gt_term);
  float* part = s_part + warp * chunk * kAttrW;

  // The range's end is read from shared memory after each barrier, and the
  // chunks are walked by their offset in the superstep: fewer values live
  // across the pair walk, which lets ptxas fit 8 warps of 6 pixels in 128
  // registers without spilling.
  __shared__ int s_end;
  if (threadIdx.x == 0) s_end = end;

  // superstep k holds rows start + k sup ..; it sits in ring slot k & 1
  const int top = (end - start - 1) / sup;
  gs_stage::stage_async(smem + (top & 1) * slot_stride, attr, start + top * sup,
                        end - start - top * sup, kThreads);
  gs_stage::commit();
  int row0 = start + top * sup;
  for (int k = top; k >= 0; --k, row0 -= sup) {  // the last superstep first
    if (k > 0) {  // slot (k - 1) & 1 was last read in superstep k + 1
      gs_stage::stage_async(smem + ((k - 1) & 1) * slot_stride, attr, row0 - sup, sup, kThreads);
    }
    gs_stage::commit();
    gs_stage::wait<1>();  // superstep k's group has landed
    __syncthreads();      // ... for every thread's copies; superstep k + 1 is done
    const float* s_sup = gs_stage::staged(smem + (k & 1) * slot_stride, attr, row0);
    const int rows = min(sup, s_end - row0);
    for (int e = threadIdx.x; e < rows; e += kThreads) {
      s_box[e] = pair_extent(s_sup + e * kAttrW);
    }
    for (int off = (rows - 1) / chunk * chunk; off >= 0; off -= chunk) {  // the last chunk first
      __syncthreads();  // the extents are in; the last chunk's sums have read the partials
      for (int e = lane; e < chunk * kAttrW; e += 32) part[e] = 0.0f;
      __syncwarp();
      reduce_chunk(min(chunk, s_end - row0 - off), row0 + off, s_sup + off * kAttrW, s_box + off,
                   wrect, pix, part);
      __syncthreads();  // every warp's partials of the chunk are in
      store_warp_sums<WARPS>(s_part, chunk, min(chunk, s_end - row0 - off),
                             d_attr + static_cast<size_t>(row0 + off) * kAttrW);
    }
  }
  gs_stage::wait<0>();
}

template <int PPT, int WARPS>
cudaError_t launch(const float* attr, const int* order, const int* tile_ids, const int* starts,
                   const int* ends, const float* t_final, const int* ncon,
                   const float* g_color, const float* gt_term, float* d_attr, int m,
                   int tiles_x, int tile_w, int tile_h, int chunk, Layout layout,
                   cudaStream_t stream) {
  const size_t smem = smem_words(chunk, WARPS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_tile_kernel<PPT, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  composite_bwd_tile_kernel<PPT, WARPS><<<m, WARPS * 32, smem, stream>>>(
      attr, order, tile_ids, starts, ends, t_final, ncon, g_color, gt_term, d_attr, tiles_x,
      tile_w, tile_h, chunk, layout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_bwd_tile_max_pixels() { return 32 * kMaxWarps * kMaxPixelsPerThread; }

// Zeroes d_attr, then launches on `stream`; returns the first CUDA error
// (0 on success). attr [B, 9] f32; order [m] i32 (a permutation of the
// tiles: block b takes tile order[b]); tile_ids/starts/ends [m] i32 (ends
// trimmed to each tile's last contributor); t_final [m, P] f32; ncon [m, P]
// i32; g_color [m, P, 3] f32; gt_term [m, P] f32 (g_T * t_final);
// d_attr [B, 9] f32; all contiguous on the device.
int gs_composite_bwd_tile(const float* attr, const int* order, const int* tile_ids,
                          const int* starts, const int* ends, const float* t_final,
                          const int* ncon, const float* g_color, const float* gt_term,
                          float* d_attr, int num_pairs, int m, int tiles_x, int tile_w,
                          int tile_h, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      d_attr, 0, static_cast<size_t>(num_pairs) * kAttrW * sizeof(float), s);
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int warps;
  Layout layout;
  const int ppt = choose_layout(tile_w, tile_h, &warps, &layout);
#define GS_BWD_TILE_CASE(P, W)                                                            \
  if (ppt == P && warps == W)                                                             \
    return launch<P, W>(attr, order, tile_ids, starts, ends, t_final, ncon, g_color,      \
                        gt_term, d_attr, m, tiles_x, tile_w, tile_h, chunk, layout, s);
  // the (pixels a thread, warps) pairs choose_layout can return
  GS_BWD_TILE_CASE(1, 1) GS_BWD_TILE_CASE(2, 1) GS_BWD_TILE_CASE(3, 1) GS_BWD_TILE_CASE(4, 1)
  GS_BWD_TILE_CASE(3, 2) GS_BWD_TILE_CASE(4, 2)
  GS_BWD_TILE_CASE(3, 4) GS_BWD_TILE_CASE(4, 4)
  GS_BWD_TILE_CASE(2, 8) GS_BWD_TILE_CASE(3, 8) GS_BWD_TILE_CASE(4, 8) GS_BWD_TILE_CASE(5, 8)
  GS_BWD_TILE_CASE(6, 8) GS_BWD_TILE_CASE(7, 8) GS_BWD_TILE_CASE(8, 8)
#undef GS_BWD_TILE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
