// Backward tile compositing for Hopper (sm_90a): the gradient of each
// (tile, splat) pair's packed attributes, walked back to front.
//
// Replaces the TPU kernel gs_tpu/ops/rasterize_pallas.py::_bwd_kernel
// (entered through composite_bwd_pallas; math in _bwd_chunk_math and
// rasterize_tiled._backward_chunk). Same contract: for tile m, walk the pairs
// [starts[m], ends[m]) of the packed [B, 9] attribute table (ends trimmed to
// the tile's last contributor) from the back, and return
//   d_attr [B, 9] = d mean xy | d conic abc | d rgb | d opacity,
// exactly 0 in every row that no tile's range covers. Per pixel, with the
// forward's final transmittance T_final and contributor count ncon:
//   T_before = T_after / (1 - alpha)           (rebuilt from T_final)
//   b = rgb . g_color, S_after = sum over later contributors of w * b
//   d_alpha = T_before * b - (S_after + g_T * T_final) / (1 - alpha)
//   d_power = opac * exp(power) * d_alpha      (the 0.99 cap ignored, as in
//                                               gs_tpu and the reference)
// and the chains to conic, mean, rgb and opacity. A pair counts at a pixel
// only where the forward counted it: power <= 0, alpha >= 1/255 and
// position < ncon[pixel].
//
// Design. The Pallas kernel relies on the TPU's in-order grid: it finds a
// tile's first step by comparing with the previous one, keeps the running
// transmittance and suffix sum in VMEM scratch across steps, and zeroes
// uncovered blocks by giving them to dead grid steps. CUDA blocks run
// concurrently and in no order, so, as in composite_fwd.cu, one block owns
// one whole tile and walks its chunks in a loop, last chunk first:
//   - the block has 1, 2, 4 or 8 warps, the fewest whose compact pixel
//     rectangles cover the tile with at most 4 cells of 8x4 pixels a warp
//     (else 8): lane l holds pixel (l % 8, l / 8) of each of its warp's PPT
//     cells, and keeps those pixels in registers (T, the suffix sum,
//     g_color, g_T * T_final, ncon). 16x16 tiles take 2 warps of 16x8
//     pixels (PPT 4), 48x32 tiles 8 warps of 24x8 (PPT 6); tiles no grid
//     covers take 8 warps and the strided map, pixel tid + k * 256. Fewer
//     warps a tile means fewer warps reducing each pair;
//   - per chunk, the block stages chunk x 9 floats in shared memory, and one
//     thread per pair computes the pair's conservative screen extent: the
//     axis-aligned box of the ellipse opac * exp(power) >= 1/255, from the
//     conic's inverse, widened to cover float rounding (pair_extent);
//   - each warp walks the chunk's pairs back to front. A pair whose box
//     misses the warp's pixel rectangle is skipped by the whole warp: no
//     pixel of the warp could pass the forward's tests for it, so T and the
//     suffix sum are unchanged and every contribution decision is the one
//     the plain version takes. Otherwise every thread adds its pixels'
//     terms of the pair's 9 gradients; a pair no lane counted is dropped;
//   - the 9 sums of kBatch = 3 counted pairs are kept in registers and
//     reduced over the warp together by a reduce-scatter (each of 5 xor
//     rounds halves the values a lane holds): 31 shuffles for 27 sums
//     instead of 3 x 9 x 5 = 135, and lane l ends with sum l, which it
//     stores in the warp's partials ([warps][chunk][9], zeroed per chunk);
//   - after the chunk, the warp partials of each value are summed in warp
//     order and stored to the pair's own row. Every row belongs to one tile,
//     so there are no atomics and the sums come out in a fixed order: the
//     result does not change from run to run;
//   - the wrapper zeroes d_attr on the stream first, so rows outside every
//     range (past a trimmed end, padding, unlisted tiles) are exactly 0.
// The TPU kernel's bf16-split matrix-unit products, log-step scans and
// moment / power matrix formulations exist only for the TPU; here every sum
// is a plain fp32 multiply-add. T and the suffix sum go pair by pair, in the
// order the plain PyTorch version (rasterize_cuda.composite_bwd_torch)
// follows, and the library is compiled with --fmad=false, IEEE divisions
// and accurate expf, so every pixel's values are computed as the plain
// version computes them: the tests (power, alpha, position < ncon) and so
// every contribution decision, T and the suffix sum, and each pixel's
// terms. Only the order of the sums over the tile's pixels differs.
//
// What bounds it: instruction issue of the pair x pixel evaluations. Each
// evaluation that passes the tests needs ~50 fp32 operations, an expf and
// two IEEE divisions, against 36 bytes per pair read once per tile and 36
// written, so the floor is the fp32 rate (chip_smoke.py's count). The
// design before this one reduced every pair over all 8 warps of a tile with
// 45 shuffles each, ~1 warp-shuffle per clock per SM, which set its pace.
// Now a counted pair costs a warp ~10 shuffles, fewer warps share a 16x16
// tile, and what remains is the evaluation itself: a warp runs the whole
// contribution path for a pixel slot as soon as one of its lanes counts
// the pair there, so its lanes are busy only where the pair contributes,
// and each division is a multi-instruction sequence. PERF.md has the
// measured times.
//
// The layout, the extent, the pixel state and the batched reduction live in
// composite_warps.cuh, which the tile-walk kernels share.

#include <cuda_runtime.h>

#include <cstddef>

#include "composite_warps.cuh"

namespace {

using namespace gs_warps;

// Shared memory, in 4-byte words: each pair's extent (float4), the chunk's
// attributes, the warps' partials.
__host__ __device__ constexpr size_t attr_offset(int chunk) { return 4 * static_cast<size_t>(chunk); }
__host__ __device__ constexpr size_t part_offset(int chunk) {
  return attr_offset(chunk) + static_cast<size_t>(chunk) * kAttrW;
}
__host__ __device__ constexpr size_t smem_words(int chunk, int warps) {
  return part_offset(chunk) + static_cast<size_t>(warps) * chunk * kAttrW;
}

template <int PPT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, min_blocks(PPT, WARPS))
composite_bwd_kernel(const float* __restrict__ attr, const int* __restrict__ tile_ids,
                     const int* __restrict__ starts, const int* __restrict__ ends,
                     const float* __restrict__ t_final, const int* __restrict__ ncon,
                     const float* __restrict__ g_color, const float* __restrict__ gt_term,
                     float* __restrict__ d_attr, int tiles_x, int tile_w, int tile_h,
                     int chunk, Layout layout) {
  constexpr int kThreads = WARPS * 32;
  extern __shared__ __align__(16) float smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);  // [chunk]
  float* s_attr = smem + attr_offset(chunk);         // [chunk, 9]
  float* s_part = smem + part_offset(chunk);         // [WARPS, chunk, 9]
  const int m = blockIdx.x;
  const int start = starts[m];
  const int end = ends[m];
  if (end <= start) return;
  const int warp = threadIdx.x >> 5;

  Pixels<PPT> pix;
  const float4 wrect = pix.template load<kThreads>(layout, m, tile_ids[m], tiles_x, tile_w,
                                                   tile_h, t_final, ncon, g_color, gt_term);
  float* part = s_part + warp * chunk * kAttrW;

  const int n_chunks = (end - start + chunk - 1) / chunk;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int i0 = start + c * chunk;
    const int n = min(chunk, end - i0);
    __syncthreads();  // the previous chunk's reads of shared memory are done
    const float* src = attr + static_cast<size_t>(i0) * kAttrW;
    for (int e = threadIdx.x; e < n * kAttrW; e += kThreads) s_attr[e] = src[e];
    for (int e = threadIdx.x; e < WARPS * chunk * kAttrW; e += kThreads) s_part[e] = 0.0f;
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += kThreads) s_box[e] = pair_extent(s_attr + e * kAttrW);
    __syncthreads();
    reduce_chunk(n, i0, s_attr, s_box, wrect, pix, part);
    __syncthreads();

    store_warp_sums<WARPS>(s_part, chunk, n, d_attr + static_cast<size_t>(i0) * kAttrW);
  }
}

template <int PPT, int WARPS>
cudaError_t launch(const float* attr, const int* tile_ids, const int* starts, const int* ends,
                   const float* t_final, const int* ncon, const float* g_color,
                   const float* gt_term, float* d_attr, int m, int tiles_x, int tile_w,
                   int tile_h, int chunk, Layout layout, cudaStream_t stream) {
  const size_t smem = smem_words(chunk, WARPS) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel<PPT, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  composite_bwd_kernel<PPT, WARPS><<<m, WARPS * 32, smem, stream>>>(
      attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term, d_attr, tiles_x, tile_w,
      tile_h, chunk, layout);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_bwd_max_pixels() { return 32 * kMaxWarps * kMaxPixelsPerThread; }

// Zeroes d_attr, then launches on `stream`; returns the first CUDA error
// (0 on success). attr [B, 9] f32; tile_ids/starts/ends [m] i32 (ends
// trimmed to each tile's last contributor); t_final [m, P] f32; ncon [m, P]
// i32; g_color [m, P, 3] f32; gt_term [m, P] f32 (g_T * t_final);
// d_attr [B, 9] f32; all contiguous on the device.
int gs_composite_bwd(const float* attr, const int* tile_ids, const int* starts, const int* ends,
                     const float* t_final, const int* ncon, const float* g_color,
                     const float* gt_term, float* d_attr, int num_pairs, int m, int tiles_x,
                     int tile_w, int tile_h, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      d_attr, 0, static_cast<size_t>(num_pairs) * kAttrW * sizeof(float), s);
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  int warps;
  Layout layout;
  const int ppt = choose_layout(tile_w, tile_h, &warps, &layout);
#define GS_BWD_CASE(P, W)                                                                      \
  if (ppt == P && warps == W)                                                                  \
    return launch<P, W>(attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term, d_attr, \
                        m, tiles_x, tile_w, tile_h, chunk, layout, s);
  // the (pixels a thread, warps) pairs choose_layout can return
  GS_BWD_CASE(1, 1) GS_BWD_CASE(2, 1) GS_BWD_CASE(3, 1) GS_BWD_CASE(4, 1)
  GS_BWD_CASE(3, 2) GS_BWD_CASE(4, 2)
  GS_BWD_CASE(3, 4) GS_BWD_CASE(4, 4)
  GS_BWD_CASE(2, 8) GS_BWD_CASE(3, 8) GS_BWD_CASE(4, 8) GS_BWD_CASE(5, 8)
  GS_BWD_CASE(6, 8) GS_BWD_CASE(7, 8) GS_BWD_CASE(8, 8)
#undef GS_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
