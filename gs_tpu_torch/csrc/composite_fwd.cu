// Forward tile compositing for Hopper (sm_90a): front-to-back alpha blending
// of each tile's depth-ordered (tile, splat) pairs.
//
// Replaces the TPU kernel gs_tpu/ops/rasterize_pallas.py::_fwd_kernel
// (entered through composite_fwd_pallas; math in _fwd_chunk_math). Same
// contract: per tile of P = tile_w * tile_h pixels, walk the pairs
// [starts[m], ends[m]) of the packed [B, 9] attribute table
// (mean xy | conic abc | rgb | opacity) in depth order and return
//   color [M, P, 3], t_final [M, P], ncon [M, P] (last contributor + 1).
//
// Design. The Pallas kernel runs one grid step per chunk and relies on the
// TPU executing steps in order: it finds a tile's first chunk by comparing
// with the previous step, keeps the tile's accumulators in a revisited
// output block and the died mask in VMEM scratch. CUDA blocks run
// concurrently and in no order, so here one block owns one whole tile and
// walks its range in a loop:
//   - the warp layout of composite_warps.cuh with B1's own first limit of
//     two 8x4-pixel cells a warp (kFwdCellsPerWarp): 4 warps of 8x8 pixels,
//     2 pixels a thread, at 16x16 tiles (32 warps an SM, 64 registers); 8
//     warps of 24x8 pixels, 6 a thread, at 48x32. Each lane keeps its
//     pixels' T, rgb, ncon and died in registers (FwdPixels, shared with B3);
//   - the range streams through a two-slot shared-memory ring of supersteps
//     (superstep_chunks: 1 chunk for warps of 1-2 cells, 4 for larger ones),
//     filled with cp.async (stage_rows.cuh). While the block walks superstep
//     i, superstep i + 2 is in flight, and one thread a pair turns
//     superstep i + 1's rows into padded rows (three float4, so a warp reads
//     a pair with three loads) and a 64-bit cell mask: pair_extent's box as
//     the cells w * PPT + k it reaches (for warps of at least kCellsFrom
//     cells; smaller warps get all their bits when the box reaches the warp's
//     rectangle). One barrier a superstep guards the ring, publishes the rows
//     and masks, and tests the deaths;
//   - each warp walks the superstep front to back, 32 pairs at a ballot,
//     over the pairs with a bit of its own in a slot where some lane is still
//     alive, and steps only those slots (warp-uniform: lane l holds pixel (l
//     % 8, l / 8) of each of its cells). A pixel outside a pair's extent
//     fails power <= 0 or alpha >= 1/255, which the walk passes over without
//     touching T, the colour or ncon, so the skips change no bit;
//   - per pixel, the plain version's rules in its order (power > 0 cull,
//     alpha < 1/255 skip, T * (1 - alpha) < 1e-4 stop with T kept at its
//     value before the stop, ncon = position + 1);
//   - __syncthreads_and after each superstep leaves the tile once every
//     pixel has died (walking past a death changes no bit: dead pixels
//     skip); before the block leaves it waits for its copies in flight;
//   - a tile with starts == ends writes (0, 1, 0) directly, the result the
//     Pallas wrapper patches in with a mask.
// The TPU kernel's bf16-split matrix-unit products exist only for the TPU;
// here every sum is a plain fp32 multiply-add in pair order. Transmittance is
// multiplied pair by pair, the order the plain PyTorch version
// (rasterize_cuda.composite_fwd_torch) follows, and the library is compiled
// with --fmad=false and accurate expf, so the two take the same skip, stop
// and contribution decisions.
//
// What bounds it: arithmetic. Each pair * pixel evaluation is ~22 fp32
// operations and one expf against 36 bytes per pair read once per tile, far
// above the card's ~20 operations per byte of device memory, so the kernel is
// bound by the fp32 / special-function rate, and by how early whole tiles
// exit. The cull takes away the evaluations of pairs that cannot reach a
// warp's (or a cell's) pixels: on the bench scene, whose splats span 40-90
// pixels, a fifth of the (pair, warp) work at 16x16 and over half of the
// (pair, cell) work at 48x32 (tests/test_torch_cull.py). What is left is
// those evaluations, the float64 extents, the walk, and the barrier at
// which the block waits for its busiest warp.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "composite_warps.cuh"
#include "stage_rows.cuh"

namespace {

using namespace gs_warps;

// Warps of at least this many cells get a mask bit a cell; smaller ones,
// whose cells a pair mostly reaches together, a bit a slot for the whole
// warp (cheaper to compute, and measured faster at 16x16: PERF.md).
constexpr int kCellsFrom = 3;
constexpr int kRowW = 12;  // a staged row padded to three float4

// Chunks a superstep (a ring slot, one death test) for PPT pixels a
// thread: one for the small warps of small tiles, whose short ranges end
// early, four for the large warps of large tiles (PERF.md).
__host__ __device__ constexpr int superstep_chunks(int ppt) { return ppt >= kCellsFrom ? 4 : 1; }

// Shared memory, in 4-byte words, for supersteps of `sup` rows: the
// two-slot load ring, two supersteps' padded rows, the warps' rectangles
// (float4), two supersteps' cell masks (64-bit); every piece a whole 16
// bytes.
__host__ __device__ constexpr size_t rows_offset(int sup) {
  return 2 * static_cast<size_t>(gs_stage::slot_floats(sup));
}
__host__ __device__ constexpr size_t rect_offset(int sup) {
  return rows_offset(sup) + 2 * static_cast<size_t>(sup) * kRowW;
}
__host__ __device__ constexpr size_t mask_offset(int sup) {
  return rect_offset(sup) + 4 * kMaxWarps;
}
__host__ __device__ constexpr size_t smem_words(int sup) {
  return mask_offset(sup) + 4 * static_cast<size_t>(sup);
}

// The cells of the tile (origin x0, y0) that extent b reaches, as bits
// w * PPT + k (slot k of warp w: the warp's cell k). A cell counts when
// the extent reaches its 8x4 pixels; the arithmetic is exact in double.
// The strided map has no cells, and warps of fewer than kCellsFrom cells
// gain less from them than they cost: there a reached warp gets all its
// bits.
template <int PPT, int WARPS>
__device__ __forceinline__ unsigned long long cell_mask(float4 b, const Layout& L, int x0,
                                                        int y0, const float4* s_wrect) {
  constexpr unsigned long long kWarpBits = (1ull << PPT) - 1;
  unsigned long long mask = 0;
  if (L.warps_x == 0 || PPT < kCellsFrom) {
    const unsigned warps = warp_mask<WARPS>(b, s_wrect);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if ((warps >> w) & 1u) mask |= kWarpBits << (w * PPT);
    }
    return mask;
  }
  const double grid_w = L.warps_x * L.cells_x, grid_h = (WARPS / L.warps_x) * L.cells_y;
  // the layout grid's cells (gx, gy) with x0 + 8 gx <= b.y, x0 + 8 gx + 7 >= b.x, and so in y
  const int gx0 = static_cast<int>(fmin(fmax(ceil((b.x - 7.0 - x0) / 8.0), 0.0), grid_w));
  const int gx1 = static_cast<int>(fmax(fmin(floor((b.y - static_cast<double>(x0)) / 8.0),
                                             grid_w - 1.0), -1.0));
  const int gy0 = static_cast<int>(fmin(fmax(ceil((b.z - 3.0 - y0) / 4.0), 0.0), grid_h));
  const int gy1 = static_cast<int>(fmax(fmin(floor((b.w - static_cast<double>(y0)) / 4.0),
                                             grid_h - 1.0), -1.0));
  if (gx0 > gx1 || gy0 > gy1) return 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int cx = (w % L.warps_x) * L.cells_x;
    const int cy = (w / L.warps_x) * L.cells_y;
    const int lx0 = max(gx0 - cx, 0), lx1 = min(gx1 - cx, L.cells_x - 1);
    const int ly0 = max(gy0 - cy, 0), ly1 = min(gy1 - cy, L.cells_y - 1);
    if (lx0 > lx1 || ly0 > ly1) continue;
    const unsigned row = (2u << lx1) - (1u << lx0);
    unsigned bits = 0;
    for (int ly = ly0; ly <= ly1; ++ly) bits |= row << (ly * L.cells_x);
    mask |= static_cast<unsigned long long>(bits) << (w * PPT);
  }
  return mask;
}

// Walks a chunk of n padded rows (global positions i0 ..) front to back:
// 32 pairs at a ballot, the warp takes the pairs whose cell mask has a bit
// of its own in a slot where some lane is still alive, and steps each lane's
// pixels of just those slots (a warp-uniform choice: lane l holds pixel (l %
// 8, l / 8) of every cell). Returns whether all of this thread's pixels
// have died. Warp-uniform.
template <int PPT>
__device__ __forceinline__ bool walk_cells(FwdPixels<PPT>& pix, const float4* rows,
                                           const unsigned long long* masks, int warp, int n,
                                           int i0) {
  unsigned live = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    live |= static_cast<unsigned>(__any_sync(kFull, !pix.done[k])) << k;
  }
  if (live == 0) return true;  // the warp skips the chunk
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < n; g += 32) {
    const unsigned mine =
        g + lane < n ? static_cast<unsigned>(masks[g + lane] >> (warp * PPT)) & live : 0u;
    for (unsigned hits = __ballot_sync(kFull, mine != 0); hits != 0; hits &= hits - 1) {
      const int j = g + __ffs(hits) - 1;
      const float4 a = rows[3 * j], b = rows[3 * j + 1], c = rows[3 * j + 2];
      pix.add_pair(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, i0 + j,
                   __shfl_sync(kFull, mine, j - g));
    }
  }
  return pix.all_done();
}

template <int PPT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, fwd_min_blocks(PPT, WARPS))
composite_fwd_kernel(const float* __restrict__ attr, const int* __restrict__ tile_ids,
                     const int* __restrict__ starts, const int* __restrict__ ends,
                     float* __restrict__ color, float* __restrict__ t_final,
                     int* __restrict__ ncon, int tiles_x, int tile_w, int tile_h, int chunk,
                     Layout layout) {
  constexpr int kThreads = WARPS * 32;
  constexpr int kSup = superstep_chunks(PPT);
  extern __shared__ __align__(16) float smem[];
  const int sup = kSup * chunk;
  const int slot_stride = gs_stage::slot_floats(sup);
  float4* s_rows = reinterpret_cast<float4*>(smem + rows_offset(sup));   // [2][sup][3]
  float4* s_wrect = reinterpret_cast<float4*>(smem + rect_offset(sup));  // [WARPS]
  unsigned long long* s_mask =
      reinterpret_cast<unsigned long long*>(smem + mask_offset(sup));  // [2][sup]
  const int m = blockIdx.x;
  const int tile = tile_ids[m];
  const int start = starts[m];
  const int end = ends[m];
  const int warp = threadIdx.x >> 5;

  FwdPixels<PPT> pix;
  const float4 wrect = pix.template init<kThreads>(layout, tile, tiles_x, tile_w, tile_h);
  if ((threadIdx.x & 31) == 0) s_wrect[warp] = wrect;

  const int nsup = end > start ? (end - start + sup - 1) / sup : 0;
  // superstep c's rows land in ring slot c & 1; every call commits one group
  auto stage = [&](int c) {
    const int row0 = start + c * sup;
    if (c < nsup) {
      gs_stage::stage_async(smem + (c & 1) * slot_stride, attr, row0, min(sup, end - row0),
                            kThreads);
    }
    gs_stage::commit();
  };
  // superstep c's rows padded to s_rows[c & 1] and their cell masks to
  // s_mask[c & 1], a thread a pair
  auto prepare = [&](int c) {
    const int row0 = start + c * sup;
    const float* raw = gs_stage::staged(smem + (c & 1) * slot_stride, attr, row0);
    float4* rows = s_rows + (c & 1) * sup * 3;
    for (int e = threadIdx.x; e < min(sup, end - row0); e += kThreads) {
      const float* a = raw + e * kAttrW;
      s_mask[(c & 1) * sup + e] = cell_mask<PPT, WARPS>(
          pair_extent(a), layout, (tile % tiles_x) * tile_w, (tile / tiles_x) * tile_h, s_wrect);
      rows[3 * e] = make_float4(a[0], a[1], a[2], a[3]);
      rows[3 * e + 1] = make_float4(a[4], a[5], a[6], a[7]);
      rows[3 * e + 2] = make_float4(a[8], 0.0f, 0.0f, 0.0f);
    }
  };

  stage(0);
  stage(1);
  gs_stage::wait<1>();  // superstep 0 has landed
  __syncthreads();      // ... for every thread's copies, and the rectangles are in
  if (nsup > 0) prepare(0);
  gs_stage::wait<0>();  // superstep 1 has landed
  __syncthreads();      // superstep 0 is prepared
  for (int i = 0; i < nsup; ++i) {
    // ring slot i & 1 was last read by prepare(i), before the last barrier
    stage(i + 2);
    // s_rows / s_mask[(i + 1) & 1] last served superstep i - 1's walk
    if (i + 1 < nsup) prepare(i + 1);
    const float4* rows = s_rows + (i & 1) * sup * 3;
    const unsigned long long* masks = s_mask + (i & 1) * sup;
    bool all_done = false;
    for (int ci = 0; ci < kSup; ++ci) {
      const int i0 = start + i * sup + ci * chunk;
      if (i0 >= end) break;  // the range's last superstep may be partial
      all_done = walk_cells(pix, rows + 3 * ci * chunk, masks + ci * chunk, warp,
                            min(chunk, end - i0), i0);
    }
    gs_stage::wait<0>();  // superstep i + 2 has landed
    // publishes superstep i + 1's rows and masks, frees ring slot i & 1;
    // leaves the tile once every pixel has died
    if (__syncthreads_and(all_done)) break;
  }
  gs_stage::wait<0>();  // an early exit may leave a copy in flight

  pix.template store<kThreads>(layout, m, tile_w, tile_h, color, t_final, ncon);
}

template <int PPT, int WARPS>
cudaError_t launch(const float* attr, const int* tile_ids, const int* starts, const int* ends,
                   float* color, float* t_final, int* ncon, int m, int tiles_x, int tile_w,
                   int tile_h, int chunk, Layout layout, cudaStream_t stream) {
  const size_t smem = smem_words(superstep_chunks(PPT) * chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_fwd_kernel<PPT, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  composite_fwd_kernel<PPT, WARPS><<<m, WARPS * 32, smem, stream>>>(
      attr, tile_ids, starts, ends, color, t_final, ncon, tiles_x, tile_w, tile_h, chunk, layout);
  return cudaGetLastError();
}

int fwd_layout(int tile_w, int tile_h, int* warps, Layout* layout) {
  return choose_layout(tile_w, tile_h, warps, layout, kFwdCellsPerWarp);
}

// f(integral_constant PPT, integral_constant WARPS) for the instantiation of
// the (pixels a thread, warps) pair, `otherwise` if there is none
template <class F>
int with_layout(int ppt, int warps, int otherwise, F f) {
#define GS_FWD_CASE(P, W)     \
  if (ppt == P && warps == W) \
    return f(std::integral_constant<int, P>{}, std::integral_constant<int, W>{});
  // the (pixels a thread, warps) pairs fwd_layout can return
  GS_FWD_CASE(1, 1) GS_FWD_CASE(2, 1) GS_FWD_CASE(2, 2) GS_FWD_CASE(2, 4) GS_FWD_CASE(2, 8)
  GS_FWD_CASE(3, 8) GS_FWD_CASE(4, 8) GS_FWD_CASE(5, 8) GS_FWD_CASE(6, 8) GS_FWD_CASE(7, 8)
  GS_FWD_CASE(8, 8)
#undef GS_FWD_CASE
  return otherwise;
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_fwd_max_pixels() { return 32 * kMaxWarps * kMaxPixelsPerThread; }

// Warps an SM holds at once for this tile size and chunk (the occupancy
// calculator's blocks an SM times the block's warps), -1 on an error.
int gs_composite_fwd_resident_warps(int tile_w, int tile_h, int chunk) {
  int warps;
  Layout layout;
  const int ppt = fwd_layout(tile_w, tile_h, &warps, &layout);
  return with_layout(ppt, warps, -1, [&](auto P, auto W) {
    constexpr int kPpt = decltype(P)::value, kWarps = decltype(W)::value;
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, composite_fwd_kernel<kPpt, kWarps>, kWarps * 32,
        smem_words(superstep_chunks(kPpt) * chunk) * sizeof(float));
    return err == cudaSuccess ? blocks * kWarps : -1;
  });
}

// The layout fwd_layout gives this tile size: warps * 10000 + pixels a
// thread * 100 + cells a warp (0 for the strided map).
int gs_composite_fwd_layout(int tile_w, int tile_h) {
  int warps;
  Layout layout;
  const int ppt = fwd_layout(tile_w, tile_h, &warps, &layout);
  return warps * 10000 + ppt * 100 + layout.cells_x * layout.cells_y;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// attr [B, 9] f32; tile_ids/starts/ends [m] i32; color [m, P, 3] f32;
// t_final [m, P] f32; ncon [m, P] i32; all contiguous on the device.
int gs_composite_fwd(const float* attr, const int* tile_ids, const int* starts,
                     const int* ends, float* color, float* t_final, int* ncon, int m,
                     int tiles_x, int tile_w, int tile_h, int chunk, void* stream) {
  if (m == 0) return 0;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int warps;
  Layout layout;
  const int ppt = fwd_layout(tile_w, tile_h, &warps, &layout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_layout(ppt, warps, static_cast<int>(cudaErrorInvalidValue), [&](auto P, auto W) {
    return static_cast<int>(launch<decltype(P)::value, decltype(W)::value>(
        attr, tile_ids, starts, ends, color, t_final, ncon, m, tiles_x, tile_w, tile_h, chunk,
        layout, s));
  });
}

}  // extern "C"
