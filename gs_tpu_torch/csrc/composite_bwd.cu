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
//     conic's inverse, widened to cover float rounding (pair_extent below);
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

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxPixelsPerThread = 8;  // P <= 2,048 pixels per tile
// 8x4-pixel cells a warp holds, one per pixel slot: the fewest warps that
// hold at most kCellsPerWarp each, else at most kMaxPixelsPerThread
constexpr int kCellsPerWarp = 4;
constexpr int kAttrW = 9;
constexpr int kBatch = 3;               // counted pairs per warp reduction
constexpr int kSums = kBatch * kAttrW;  // 27 of the reduction's 32 slots
constexpr unsigned kFull = 0xffffffffu;
// pairs whose conic is more skewed than this (a * c / det, ~ the squared
// axis ratio / 4) are never culled: the extent's rounding margin grows with it
constexpr double kMaxSkew = 1e4;

// the same float32 roundings of the constants as the PyTorch side
__device__ __forceinline__ float alpha_skip() { return static_cast<float>(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return static_cast<float>(0.99); }

// Shared memory, in 4-byte words: each pair's extent (float4), the chunk's
// attributes, the warps' partials.
__host__ __device__ constexpr size_t attr_offset(int chunk) { return 4 * static_cast<size_t>(chunk); }
__host__ __device__ constexpr size_t part_offset(int chunk) {
  return attr_offset(chunk) + static_cast<size_t>(chunk) * kAttrW;
}
__host__ __device__ constexpr size_t smem_words(int chunk, int warps) {
  return part_offset(chunk) + static_cast<size_t>(warps) * chunk * kAttrW;
}

// The conservative extent (x lo, x hi, y lo, y hi) of the pixels at which
// the pair [mean xy | conic abc | rgb | opacity] can pass the forward's
// tests. A pixel counts only where alpha = min(0.99, opac * exp(power)) >=
// 1/255, i.e. Q = a dx^2 + 2 b dx dy + c dy^2 <= tau = 2 ln(255 opac). For a
// positive definite conic that ellipse lies within |dx| <= sqrt(tau c / det),
// |dy| <= sqrt(tau a / det), det = a c - b^2. The float32 power differs from
// the exact Q / -2 by at most ~1e-6 x (|a| dx^2 + |c| dy^2 + 2 |b dx dy|),
// which is at most ~4e-6 x tau' x a c / det inside the widened box, and expf
// and the product with opac by a few ulp: tau' = (max(tau, 0) + 1e-4) x (1 +
// 1e-4 a c / det) covers both for a c / det <= kMaxSkew, and one pixel more
// on each side covers the rounding of dx, dy and the box itself. Non-finite
// values and other conics get an unbounded box; a pair with opac below 1/255
// (less a margin for expf's rounding) can count nowhere and gets an empty
// one. tests/test_torch_cull.py mirrors the rule in PyTorch and holds it
// against the plain version's decisions on the CPU.
__device__ float4 pair_extent(const float* p) {
  const float inf = __int_as_float(0x7f800000);
  const double mx = p[0], my = p[1], ca = p[2], cb = p[3], cc = p[4], op = p[8];
  if (!(isfinite(mx) && isfinite(my) && isfinite(ca) && isfinite(cb) && isfinite(cc) &&
        isfinite(op))) {
    return make_float4(-inf, inf, -inf, inf);
  }
  if (op * (1.0 + 1e-6) < static_cast<double>(alpha_skip())) {
    return make_float4(inf, -inf, inf, -inf);
  }
  const double det = ca * cc - cb * cb;
  if (!(ca > 0.0 && cc > 0.0 && det > 0.0) || ca * cc > kMaxSkew * det) {
    return make_float4(-inf, inf, -inf, inf);
  }
  const double tau = fmax(2.0 * log(255.0 * op), 0.0) + 1e-4;
  const double tw = tau * (1.0 + 1e-4 * (ca * cc / det));
  const double hx = sqrt(tw * cc / det) + 1.0;
  const double hy = sqrt(tw * ca / det) + 1.0;
  return make_float4(static_cast<float>(mx - hx), static_cast<float>(mx + hx),
                     static_cast<float>(my - hy), static_cast<float>(my + hy));
}

// Whether extent b (x lo, x hi, y lo, y hi) reaches pixel rectangle r
// (x0, x1, y0, y1; empty when x0 > x1).
__device__ __forceinline__ bool reaches(float4 b, float4 r) {
  return r.x <= r.y && b.y >= r.x && b.x <= r.y && b.w >= r.z && b.z <= r.w;
}

// How a block's warps share the tile's pixels. warps_x == 0: the strided
// map, pixel tid + k * threads. Otherwise the warps form a warps_x x
// (warps / warps_x) grid of rectangles of cells_x x cells_y cells of 8x4
// pixels; lane l holds pixel (l % 8, l / 8) of each of its cells, and
// pixel slot k is cell (k % cells_x, k / cells_x) of its warp.
struct Layout {
  int warps_x, cells_x, cells_y;
};

// Tile-local origin of cell k of warp `warp`.
__device__ __forceinline__ int2 cell_origin(const Layout& L, int warp, int k) {
  return make_int2(((warp % L.warps_x) * L.cells_x + k % L.cells_x) * 8,
                   ((warp / L.warps_x) * L.cells_y + k / L.cells_x) * 4);
}

// A thread's pixels and their running backward state.
template <int PPT>
struct Pixels {
  float px[PPT], py[PPT], T[PPT], S[PPT], gr[PPT], gg[PPT], gb[PPT], gt[PPT];
  int nc[PPT];

  // Adds this thread's terms of pair `a` (global position pos) to the
  // sums v[OFF .. OFF + 8] and steps T and S past it; true if any of its
  // pixels counted the pair.
  template <int OFF>
  __device__ __forceinline__ bool add_pair(const float* a, int pos, float (&v)[32]) {
    const float mx = a[0], my = a[1], ca = a[2], cb = a[3], cc = a[4];
    const float r = a[5], g = a[6], bl = a[7], opac = a[8];
    bool any = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (pos >= nc[k]) continue;  // past the pixel's last contributor
      const float dx = mx - px[k];
      const float dy = my - py[k];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      if (power > 0.0f) continue;
      const float gexp = expf(power);
      const float au = opac * gexp;
      const float alpha = fminf(alpha_max(), au);
      if (alpha < alpha_skip()) continue;
      const float omb = 1.0f - alpha;
      T[k] = T[k] / omb;  // T before this pair
      const float w = alpha * T[k];
      const float bdot = r * gr[k] + g * gg[k] + bl * gb[k];
      const float d_alpha = T[k] * bdot - (S[k] + gt[k]) / omb;
      S[k] = S[k] + w * bdot;
      const float d_power = au * d_alpha;
      v[OFF + 0] += -(ca * dx + cb * dy) * d_power;
      v[OFF + 1] += -(cc * dy + cb * dx) * d_power;
      v[OFF + 2] += -0.5f * dx * dx * d_power;
      v[OFF + 3] += -dx * dy * d_power;
      v[OFF + 4] += -0.5f * dy * dy * d_power;
      v[OFF + 5] += w * gr[k];
      v[OFF + 6] += w * gg[k];
      v[OFF + 7] += w * gb[k];
      v[OFF + 8] += gexp * d_alpha;
      any = true;
    }
    return any;
  }
};

// Walks the chunk's pairs j, j - 1, ... and returns the first that some
// pixel of the warp counts, its thread terms in v[OFF .. OFF + 8] (zero
// otherwise); -1 when none is left. A pair whose extent misses the warp's
// rectangle is skipped unevaluated. Warp-uniform.
template <int OFF, int PPT>
__device__ __forceinline__ int next_counted(int j, int i0, const float* s_attr,
                                            const float4* s_box, float4 wrect,
                                            Pixels<PPT>& pix, float (&v)[32]) {
#pragma unroll
  for (int q = 0; q < kAttrW; ++q) v[OFF + q] = 0.0f;
  for (; j >= 0; --j) {
    if (!reaches(s_box[j], wrect)) continue;
    if (__any_sync(kFull, pix.template add_pair<OFF>(s_attr + j * kAttrW, i0 + j, v))) return j;
  }
  return -1;
}

// Sums v over the warp's 32 lanes for every slot at once: round h (16, 8,
// 4, 2, 1) keeps the half of the slots whose index bit h matches the lane's
// and adds the partner's copy of them, so lane l ends with slot l's sum.
template <int H>
__device__ __forceinline__ void reduce_round(float (&v)[32]) {
  const bool upper = (threadIdx.x & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__device__ __forceinline__ float reduce_scatter(float (&v)[32]) {
  reduce_round<16>(v);
  reduce_round<8>(v);
  reduce_round<4>(v);
  reduce_round<2>(v);
  reduce_round<1>(v);
  return v[0];
}

template <int PPT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
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
  const int num_pix = tile_w * tile_h;
  const int tid = tile_ids[m];
  const int x0 = (tid % tiles_x) * tile_w;
  const int y0 = (tid / tiles_x) * tile_h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  Pixels<PPT> pix;
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    int x, y;
    if (layout.warps_x == 0) {
      const int p = threadIdx.x + k * kThreads;
      x = p % tile_w;
      y = p / tile_w;
    } else {
      const int2 o = cell_origin(layout, warp, k);
      x = o.x + (lane & 7);
      y = o.y + (lane >> 3);
    }
    const bool inside = x < tile_w && y < tile_h && y * tile_w + x < num_pix;
    pix.px[k] = static_cast<float>(x0 + x);
    pix.py[k] = static_cast<float>(y0 + y);
    pix.S[k] = 0.0f;
    if (inside) {
      const size_t o = static_cast<size_t>(m) * num_pix + y * tile_w + x;
      pix.T[k] = t_final[o];
      pix.nc[k] = ncon[o];  // slots past the tile keep nc = 0: nothing counts
      pix.gr[k] = g_color[o * 3 + 0];
      pix.gg[k] = g_color[o * 3 + 1];
      pix.gb[k] = g_color[o * 3 + 2];
      pix.gt[k] = gt_term[o];
      bx0 = min(bx0, x0 + x);
      bx1 = max(bx1, x0 + x);
      by0 = min(by0, y0 + y);
      by1 = max(by1, y0 + y);
    } else {
      pix.T[k] = 1.0f;
      pix.nc[k] = 0;
      pix.gr[k] = pix.gg[k] = pix.gb[k] = pix.gt[k] = 0.0f;
    }
  }
  // the warp's pixel rectangle (empty if it holds none)
  const float4 wrect = make_float4(static_cast<float>(__reduce_min_sync(kFull, bx0)),
                                   static_cast<float>(__reduce_max_sync(kFull, bx1)),
                                   static_cast<float>(__reduce_min_sync(kFull, by0)),
                                   static_cast<float>(__reduce_max_sync(kFull, by1)));
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
    // batches of kBatch counted pairs, back to front
    for (int j = n - 1; j >= 0;) {
      float v[32];  // the batch's sums: pair b's at 9 b .. 9 b + 8
      const int j0 = next_counted<0>(j, i0, s_attr, s_box, wrect, pix, v);
      if (j0 < 0) break;
      const int j1 = next_counted<kAttrW>(j0 - 1, i0, s_attr, s_box, wrect, pix, v);
      const int j2 =
          next_counted<2 * kAttrW>(j1 < 0 ? -1 : j1 - 1, i0, s_attr, s_box, wrect, pix, v);
#pragma unroll
      for (int q = kSums; q < 32; ++q) v[q] = 0.0f;
      const float sum = reduce_scatter(v);
      const int jl = lane < kAttrW ? j0 : lane < 2 * kAttrW ? j1 : j2;
      if (lane < kSums && jl >= 0) part[jl * kAttrW + lane % kAttrW] = sum;
      j = j2 - 1;  // j2 = -1: the chunk is done
    }
    __syncthreads();

    float* dst = d_attr + static_cast<size_t>(i0) * kAttrW;
    for (int e = threadIdx.x; e < n * kAttrW; e += kThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) sum += s_part[wi * chunk * kAttrW + e];
      dst[e] = sum;
    }
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

// The block's warps and their share of a tile: the fewest warps (1, 2, 4
// or 8) whose rectangles of 8x4 cells cover the tile with at most
// kCellsPerWarp cells a warp (else at most kMaxPixelsPerThread), and among
// their grids the fewest cells a warp, the squarest on a tie. Tiles no grid
// covers take 8 warps and the strided map. Returns the pixels per thread.
int choose_layout(int tile_w, int tile_h, int* warps, Layout* layout) {
  const int cw = (tile_w + 7) / 8;
  const int ch = (tile_h + 3) / 4;
  const int limits[2] = {kCellsPerWarp, kMaxPixelsPerThread};
  for (const int limit : limits) {
    for (int nw = 1; nw <= kMaxWarps; nw *= 2) {
      int best = INT_MAX, best_aspect = INT_MAX;
      for (int wx = 1; wx <= nw; wx *= 2) {
        const int ax = (cw + wx - 1) / wx;
        const int ay = (ch + nw / wx - 1) / (nw / wx);
        const int aspect = 8 * ax > 4 * ay ? 8 * ax - 4 * ay : 4 * ay - 8 * ax;
        if (ax * ay > limit) continue;
        if (ax * ay < best || (ax * ay == best && aspect < best_aspect)) {
          best = ax * ay;
          best_aspect = aspect;
          *layout = Layout{wx, ax, ay};
        }
      }
      if (best != INT_MAX) {
        *warps = nw;
        return best;
      }
    }
  }
  *warps = kMaxWarps;
  *layout = Layout{0, 0, 0};
  return (tile_w * tile_h + 32 * kMaxWarps - 1) / (32 * kMaxWarps);
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
