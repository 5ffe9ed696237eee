// Pixel layout and per-pair machinery shared by the compositing kernels
// that hold a tile's pixels on warp rectangles: composite_bwd.cu (B2),
// composite_bwd_tile.cu (B4) and composite_fwd_tile.cu (B3).
//
// Layout. A block owns one tile and has 1, 2, 4 or 8 warps, the fewest
// whose rectangles of 8x4-pixel cells cover the tile with at most
// kCellsPerWarp cells a warp (else kMaxPixelsPerThread); among their grids
// the fewest cells a warp, the squarest on a tie (choose_layout). Lane l
// holds pixel (l % 8, l / 8) of each of its warp's cells, so pixel slot k
// of every lane lies in cell k of the warp. Tiles no grid covers take
// kMaxWarps warps and the strided map, pixel tid + k * threads. What
// choose_layout returns for the tile sizes the port runs and tests:
//   tile    warps  warp grid  cells a warp  pixels a warp  pixels a thread
//   16x16   2      1 x 2      2 x 2         16x8           4
//   48x32   8      2 x 4      3 x 2         24x8           6
//   8x8     1      1 x 1      1 x 2         8x8            2
//   32x16   4      2 x 2      2 x 2         16x8           4
//   20x12   4      4 x 1      1 x 3         8x12           3 (cells overhang)
//   32x32   8      2 x 4      2 x 2         16x8           4
//   64x32   8      4 x 2      2 x 4         16x16          8
//   72x28   8      strided                                 8
// tests/test_torch_cull.py mirrors choose_layout and checks this table.
//
// The cull. pair_extent gives each pair a conservative screen box outside
// which no pixel can pass the forward's tests (power <= 0 and alpha >=
// 1/255); a pair whose box misses a warp's rectangle changes no pixel of
// the warp, forward or backward, and the warp skips it.
// tests/test_torch_cull.py mirrors pair_extent in float64 and holds it
// against the plain version's decisions on the CPU.
//
// The backward's reduction. Each warp keeps the 9 thread sums of up to
// kBatch counted pairs in registers and sums them over its lanes at once by
// a reduce-scatter (31 shuffles for 27 sums, lane l ends with sum l).

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace gs_warps {

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

// Blocks an SM that a kernel of PPT pixels a thread and `warps` warps is
// compiled for (__launch_bounds__'s second argument): a budget of 128
// registers a thread (two blocks of 8 warps) up to 6 pixels a thread, and
// all 255 above. Left to itself ptxas trades a few spilled registers (a
// stack frame of 8-48 bytes at some layouts) for the next occupancy step;
// chip_smoke.py checks that no instantiation has a stack frame.
__host__ __device__ constexpr int min_blocks(int ppt, int warps) {
  return ppt <= 6 ? 16 / warps : 1;
}

// the same float32 roundings of the constants as the PyTorch side
__device__ __forceinline__ float alpha_skip() { return static_cast<float>(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return static_cast<float>(0.99); }
__device__ __forceinline__ float t_eps() { return static_cast<float>(1e-4); }

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
// one.
__device__ inline float4 pair_extent(const float* p) {
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

// Tile-local pixel of this thread's slot k (lane `lane` of warp `warp`, in
// a block of `threads` threads); it may lie past the tile.
__device__ __forceinline__ int2 slot_pixel(const Layout& L, int warp, int lane, int k,
                                           int threads, int tile_w) {
  if (L.warps_x == 0) {
    const int p = threadIdx.x + k * threads;
    return make_int2(p % tile_w, p / tile_w);
  }
  const int2 o = cell_origin(L, warp, k);
  return make_int2(o.x + (lane & 7), o.y + (lane >> 3));
}

// Whether tile-local pixel (x, y) is one of the tile's.
__device__ __forceinline__ bool in_tile(int2 q, int tile_w, int tile_h) {
  return q.x < tile_w && q.y < tile_h && q.y * tile_w + q.x < tile_w * tile_h;
}

// The bounding rectangle (x0, x1, y0, y1) over the warp of the global
// pixel bounds each lane found (empty if no lane holds a pixel).
__device__ __forceinline__ float4 warp_rect(int bx0, int bx1, int by0, int by1) {
  return make_float4(static_cast<float>(__reduce_min_sync(kFull, bx0)),
                     static_cast<float>(__reduce_max_sync(kFull, bx1)),
                     static_cast<float>(__reduce_min_sync(kFull, by0)),
                     static_cast<float>(__reduce_max_sync(kFull, by1)));
}

// A thread's pixels and their running backward state.
template <int PPT>
struct Pixels {
  float px[PPT], py[PPT], T[PPT], S[PPT], gr[PPT], gg[PPT], gb[PPT], gt[PPT];
  int nc[PPT];

  // Loads this thread's pixels of tile m (grid tile `tile`) from the
  // forward's t_final and ncon and the cotangents g_color and gt_term, in a
  // block of THREADS threads; returns the warp's pixel rectangle (global
  // pixels, empty if the warp holds none). Slots past the tile keep nc = 0,
  // so nothing counts there.
  template <int THREADS>
  __device__ __forceinline__ float4 load(const Layout& L, int m, int tile, int tiles_x,
                                         int tile_w, int tile_h, const float* t_final,
                                         const int* ncon, const float* g_color,
                                         const float* gt_term) {
    const int num_pix = tile_w * tile_h;
    const int x0 = (tile % tiles_x) * tile_w;
    const int y0 = (tile / tiles_x) * tile_h;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int2 q = slot_pixel(L, warp, lane, k, THREADS, tile_w);
      px[k] = static_cast<float>(x0 + q.x);
      py[k] = static_cast<float>(y0 + q.y);
      S[k] = 0.0f;
      if (in_tile(q, tile_w, tile_h)) {
        const size_t o = static_cast<size_t>(m) * num_pix + q.y * tile_w + q.x;
        T[k] = t_final[o];
        nc[k] = ncon[o];
        gr[k] = g_color[o * 3 + 0];
        gg[k] = g_color[o * 3 + 1];
        gb[k] = g_color[o * 3 + 2];
        gt[k] = gt_term[o];
        bx0 = min(bx0, x0 + q.x);
        bx1 = max(bx1, x0 + q.x);
        by0 = min(by0, y0 + q.y);
        by1 = max(by1, y0 + q.y);
      } else {
        T[k] = 1.0f;
        nc[k] = 0;
        gr[k] = gg[k] = gb[k] = gt[k] = 0.0f;
      }
    }
    return warp_rect(bx0, bx1, by0, by1);
  }

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

// Walks one chunk of n pairs (global positions i0 ..) back to front in
// batches of kBatch counted pairs and stores each counted pair's warp sums
// in the warp's partials part[j * 9 + q]; the partials of pairs no lane
// counted are left as they are. Warp-uniform.
template <int PPT>
__device__ __forceinline__ void reduce_chunk(int n, int i0, const float* s_attr,
                                             const float4* s_box, float4 wrect,
                                             Pixels<PPT>& pix, float* part) {
  const int lane = threadIdx.x & 31;
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
}

// Stores the n rows of a chunk's gradients to dst: each value the sum of
// the WARPS warps' partials ([WARPS][chunk][9]) in warp order, so the
// result does not change from run to run. Every thread of the block calls it.
template <int WARPS>
__device__ __forceinline__ void store_warp_sums(const float* s_part, int chunk, int n,
                                                float* dst) {
  for (int e = threadIdx.x; e < n * kAttrW; e += WARPS * 32) {
    float sum = 0.0f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) sum += s_part[wi * chunk * kAttrW + e];
    dst[e] = sum;
  }
}

// The block's warps and their share of a tile (see the layout above).
// Returns the pixels per thread.
inline int choose_layout(int tile_w, int tile_h, int* warps, Layout* layout) {
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

}  // namespace gs_warps
