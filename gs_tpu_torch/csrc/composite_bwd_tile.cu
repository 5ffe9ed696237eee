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
// afterwards, and a mask pass zeroes rows no step wrote. CUDA blocks run at
// the same time, so that store would race with the next tile's block. Here:
//   - one 256-thread block owns one tile, with B2's per-pixel registers
//     (T, the suffix sum, g_color, g_T * T_final, ncon), its per-pair warp
//     shuffle sums and its fixed-order sum of the 8 warps' partials;
//   - supersteps of 4 chunks are loaded last to first through the same
//     cp.async two-slot ring as composite_fwd_tile.cu: superstep k - 1's
//     copy is issued before superstep k is computed;
//   - each superstep's [rows, 9] gradient block is collected in shared
//     memory and written out as one coalesced store; the block's barrier at
//     the top of the next superstep keeps the next block's writes behind the
//     store's reads of the buffer;
//   - a block stores only the rows in [start, end) of its own tile, and the
//     wrapper zeroes d_attr on the stream first, which gives gs_tpu's masked
//     result without a mask pass. Supersteps run from start and trimmed ends
//     are multiples of the chunk, not of the superstep, so a tile's last
//     superstep is usually partial: the rows past end belong to the next tile
//     and are neither computed nor stored.
// TMA, mbarriers and warp specialisation are left for later.
//
// What bounds it: arithmetic, as B2 (~50 fp32 operations, an expf and a
// division per pair x pixel evaluation that passes the tests, against 36
// bytes per pair read and 36 written), and in practice the per-pair warp
// reductions and the pixels of a tile that a pair misses.

#include <cuda_runtime.h>

#include <cstddef>

#include "stage_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixelsPerThread = 8;  // P <= 2,048 pixels per tile
constexpr int kAttrW = gs_stage::kAttrW;
constexpr int kSubchunks = 4;  // chunks per superstep (gs_tpu DMA_SUBCHUNKS)

// the same float32 roundings of the constants as the PyTorch side
__device__ __forceinline__ float alpha_skip() { return static_cast<float>(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return static_cast<float>(0.99); }

// shared memory: the load ring, the warp partials of one chunk, the
// gradient block of one superstep
__host__ __device__ constexpr size_t smem_floats(int chunk) {
  return 2 * static_cast<size_t>(gs_stage::slot_floats(kSubchunks * chunk)) +
         static_cast<size_t>(kWarps) * chunk * kAttrW +
         static_cast<size_t>(kSubchunks) * chunk * kAttrW;
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_bwd_tile_kernel(const float* __restrict__ attr, const int* __restrict__ tile_ids,
                          const int* __restrict__ starts, const int* __restrict__ ends,
                          const float* __restrict__ t_final, const int* __restrict__ ncon,
                          const float* __restrict__ g_color, const float* __restrict__ gt_term,
                          float* __restrict__ d_attr, int tiles_x, int tile_w, int tile_h,
                          int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int sup = kSubchunks * chunk;
  const int slot_stride = gs_stage::slot_floats(sup);
  float* s_part = smem + 2 * slot_stride;           // [kWarps, chunk, 9]
  float* s_out = s_part + kWarps * chunk * kAttrW;  // [sup, 9]
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

  float px[PPT], py[PPT], T[PPT], S[PPT], gr[PPT], gg[PPT], gb[PPT], gt[PPT];
  int nc[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(x0 + p % tile_w);
    py[k] = static_cast<float>(y0 + p / tile_w);
    S[k] = 0.0f;
    if (p < num_pix) {
      const size_t o = static_cast<size_t>(m) * num_pix + p;
      T[k] = t_final[o];
      nc[k] = ncon[o];  // lanes past the tile keep nc = 0: nothing counts
      gr[k] = g_color[o * 3 + 0];
      gg[k] = g_color[o * 3 + 1];
      gb[k] = g_color[o * 3 + 2];
      gt[k] = gt_term[o];
    } else {
      T[k] = 1.0f;
      nc[k] = 0;
      gr[k] = gg[k] = gb[k] = gt[k] = 0.0f;
    }
  }

  const int nsup = (end - start + sup - 1) / sup;
  {
    const int row0 = start + (nsup - 1) * sup;
    gs_stage::stage_async(smem, attr, row0, end - row0, kThreads);
  }
  gs_stage::commit();
  for (int t = 0; t < nsup; ++t) {  // superstep k = nsup - 1 - t: the last first
    const int k = nsup - 1 - t;
    const int row0 = start + k * sup;
    if (k > 0) {  // slot (t + 1) & 1 was last read in the previous superstep
      gs_stage::stage_async(smem + ((t + 1) & 1) * slot_stride, attr, row0 - sup, sup,
                            kThreads);
    }
    gs_stage::commit();
    gs_stage::wait<1>();  // superstep k's group has landed
    __syncthreads();      // ... for every thread's copies; the last store is done with s_out
    const float* s_sup = gs_stage::staged(smem + (t & 1) * slot_stride, attr, row0);
    const int rows = min(sup, end - row0);

    for (int ci = (rows + chunk - 1) / chunk - 1; ci >= 0; --ci) {
      const int i0 = row0 + ci * chunk;
      const int n = min(chunk, end - i0);
      const float* s_attr = s_sup + ci * chunk * kAttrW;
      for (int j = n - 1; j >= 0; --j) {
        const float* a = s_attr + j * kAttrW;
        const float mx = a[0], my = a[1], ca = a[2], cb = a[3], cc = a[4];
        const float r = a[5], g = a[6], bl = a[7], opac = a[8];
        const int pos = i0 + j;
        float acc[kAttrW];
#pragma unroll
        for (int q = 0; q < kAttrW; ++q) acc[q] = 0.0f;
        bool any = false;
#pragma unroll
        for (int kk = 0; kk < PPT; ++kk) {
          if (pos >= nc[kk]) continue;  // past the pixel's last contributor
          const float dx = mx - px[kk];
          const float dy = my - py[kk];
          const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
          if (power > 0.0f) continue;
          const float gexp = expf(power);
          const float au = opac * gexp;
          const float alpha = fminf(alpha_max(), au);
          if (alpha < alpha_skip()) continue;
          const float omb = 1.0f - alpha;
          T[kk] = T[kk] / omb;  // T before this pair
          const float w = alpha * T[kk];
          const float bdot = r * gr[kk] + g * gg[kk] + bl * gb[kk];
          const float d_alpha = T[kk] * bdot - (S[kk] + gt[kk]) / omb;
          S[kk] = S[kk] + w * bdot;
          const float d_power = au * d_alpha;
          acc[0] += -(ca * dx + cb * dy) * d_power;
          acc[1] += -(cc * dy + cb * dx) * d_power;
          acc[2] += -0.5f * dx * dx * d_power;
          acc[3] += -dx * dy * d_power;
          acc[4] += -0.5f * dy * dy * d_power;
          acc[5] += w * gr[kk];
          acc[6] += w * gg[kk];
          acc[7] += w * gb[kk];
          acc[8] += gexp * d_alpha;
          any = true;
        }
        float* part = s_part + (warp * chunk + j) * kAttrW;
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int q = 0; q < kAttrW; ++q) {
            float v = acc[q];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) part[q] = v;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int q = 0; q < kAttrW; ++q) part[q] = 0.0f;
        }
      }
      __syncthreads();  // the chunk's warp partials are complete

      float* out = s_out + ci * chunk * kAttrW;
      for (int e = threadIdx.x; e < n * kAttrW; e += kThreads) {
        float sum = 0.0f;
#pragma unroll
        for (int wi = 0; wi < kWarps; ++wi) sum += s_part[wi * chunk * kAttrW + e];
        out[e] = sum;
      }
      __syncthreads();  // s_part is free for the next chunk; s_out holds this one
    }

    // one coalesced store of the superstep's rows, all inside [start, end)
    float* dst = d_attr + static_cast<size_t>(row0) * kAttrW;
    for (int e = threadIdx.x; e < rows * kAttrW; e += kThreads) dst[e] = s_out[e];
  }
  gs_stage::wait<0>();
}

template <int PPT>
cudaError_t launch(const float* attr, const int* tile_ids, const int* starts, const int* ends,
                   const float* t_final, const int* ncon, const float* g_color,
                   const float* gt_term, float* d_attr, int m, int tiles_x, int tile_w,
                   int tile_h, int chunk, cudaStream_t stream) {
  const size_t smem = smem_floats(chunk) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_tile_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  composite_bwd_tile_kernel<PPT><<<m, kThreads, smem, stream>>>(
      attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term, d_attr, tiles_x, tile_w,
      tile_h, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_bwd_tile_max_pixels() { return kThreads * kMaxPixelsPerThread; }

// Zeroes d_attr, then launches on `stream`; returns the first CUDA error
// (0 on success). attr [B, 9] f32; tile_ids/starts/ends [m] i32 (ends
// trimmed to each tile's last contributor); t_final [m, P] f32; ncon [m, P]
// i32; g_color [m, P, 3] f32; gt_term [m, P] f32 (g_T * t_final);
// d_attr [B, 9] f32; all contiguous on the device.
int gs_composite_bwd_tile(const float* attr, const int* tile_ids, const int* starts,
                          const int* ends, const float* t_final, const int* ncon,
                          const float* g_color, const float* gt_term, float* d_attr,
                          int num_pairs, int m, int tiles_x, int tile_w, int tile_h, int chunk,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      d_attr, 0, static_cast<size_t>(num_pairs) * kAttrW * sizeof(float), s);
  if (err != cudaSuccess || m == 0) return static_cast<int>(err);
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int ppt = (tile_w * tile_h + kThreads - 1) / kThreads;
#define GS_BWD_TILE_CASE(K) \
  case K: return launch<K>(attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term, \
                           d_attr, m, tiles_x, tile_w, tile_h, chunk, s);
  switch (ppt) {
    GS_BWD_TILE_CASE(1)
    GS_BWD_TILE_CASE(2)
    GS_BWD_TILE_CASE(3)
    GS_BWD_TILE_CASE(4)
    GS_BWD_TILE_CASE(5)
    GS_BWD_TILE_CASE(6)
    GS_BWD_TILE_CASE(7)
    GS_BWD_TILE_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GS_BWD_TILE_CASE
}

}  // extern "C"
