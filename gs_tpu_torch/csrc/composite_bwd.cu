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
//   - 256 threads; each keeps ceil(P / 256) pixels in registers (T, the
//     suffix sum, g_color, g_T * T_final, ncon); up to 6 at 48x32 tiles;
//   - per chunk, the block stages chunk x 9 floats in shared memory, then
//     walks the chunk's pairs back to front; every thread adds its pixels'
//     terms of the pair's 9 gradients, a warp-shuffle tree sums them over the
//     warp, and lane 0 stores the warp's partials in shared memory
//     ([8 warps][chunk][9]). A warp none of whose pixels the pair touches
//     stores zeros without the shuffles;
//   - after the chunk, the 8 warp partials of each value are summed in warp
//     order and stored to the pair's own row. Every row belongs to one tile,
//     so there are no atomics and the sums come out in a fixed order: the
//     result does not change from run to run;
//   - the wrapper zeroes d_attr on the stream first, so rows outside every
//     range (past a trimmed end, padding, unlisted tiles) are exactly 0.
// The TPU kernel's bf16-split matrix-unit products, log-step scans and
// moment / power matrix formulations exist only for the TPU; here every sum
// is a plain fp32 multiply-add. The division of T and the suffix sum go pair
// by pair, in the order the plain PyTorch version
// (rasterize_cuda.composite_bwd_torch) follows, and the library is compiled
// with --fmad=false and accurate expf, so both take the same contribution
// decisions and the same per-pixel values; only the order of the sums over
// the tile's pixels differs.
//
// What bounds it: arithmetic. Each pair x pixel evaluation that passes the
// tests costs ~50 fp32 operations, an expf and a division against 36 bytes
// per pair read once per tile and 36 written, so the kernel is bound by the
// fp32 rate (see chip_smoke.py's count), and in practice by the per-pair
// warp reductions and the pixels of a tile that the pair misses.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixelsPerThread = 8;  // P <= 2,048 pixels per tile
constexpr int kAttrW = 9;

// the same float32 roundings of the constants as the PyTorch side
__device__ __forceinline__ float alpha_skip() { return static_cast<float>(1.0 / 255.0); }
__device__ __forceinline__ float alpha_max() { return static_cast<float>(0.99); }

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ attr, const int* __restrict__ tile_ids,
                     const int* __restrict__ starts, const int* __restrict__ ends,
                     const float* __restrict__ t_final, const int* __restrict__ ncon,
                     const float* __restrict__ g_color, const float* __restrict__ gt_term,
                     float* __restrict__ d_attr, int tiles_x, int tile_w, int tile_h,
                     int chunk) {
  extern __shared__ float smem[];
  float* s_attr = smem;                          // [chunk, 9]
  float* s_part = smem + chunk * kAttrW;         // [kWarps, chunk, 9]
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

  const int n_chunks = (end - start + chunk - 1) / chunk;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int i0 = start + c * chunk;
    const int n = min(chunk, end - i0);
    __syncthreads();  // the previous chunk's reads of s_attr / s_part are done
    const float* src = attr + static_cast<size_t>(i0) * kAttrW;
    for (int e = threadIdx.x; e < n * kAttrW; e += kThreads) s_attr[e] = src[e];
    __syncthreads();

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
        acc[0] += -(ca * dx + cb * dy) * d_power;
        acc[1] += -(cc * dy + cb * dx) * d_power;
        acc[2] += -0.5f * dx * dx * d_power;
        acc[3] += -dx * dy * d_power;
        acc[4] += -0.5f * dy * dy * d_power;
        acc[5] += w * gr[k];
        acc[6] += w * gg[k];
        acc[7] += w * gb[k];
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
    __syncthreads();

    float* dst = d_attr + static_cast<size_t>(i0) * kAttrW;
    for (int e = threadIdx.x; e < n * kAttrW; e += kThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) sum += s_part[wi * chunk * kAttrW + e];
      dst[e] = sum;
    }
  }
}

template <int PPT>
cudaError_t launch(const float* attr, const int* tile_ids, const int* starts, const int* ends,
                   const float* t_final, const int* ncon, const float* g_color,
                   const float* gt_term, float* d_attr, int m, int tiles_x, int tile_w,
                   int tile_h, int chunk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(chunk) * kAttrW * sizeof(float) * (1 + kWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        composite_bwd_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  composite_bwd_kernel<PPT><<<m, kThreads, smem, stream>>>(
      attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term, d_attr, tiles_x, tile_w,
      tile_h, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixels per tile this library supports (the wrapper checks before calling).
int gs_composite_bwd_max_pixels() { return kThreads * kMaxPixelsPerThread; }

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
  const int ppt = (tile_w * tile_h + kThreads - 1) / kThreads;
#define GS_BWD_CASE(K) \
  case K: return launch<K>(attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term, \
                           d_attr, m, tiles_x, tile_w, tile_h, chunk, s);
  switch (ppt) {
    GS_BWD_CASE(1)
    GS_BWD_CASE(2)
    GS_BWD_CASE(3)
    GS_BWD_CASE(4)
    GS_BWD_CASE(5)
    GS_BWD_CASE(6)
    GS_BWD_CASE(7)
    GS_BWD_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GS_BWD_CASE
}

}  // extern "C"
