// The per-Gaussian preprocess's forward for Hopper (sm_90a).
//
// One pass over the leaves computes what the plain PyTorch route of
// ops/projection.py computes in some 150 elementwise, cat, select and GEMV
// kernels: compute_cov3d (covariance from log_scale and quat, with the
// scaling modifier) -> project_gaussians (the EWA projection: means2d
// [N,2], depths [N], conics [N,3], radii [N] int32 and the valid mask [N])
// -> sh_colors (SH colours at the active degree, clamped at 0: [N,3]).
// Culled Gaussians (behind the near plane, or of non-positive det) get
// means2d 0, depth inf, radius 0 and conics c * 0, as the plain route's
// torch.where gives them.
//
// It replaces no gs_tpu kernel: gs_tpu leaves this stage to XLA, which
// fuses it. The VJP kernel (preprocess_bwd.cu) recomputes the same
// quantities by the same functions (preprocess_forward.cuh), so that its
// culls and clamps are the ones this kernel decided.
//
// What bounds it: bytes. Per Gaussian at SH 3 it reads the five leaves
// (232 B: xyz 12, log_scale 12, quat 16, f_dc 12, f_rest 180) and writes
// 41 B (means2d 8, depths 4, conics 12, radii 4, mask 1, colours 12):
// about 0.81 GB at N = 2,961,408, 0.24 ms at 3.35 TB/s. The arithmetic (a
// few hundred flops a Gaussian) is far below the card's rate.
//
// Design. One thread a Gaussian, a block of kBlock Gaussians. f_rest is
// 180 of the 273 B: the block's rows, one contiguous range, are staged
// through shared memory with coalesced 16-byte loads (the header's
// stage_in), rows past the active degree included, since they lie in the
// same range, and none of those is used. At degree 0 nothing is staged.
// The small [N,3] / [N,4] arrays go through L1, each warp's three loads of
// a 12-byte row sharing their lines; the outputs leave as each thread's
// own stores, which L2 merges into whole lines. There are no atomics and
// nothing is read back by the host: the camera's tensors (view,
// full_proj, cam_pos, tan_fovx, tan_fovy) and the scaling modifier come
// through device pointers.
//
// Numerics: the build's --fmad=false keeps each product and sum rounded
// on its own, as PyTorch's elementwise kernels do, and every quantity
// follows the plain route's operation order (the header lists the orders
// that are PyTorch's own), so the integer radii and the mask are the plain
// route's.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "preprocess_forward.cuh"

namespace {

constexpr int kBlock = 128;

struct Args {
  const float* xyz;        // [N,3]
  const float* log_scale;  // [N,3]
  const float* quat;       // [N,4]
  const float* f_dc;       // [N,3]
  const float* f_rest;     // [N,R*3]
  const float* view;       // [4,4]
  const float* full_proj;  // [4,4]
  const float* cam_pos;    // [3]
  const float* tan_fovx;   // 0-d
  const float* tan_fovy;   // 0-d
  const float* scale_mod;  // 0-d
  float* means2d;          // [N,2]
  float* depths;           // [N]
  float* conics;           // [N,3]
  int* radii;              // [N]
  uint8_t* mask;           // [N] bool
  float* colors;           // [N,3]
  int n;
  int rest_len;  // R*3 floats a row of f_rest
  int width;
  int height;
};

template <int D>
__global__ void __launch_bounds__(kBlock) preprocess_fwd_kernel(Args a) {
  extern __shared__ __align__(16) float s_rest[];  // [kBlock, stride]
  const int len = D > 0 ? a.rest_len : 0;
  const int stride = len | 1;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int count = static_cast<int>(min(static_cast<int64_t>(kBlock), a.n - g0));
  if (len > 0) stage_in<kBlock>(s_rest, a.f_rest + g0 * len, count * len, len, stride);
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= count) return;
  const int64_t g = g0 + i;
  const float px = __ldg(a.xyz + 3 * g), py = __ldg(a.xyz + 3 * g + 1),
              pz = __ldg(a.xyz + 3 * g + 2);

  // covariance, camera-space centre, near cull and the 2D covariance
  const CameraView cam = load_camera(a.view, a.tan_fovx, a.tan_fovy, a.width, a.height);
  float e[3], s[3], s2[3];
  scales(a.log_scale, g, __ldg(a.scale_mod), e, s, s2);
  float R[3][3], S[3][3];
  rotation(unit_quat(a.quat, g), R);
  covariance(s2, R, S);
  float t[3];
  camera_centre(cam, px, py, pz, t);
  const bool in_front = t[2] > kNearZ;
  const Ewa ew = ewa(cam, t, in_front ? t[2] : 1.0f, S);

  // means2d = ((p_xy / (p_w + 1e-7) + 1) * (W, H) - 1) / 2
  float ph[4];
  clip_centre(a.full_proj, px, py, pz, ph);
  const float p_w = 1.0f / (ph[3] + 1e-7f);
  const float mean_x = ((ph[0] * p_w + 1.0f) * static_cast<float>(a.width) - 1.0f) * 0.5f;
  const float mean_y = ((ph[1] * p_w + 1.0f) * static_cast<float>(a.height) - 1.0f) * 0.5f;

  // conic and radius
  const bool valid = in_front && ew.det > 0.0f;
  const float inv_det = valid ? 1.0f / ew.det : 0.0f;
  const float mid = 0.5f * (ew.c_xx + ew.c_yy);
  float spread = mid * mid - ew.det;
  spread = spread < 0.1f ? 0.1f : spread;  // torch.clamp(min=0.1), NaN kept
  const float lambda_max = mid + sqrtf(spread);
  const float radius_f = ceilf(3.0f * sqrtf(lambda_max));

  reinterpret_cast<float2*>(a.means2d)[g] =
      valid ? make_float2(mean_x, mean_y) : make_float2(0.0f, 0.0f);
  a.depths[g] = valid ? t[2] : INFINITY;
  a.conics[3 * g] = ew.c_yy * inv_det;
  a.conics[3 * g + 1] = -ew.c_xy * inv_det;
  a.conics[3 * g + 2] = ew.c_xx * inv_det;
  a.radii[g] = static_cast<int>(valid ? radius_f : 0.0f);
  a.mask[g] = valid;

  // colours = clamp(sum_k basis_k f_k + 0.5, min=0) along the view direction
  constexpr int K = (D + 1) * (D + 1);
  const ViewDir v = view_dir(a.cam_pos, px, py, pz);
  float b[K];
  sh_basis<D>(v.ux, v.uy, v.uz, b);
  const float* row = s_rest + i * stride;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rgb = sh_rgb<D>(b, __ldg(a.f_dc + 3 * g + c), row, c) + 0.5f;
    a.colors[3 * g + c] = rgb < 0.0f ? 0.0f : rgb;  // torch.clamp(min=0), NaN kept
  }
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int blocks = static_cast<int>((static_cast<int64_t>(a.n) + kBlock - 1) / kBlock);
  const size_t smem = D > 0 ? sizeof(float) * kBlock * (a.rest_len | 1) : 0;
  preprocess_fwd_kernel<D><<<blocks, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a degree outside 0..4.
int gs_preprocess_fwd(const float* xyz, const float* log_scale, const float* quat,
                      const float* f_dc, const float* f_rest, const float* view,
                      const float* full_proj, const float* cam_pos, const float* tan_fovx,
                      const float* tan_fovy, const float* scale_mod, float* means2d,
                      float* depths, float* conics, int* radii, uint8_t* mask, float* colors,
                      int n, int rest_len, int degree, int width, int height, void* stream) {
  const Args a{xyz, log_scale, quat, f_dc, f_rest, view, full_proj, cam_pos, tan_fovx,
               tan_fovy, scale_mod, means2d, depths, conics, radii, mask, colors, n, rest_len,
               width, height};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0: return launch<0>(a, s);
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Gaussians a block (the wrappers' tests read it).
int gs_preprocess_fwd_block() { return kBlock; }

}  // extern "C"
