// The per-Gaussian preprocess's VJP for Hopper (sm_90a).
//
// The forward is the plain PyTorch route of ops/projection.py:
// compute_cov3d (covariance from log_scale and quat, with the scaling
// modifier) -> project_gaussians (the EWA projection to means2d, conics,
// depths and radii) -> sh_colors (SH colours at the active degree, clamped
// at 0). This kernel is its vector-Jacobian product: from the cotangents of
// means2d [N,2], conics [N,3], colours [N,3] and, when given, depths [N] it
// writes the gradients of xyz [N,3], log_scale [N,3], quat [N,4],
// features_dc [N,1,3] and features_rest [N,R,3].
//
// It replaces no gs_tpu kernel: gs_tpu leaves this VJP to XLA's autodiff.
// It takes the place of autograd's tape through the plain route (dozens of
// elementwise, select, cat and small-GEMM kernels a step).
//
// The contract is torch.autograd.grad of that route, with autograd's
// subgradients: a clamp passes the gradient on its closed interval (the
// camera-space x/z and y/z at +-1.3 tan(fov/2), rgb + 0.5 >= 0, the view
// direction's norm >= 1e-12); torch.where(valid, ...) gives exactly 0
// outside valid, so a Gaussian the forward culled (behind the near plane or
// of non-positive det) gets exactly 0 from the projection, and a clamped
// colour channel exactly 0 from its colour; the coefficients past the
// active degree get exact zeros, and so does the view direction at degree 0.
// `valid` is the forward's own mask, read and not recomputed, so that the
// culled set is the forward's bit for bit.
//
// What bounds it: bytes. Per Gaussian at SH 3 it reads the five leaves
// (232 B: xyz 12, log_scale 12, quat 16, f_dc 12, f_rest 180), the
// cotangents (32 B) and valid (1 B), and writes the five gradients (232 B):
// about 1.48 GB at N = 2,961,408, 0.44 ms at 3.35 TB/s. The arithmetic (a
// few hundred flops a Gaussian) is far below the card's rate.
//
// Design. One thread a Gaussian, a block of kBlock Gaussians. Each thread
// recomputes its own forward quantities in registers by the functions the
// forward kernel computes them with (preprocess_forward.cuh: cov3d, the
// camera-space centre, the clamped x/z and y/z, J, T = J W, the 2D
// covariance, det; the view direction, the SH basis and the pre-clamp rgb)
// and applies the chain rule back to the leaves. The block's f_rest rows
// are staged through shared memory as the header's stage_in does, and
// g_f_rest leaves through the same buffer with 16-byte stores. The small [N,3] / [N,4] arrays go through
// L1. There are no atomics: the same inputs give the same bits.
//
// Numerics: the build's --fmad=false keeps each product and sum rounded
// on its own, as PyTorch's elementwise kernels do, and the forward
// quantities follow the plain route's operation order; the gradients'
// sums are in this kernel's own order, so they differ from autograd's in
// the last bits. The camera's tensors (view, full_proj, cam_pos, tan_fovx,
// tan_fovy) and the scaling modifier are read through device pointers: the
// host reads nothing.

#include <cuda_runtime.h>

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
  const uint8_t* valid;    // [N] bool
  const float* g_means2d;  // [N,2]
  const float* g_conics;   // [N,3]
  const float* g_colors;   // [N,3]
  const float* g_depths;   // [N] or null
  float* g_xyz;
  float* g_log_scale;
  float* g_quat;
  float* g_f_dc;
  float* g_f_rest;
  int n;
  int rest_len;  // R*3 floats a row of f_rest
  int width;
  int height;
};

// The block's gradient rows from shared memory to g_f_rest, as stage_in.
__device__ void stage_out(float* dst, const float* smem, int total, int len, int stride) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = total >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int v = threadIdx.x; v < nv; v += kBlock) {
      const int e = v * 4;
      float4 q;
      q.x = smem[padded(e, len, stride)];
      q.y = smem[padded(e + 1, len, stride)];
      q.z = smem[padded(e + 2, len, stride)];
      q.w = smem[padded(e + 3, len, stride)];
      __stcs(dst4 + v, q);
    }
    head = nv * 4;
  }
  for (int e = head + threadIdx.x; e < total; e += kBlock) {
    __stcs(dst + e, smem[padded(e, len, stride)]);
  }
}

// The basis' cotangent gb[k] carried to the direction: (gx, gy, gz).
template <int D>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z, const float* gb,
                                             float& gx, float& gy, float& gz) {
  gx = -kC1 * gb[3];
  gy = -kC1 * gb[1];
  gz = kC1 * gb[2];
  if constexpr (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    gx += kC2[0] * y * gb[4] - 2.0f * kC2[2] * x * gb[6] + kC2[3] * z * gb[7]
        + 2.0f * kC2[4] * x * gb[8];
    gy += kC2[0] * x * gb[4] + kC2[1] * z * gb[5] - 2.0f * kC2[2] * y * gb[6]
        - 2.0f * kC2[4] * y * gb[8];
    gz += kC2[1] * y * gb[5] + 4.0f * kC2[2] * z * gb[6] + kC2[3] * x * gb[7];
    if constexpr (D > 2) {
      gx += kC3[0] * 6.0f * xy * gb[9] + kC3[1] * yz * gb[10] - kC3[2] * 2.0f * xy * gb[11]
          - kC3[3] * 6.0f * xz * gb[12] + kC3[4] * (4.0f * zz - 3.0f * xx - yy) * gb[13]
          + kC3[5] * 2.0f * xz * gb[14] + kC3[6] * 3.0f * (xx - yy) * gb[15];
      gy += kC3[0] * 3.0f * (xx - yy) * gb[9] + kC3[1] * xz * gb[10]
          + kC3[2] * (4.0f * zz - xx - 3.0f * yy) * gb[11] - kC3[3] * 6.0f * yz * gb[12]
          - kC3[4] * 2.0f * xy * gb[13] - kC3[5] * 2.0f * yz * gb[14]
          - kC3[6] * 6.0f * xy * gb[15];
      gz += kC3[1] * xy * gb[10] + kC3[2] * 8.0f * yz * gb[11]
          + kC3[3] * 3.0f * (2.0f * zz - xx - yy) * gb[12] + kC3[4] * 8.0f * xz * gb[13]
          + kC3[5] * (xx - yy) * gb[14];
    }
    if constexpr (D > 3) {
      gx += kC4[0] * y * (3.0f * xx - yy) * gb[16] + kC4[1] * 6.0f * xy * z * gb[17]
          + kC4[2] * y * (7.0f * zz - 1.0f) * gb[18] + kC4[5] * z * (7.0f * zz - 3.0f) * gb[21]
          + kC4[6] * 2.0f * x * (7.0f * zz - 1.0f) * gb[22]
          + kC4[7] * 3.0f * z * (xx - yy) * gb[23] + kC4[8] * 4.0f * x * (xx - 3.0f * yy) * gb[24];
      gy += kC4[0] * x * (xx - 3.0f * yy) * gb[16] + kC4[1] * 3.0f * z * (xx - yy) * gb[17]
          + kC4[2] * x * (7.0f * zz - 1.0f) * gb[18] + kC4[3] * z * (7.0f * zz - 3.0f) * gb[19]
          - kC4[6] * 2.0f * y * (7.0f * zz - 1.0f) * gb[22] - kC4[7] * 6.0f * xy * z * gb[23]
          + kC4[8] * 4.0f * y * (yy - 3.0f * xx) * gb[24];
      gz += kC4[1] * y * (3.0f * xx - yy) * gb[17] + kC4[2] * 14.0f * xy * z * gb[18]
          + kC4[3] * y * (21.0f * zz - 3.0f) * gb[19] + kC4[4] * z * (140.0f * zz - 60.0f) * gb[20]
          + kC4[5] * x * (21.0f * zz - 3.0f) * gb[21] + kC4[6] * 14.0f * z * (xx - yy) * gb[22]
          + kC4[7] * x * (xx - 3.0f * yy) * gb[23];
    }
  }
}

// The view direction's norm and the pre-clamp colour as this kernel has
// always recomputed them: (x^2 + y^2) + z^2, and the sum over k in k order
// with each product rounded. The card's forward (the header's view_dir and
// sh_rgb, which P2 computes its outputs with) adds both in other orders, so
// they may differ from it in the last bits; the one decision they feed, the
// colour clamp rgb + 0.5 >= 0, can then differ from the forward's only where
// rgb + 0.5 lies within a few float32 steps of 0.
__device__ __forceinline__ float source_order_norm(float dx, float dy, float dz) {
  return sqrtf(dx * dx + dy * dy + dz * dz);
}

template <int D>
__device__ __forceinline__ float source_order_rgb(const float* b, float fdc, const float* row,
                                                  int c) {
  constexpr int K = (D + 1) * (D + 1);
  float rgb = b[0] * fdc;
#pragma unroll
  for (int k = 1; k < K; ++k) rgb += b[k] * row[3 * (k - 1) + c];
  return rgb;
}

// One Gaussian's colour VJP: g_f_dc, its f_rest row's gradient (in place of
// the row in shared memory) and the view direction's share of g_xyz.
template <int D>
__device__ __forceinline__ void colour_vjp(const Args& a, int64_t g, float* row, float px,
                                           float py, float pz, float* gxyz) {
  constexpr int K = (D + 1) * (D + 1);
  const float dx = px - __ldg(a.cam_pos), dy = py - __ldg(a.cam_pos + 1),
              dz = pz - __ldg(a.cam_pos + 2);
  const float nrm = source_order_norm(dx, dy, dz);
  const float nc = fmaxf(nrm, kNormMin);
  const float ux = dx / nc, uy = dy / nc, uz = dz / nc;
  float b[K];
  sh_basis<D>(ux, uy, uz, b);

  float grgb[3];
  for (int c = 0; c < 3; ++c) {
    const float rgb = source_order_rgb<D>(b, __ldg(a.f_dc + 3 * g + c), row, c);
    const float gc = __ldcs(a.g_colors + 3 * g + c);
    grgb[c] = rgb + 0.5f >= 0.0f ? gc : 0.0f;
  }
  for (int c = 0; c < 3; ++c) __stcs(a.g_f_dc + 3 * g + c, b[0] * grgb[c]);
  float gb[K];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    gb[k] = row[3 * (k - 1)] * grgb[0] + row[3 * (k - 1) + 1] * grgb[1]
          + row[3 * (k - 1) + 2] * grgb[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) row[3 * (k - 1) + c] = b[k] * grgb[c];
  }
  for (int e = 3 * (K - 1); e < a.rest_len; ++e) row[e] = 0.0f;
  // at degree 0 the basis is a constant: the direction gets nothing
  if constexpr (D > 0) {
    float gux, guy, guz;
    sh_basis_vjp<D>(ux, uy, uz, gb, gux, guy, guz);
    // u = dirs / clamp(|dirs|, 1e-12): the division, then the clamp and the norm
    float gdx = gux / nc, gdy = guy / nc, gdz = guz / nc;
    if (nrm >= kNormMin) {
      const float g_nc = -(gux * (ux / nc) + guy * (uy / nc) + guz * (uz / nc));
      const float s = g_nc / nrm;
      gdx += dx * s;
      gdy += dy * s;
      gdz += dz * s;
    }
    gxyz[0] += gdx;
    gxyz[1] += gdy;
    gxyz[2] += gdz;
  }
}

// One valid Gaussian's projection and covariance VJP: adds to gxyz and
// writes g_log_scale and g_quat.
__device__ __forceinline__ void projection_vjp(const Args& a, int64_t g, float px, float py,
                                               float pz, float* gxyz, float* gls, float* gq) {
  const CameraView cam = load_camera(a.view, a.tan_fovx, a.tan_fovy, a.width, a.height);
  const auto& W = cam.W;
  const float fx = cam.fx, fy = cam.fy, lim_x = cam.lim_x, lim_y = cam.lim_y;

  // covariance: scale = exp(log_scale) * modifier, R from the unit quaternion
  const float mod = __ldg(a.scale_mod);
  float e[3], s[3], s2[3];
  scales(a.log_scale, g, mod, e, s, s2);
  const UnitQuat uq = unit_quat(a.quat, g);
  const float4 q4 = uq.q4;
  const float qn = uq.qn, w = uq.w, x = uq.x, y = uq.y, z = uq.z;
  float R[3][3];
  rotation(uq, R);
  float S[3][3];
  covariance(s2, R, S);

  // camera space and the clamped x/z, y/z (valid implies t_z > 0.2, so t_z is
  // the forward's divisor)
  float t[3];
  camera_centre(cam, px, py, pz, t);
  const float tz = t[2];
  const Ewa ew = ewa(cam, t, tz, S);
  const float ux = ew.ux, uy = ew.uy, txz = ew.txz, tyz = ew.tyz, inv_tz = ew.inv_tz;
  const float* t0 = ew.t0;
  const float* t1 = ew.t1;
  float St0[3], St1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    St0[i] = S[i][0] * t0[0] + S[i][1] * t0[1] + S[i][2] * t0[2];
    St1[i] = S[i][0] * t1[0] + S[i][1] * t1[1] + S[i][2] * t1[2];
  }
  const float c_xx = ew.c_xx, c_xy = ew.c_xy, c_yy = ew.c_yy, det = ew.det;

  // means2d = ((p_xy / (p_w + 1e-7) + 1) * (W, H) - 1) / 2, and depths = t_z:
  // neither depends on det
  const float* P = a.full_proj;
  float ph[4];
  clip_centre(P, px, py, pz, ph);
  const float p_w = 1.0f / (ph[3] + 1e-7f);
  const float g_ndc_x = __ldcs(a.g_means2d + 2 * g) * 0.5f * static_cast<float>(a.width);
  const float g_ndc_y = __ldcs(a.g_means2d + 2 * g + 1) * 0.5f * static_cast<float>(a.height);
  const float g_phx = g_ndc_x * p_w, g_phy = g_ndc_y * p_w;
  const float g_ph3 = -(g_ndc_x * ph[0] + g_ndc_y * ph[1]) * (p_w * p_w);
  const float g_tz_depth = a.g_depths != nullptr ? __ldcs(a.g_depths + g) : 0.0f;
  float gpos[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gpos[c] = g_phx * __ldg(P + c) + g_phy * __ldg(P + 4 + c) + g_ph3 * __ldg(P + 12 + c);
  }
  // det is the forward's when the recomputed centre is; where the two differ
  // on a Gaussian whose det is all rounding (a needle seen edge-on), this
  // one may not be positive: the covariance's terms are left out rather
  // than made inf, and only the centre's position terms above (and the
  // depth's) reach the leaves.
  if (!(det > 0.0f)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) gxyz[c] += g_tz_depth * W[2][c] + gpos[c];
    return;
  }
  const float inv_det = 1.0f / det;

  // conics = (c_yy, -c_xy, c_xx) * inv_det
  const float gc0 = __ldcs(a.g_conics + 3 * g), gc1 = __ldcs(a.g_conics + 3 * g + 1),
              gc2 = __ldcs(a.g_conics + 3 * g + 2);
  const float g_inv_det = gc0 * c_yy + gc1 * -c_xy + gc2 * c_xx;
  const float g_det = -g_inv_det * (inv_det * inv_det);
  const float g_cxx = gc2 * inv_det + g_det * c_yy;
  const float g_cyy = gc0 * inv_det + g_det * c_xx;
  const float g_cxy = -(gc1 * inv_det) - 2.0f * (g_det * c_xy);

  // the 2D covariance: cov3d's and T's cotangents
  float gS[3][3];  // packed: gS[i][j], i <= j
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gS[i][i] = g_cxx * t0[i] * t0[i] + g_cxy * t0[i] * t1[i] + g_cyy * t1[i] * t1[i];
#pragma unroll
    for (int j = i + 1; j < 3; ++j) {
      gS[i][j] = g_cxx * (2.0f * t0[i] * t0[j]) + g_cxy * (t0[i] * t1[j] + t0[j] * t1[i])
               + g_cyy * (2.0f * t1[i] * t1[j]);
    }
  }
  float gt0[3], gt1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gt0[i] = 2.0f * g_cxx * St0[i] + g_cxy * St1[i];
    gt1[i] = g_cxy * St0[i] + 2.0f * g_cyy * St1[i];
  }
  const float g_j00 = gt0[0] * W[0][0] + gt0[1] * W[0][1] + gt0[2] * W[0][2];
  const float g_j02 = gt0[0] * W[2][0] + gt0[1] * W[2][1] + gt0[2] * W[2][2];
  const float g_j11 = gt1[0] * W[1][0] + gt1[1] * W[1][1] + gt1[2] * W[1][2];
  const float g_j12 = gt1[0] * W[2][0] + gt1[1] * W[2][1] + gt1[2] * W[2][2];
  const float g_inv_tz = g_j00 * fx + g_j02 * (-fx * txz) + g_j11 * fy + g_j12 * (-fy * tyz);
  // the clamps pass the gradient on their closed intervals
  const float g_ux = (ux >= -lim_x && ux <= lim_x) ? g_j02 * inv_tz * -fx : 0.0f;
  const float g_uy = (uy >= -lim_y && uy <= lim_y) ? g_j12 * inv_tz * -fy : 0.0f;
  float gt[3];
  gt[0] = g_ux / tz;
  gt[1] = g_uy / tz;
  gt[2] = -g_inv_tz * (inv_tz * inv_tz) - g_ux * (ux / tz) - g_uy * (uy / tz) + g_tz_depth;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gxyz[c] += (gt[0] * W[0][c] + gt[1] * W[1][c] + gt[2] * W[2][c]) + gpos[c];
  }

  // cov3d -> scale and rotation
  float gR[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 2.0f * gS[i][i] * R[i][k];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j != i) acc += gS[i < j ? i : j][i < j ? j : i] * R[j][k];
      }
      gR[i][k] = s2[k] * acc;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float g_s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = i; j < 3; ++j) g_s2 += gS[i][j] * R[i][k] * R[j][k];
    }
    gls[k] = 2.0f * s[k] * g_s2 * mod * e[k];
  }
  const float gw = 2.0f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2]
                           - y * gR[2][0] + x * gR[2][1]);
  const float gx = 2.0f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] - 2.0f * x * gR[1][1]
                           - w * gR[1][2] + z * gR[2][0] + w * gR[2][1] - 2.0f * x * gR[2][2]);
  const float gy = 2.0f * (-2.0f * y * gR[0][0] + x * gR[0][1] + w * gR[0][2] + x * gR[1][0]
                           + z * gR[1][2] - w * gR[2][0] + z * gR[2][1] - 2.0f * y * gR[2][2]);
  const float gz = 2.0f * (-2.0f * z * gR[0][0] - w * gR[0][1] + x * gR[0][2] + w * gR[1][0]
                           - 2.0f * z * gR[1][1] + y * gR[1][2] + x * gR[2][0] + y * gR[2][1]);
  // q = quat / |quat|
  const float g_qn = -(gw * (w / qn) + gx * (x / qn) + gy * (y / qn) + gz * (z / qn));
  const float sq = g_qn / qn;
  gq[0] = gw / qn + q4.x * sq;
  gq[1] = gx / qn + q4.y * sq;
  gq[2] = gy / qn + q4.z * sq;
  gq[3] = gz / qn + q4.w * sq;
}

template <int D>
__global__ void __launch_bounds__(kBlock) preprocess_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float s_rest[];  // [kBlock, stride]
  const int len = a.rest_len;
  const int stride = len | 1;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int count = static_cast<int>(min(static_cast<int64_t>(kBlock), a.n - g0));
  if (len > 0) stage_in<kBlock>(s_rest, a.f_rest + g0 * len, count * len, len, stride);
  __syncthreads();

  const int i = threadIdx.x;
  if (i < count) {
    const int64_t g = g0 + i;
    const float px = __ldg(a.xyz + 3 * g), py = __ldg(a.xyz + 3 * g + 1),
                pz = __ldg(a.xyz + 3 * g + 2);
    float gxyz[3] = {0.0f, 0.0f, 0.0f};
    colour_vjp<D>(a, g, s_rest + i * stride, px, py, pz, gxyz);
    float gls[3] = {0.0f, 0.0f, 0.0f};
    float gq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a.valid[g]) projection_vjp(a, g, px, py, pz, gxyz, gls, gq);
    for (int c = 0; c < 3; ++c) {
      __stcs(a.g_xyz + 3 * g + c, gxyz[c]);
      __stcs(a.g_log_scale + 3 * g + c, gls[c]);
    }
    __stcs(reinterpret_cast<float4*>(a.g_quat) + g, make_float4(gq[0], gq[1], gq[2], gq[3]));
  }
  __syncthreads();
  if (len > 0) stage_out(a.g_f_rest + g0 * len, s_rest, count * len, len, stride);
}

template <int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int blocks = static_cast<int>((static_cast<int64_t>(a.n) + kBlock - 1) / kBlock);
  const size_t smem = sizeof(float) * kBlock * (a.rest_len | 1);
  preprocess_bwd_kernel<D><<<blocks, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a degree outside 0..4. `g_depths` may be null.
int gs_preprocess_bwd(const float* xyz, const float* log_scale, const float* quat,
                      const float* f_dc, const float* f_rest, const float* view,
                      const float* full_proj, const float* cam_pos, const float* tan_fovx,
                      const float* tan_fovy, const float* scale_mod, const uint8_t* valid,
                      const float* g_means2d, const float* g_conics, const float* g_colors,
                      const float* g_depths, float* g_xyz, float* g_log_scale, float* g_quat,
                      float* g_f_dc, float* g_f_rest, int n, int rest_len, int degree,
                      int width, int height, void* stream) {
  const Args a{xyz, log_scale, quat, f_dc, f_rest, view, full_proj, cam_pos, tan_fovx,
               tan_fovy, scale_mod, valid, g_means2d, g_conics, g_colors, g_depths, g_xyz,
               g_log_scale, g_quat, g_f_dc, g_f_rest, n, rest_len, width, height};
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
int gs_preprocess_bwd_block() { return kBlock; }

}  // extern "C"
