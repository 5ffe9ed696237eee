// The per-Gaussian preprocess's forward quantities, one Gaussian a thread,
// in the plain PyTorch route's operation order (ops/projection.py,
// ops/transforms.py, ops/sh.py): the forward kernel (preprocess_fwd.cu, P2)
// computes its outputs from them, and the VJP kernel (preprocess_bwd.cu,
// P1) recomputes them from the leaves, so that the culls and clamps the
// backward sees are, by construction, the ones the forward decided.
//
// Orders that are PyTorch's and not the source's own, read on an H100:
// the [N,3] x [3,3] and [N,3] x [3,4] products are cuBLAS', which adds in k
// order with fused multiply-adds, then the translation column;
// torch.linalg.norm adds the squares of even and odd entries apart, then
// the two: (w^2 + y^2) + (x^2 + z^2) over a quaternion, (x^2 + z^2) + y^2
// over the view direction; the einsum of the SH basis with the
// coefficients is a batched GEMV that sums each half of k with fused
// multiply-adds from 0, then adds the halves. `1.0 / x` in PyTorch is the
// reciprocal times 1, so an IEEE division. Everything else is one rounding
// an operation, which the build's --fmad=false keeps.
//
// Also the staging of a block's f_rest rows through shared memory: 12 R
// bytes a row (180 at SH 3), not a multiple of 16, so a thread striding
// its own row through device memory would touch a new sector every few
// floats; the block's rows, one contiguous range, move with coalesced
// 16-byte accesses, rows padded to an odd stride so that a thread's walk
// along its own row is free of bank conflicts.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNearZ = 0.2f;      // FRUSTUM_NEAR_Z
constexpr float kDilation = 0.3f;   // COV2D_DILATION
constexpr float kNormMin = 1e-12f;  // the view direction's norm clamp

// SH constants as PyTorch rounds the Python floats of ops/sh.py
#define F(x) static_cast<float>(x)
__device__ __forceinline__ float c0() { return F(0.28209479177387814); }
constexpr float kC1 = F(0.4886025119029199);
__constant__ float kC2[5] = {F(1.0925484305920792), F(-1.0925484305920792),
                             F(0.31539156525252005), F(-1.0925484305920792),
                             F(0.5462742152960396)};
__constant__ float kC3[7] = {F(-0.5900435899266435), F(2.890611442640554),
                             F(-0.4570457994644658), F(0.3731763325901154),
                             F(-0.4570457994644658), F(1.445305721320277),
                             F(-0.5900435899266435)};
__constant__ float kC4[9] = {F(2.5033429417967046), F(-1.7701307697799304),
                             F(0.9461746957575601), F(-0.6690465435572892),
                             F(0.10578554691520431), F(-0.6690465435572892),
                             F(0.47308734787878004), F(-1.7701307697799304),
                             F(0.6258357354491761)};
#undef F

// The camera as the projection reads it: the world-to-camera rotation W and
// translation V (rows of `view`), the focal lengths and the clamp limits.
struct CameraView {
  float W[3][3];
  float V[3];
  float fx, fy;
  float lim_x, lim_y;
};

__device__ __forceinline__ CameraView load_camera(const float* view, const float* tan_fovx,
                                                  const float* tan_fovy, int width, int height) {
  CameraView c;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) c.W[r][k] = __ldg(view + 4 * r + k);
    c.V[r] = __ldg(view + 4 * r + 3);
  }
  const float tanx = __ldg(tan_fovx), tany = __ldg(tan_fovy);
  // Camera.focal_x = width / (2 tan): PyTorch's reciprocal, then the product
  c.fx = (1.0f / (2.0f * tanx)) * static_cast<float>(width);
  c.fy = (1.0f / (2.0f * tany)) * static_cast<float>(height);
  c.lim_x = 1.3f * tanx;
  c.lim_y = 1.3f * tany;
  return c;
}

// scale = exp(log_scale) * modifier (e = the exponential), and its square
__device__ __forceinline__ void scales(const float* log_scale, int64_t g, float mod, float* e,
                                       float* s, float* s2) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e[k] = expf(__ldg(log_scale + 3 * g + k));
    s[k] = e[k] * mod;
    s2[k] = s[k] * s[k];
  }
}

// The raw quaternion (w, x, y, z as q4.x .. q4.w), its norm and the unit one.
struct UnitQuat {
  float4 q4;
  float qn;
  float w, x, y, z;
};

__device__ __forceinline__ UnitQuat unit_quat(const float* quat, int64_t g) {
  UnitQuat q;
  q.q4 = __ldg(reinterpret_cast<const float4*>(quat) + g);
  const float4 v = q.q4;
  // torch.linalg.norm's order over 4 entries on this card: (w^2 + y^2) + (x^2 + z^2)
  q.qn = sqrtf((v.x * v.x + v.z * v.z) + (v.y * v.y + v.w * v.w));
  q.w = v.x / q.qn;
  q.x = v.y / q.qn;
  q.y = v.z / q.qn;
  q.z = v.w / q.qn;
  return q;
}

// transforms.quat_to_rotmat of the unit quaternion
__device__ __forceinline__ void rotation(const UnitQuat& q, float (&R)[3][3]) {
  const float w = q.w, x = q.x, y = q.y, z = q.z;
  R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  R[0][1] = 2.0f * (x * y - w * z);
  R[0][2] = 2.0f * (x * z + w * y);
  R[1][0] = 2.0f * (x * y + w * z);
  R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  R[1][2] = 2.0f * (y * z - w * x);
  R[2][0] = 2.0f * (x * z - w * y);
  R[2][1] = 2.0f * (y * z + w * x);
  R[2][2] = 1.0f - 2.0f * (x * x + y * y);
}

// transforms.build_covariance_packed, unpacked: Sigma_ij = sum_k s_k^2 R_ik R_jk
__device__ __forceinline__ void covariance(const float* s2, const float (&R)[3][3],
                                           float (&S)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) {
      S[i][j] = s2[0] * R[i][0] * R[j][0] + s2[1] * R[i][1] * R[j][1] + s2[2] * R[i][2] * R[j][2];
      S[j][i] = S[i][j];
    }
  }
}

// The camera-space centre t = W p + V: cuBLAS' fused k-order sum, then V.
// The near cull keeps t[2] > kNearZ.
__device__ __forceinline__ void camera_centre(const CameraView& c, float px, float py, float pz,
                                              float (&t)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    t[r] = fmaf(c.W[r][2], pz, fmaf(c.W[r][1], py, c.W[r][0] * px)) + c.V[r];
  }
}

// a . Sigma . b in project_gaussians' operation order
__device__ __forceinline__ float quad(const float (&S)[3][3], const float* a, const float* b) {
  return S[0][0] * a[0] * b[0] + S[1][1] * a[1] * b[1] + S[2][2] * a[2] * b[2]
       + S[0][1] * (a[0] * b[1] + a[1] * b[0]) + S[0][2] * (a[0] * b[2] + a[2] * b[0])
       + S[1][2] * (a[1] * b[2] + a[2] * b[1]);
}

// projection.ewa past the camera-space centre: x/z and y/z and their clamps,
// J, the rows t0, t1 of T = J W and the 2D covariance J W Sigma W^T J^T +
// 0.3 I. `tz` is the safe divisor: t[2] where in front of the near plane,
// else 1.
struct Ewa {
  float ux, uy;    // x/z, y/z before the clamp
  float txz, tyz;  // after it
  float inv_tz;
  float t0[3], t1[3];
  float c_xx, c_xy, c_yy, det;
};

__device__ __forceinline__ Ewa ewa(const CameraView& c, const float (&t)[3], float tz,
                                   const float (&S)[3][3]) {
  Ewa e;
  e.ux = t[0] / tz;
  e.uy = t[1] / tz;
  e.txz = fminf(fmaxf(e.ux, -c.lim_x), c.lim_x);
  e.tyz = fminf(fmaxf(e.uy, -c.lim_y), c.lim_y);
  e.inv_tz = 1.0f / tz;
  const float j00 = c.fx * e.inv_tz, j02 = -c.fx * e.txz * e.inv_tz;
  const float j11 = c.fy * e.inv_tz, j12 = -c.fy * e.tyz * e.inv_tz;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e.t0[k] = j00 * c.W[0][k] + j02 * c.W[2][k];
    e.t1[k] = j11 * c.W[1][k] + j12 * c.W[2][k];
  }
  e.c_xx = quad(S, e.t0, e.t0) + kDilation;
  e.c_xy = quad(S, e.t0, e.t1);
  e.c_yy = quad(S, e.t1, e.t1) + kDilation;
  e.det = e.c_xx * e.c_yy - e.c_xy * e.c_xy;
  return e;
}

// The clip-space centre p_hom = full_proj[:, :3] p + full_proj[:, 3], as cuBLAS
// adds the [N,3] x [3,4] product.
__device__ __forceinline__ void clip_centre(const float* P, float px, float py, float pz,
                                            float (&ph)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ph[r] = fmaf(__ldg(P + 4 * r + 2), pz, fmaf(__ldg(P + 4 * r + 1), py, __ldg(P + 4 * r) * px))
          + __ldg(P + 4 * r + 3);
  }
}

// The view direction p - cam_pos, its norm, the clamped norm and the unit direction.
struct ViewDir {
  float dx, dy, dz;
  float nrm, nc;
  float ux, uy, uz;
};

__device__ __forceinline__ ViewDir view_dir(const float* cam_pos, float px, float py, float pz) {
  ViewDir v;
  v.dx = px - __ldg(cam_pos);
  v.dy = py - __ldg(cam_pos + 1);
  v.dz = pz - __ldg(cam_pos + 2);
  v.nrm = sqrtf((v.dx * v.dx + v.dz * v.dz) + v.dy * v.dy);
  v.nc = fmaxf(v.nrm, kNormMin);
  v.ux = v.dx / v.nc;
  v.uy = v.dy / v.nc;
  v.uz = v.dz / v.nc;
  return v;
}

// The SH basis at unit direction (x, y, z), in ops/sh.py's operation order.
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = c0();
  if constexpr (D > 0) {
    b[1] = -kC1 * y;
    b[2] = kC1 * z;
    b[3] = -kC1 * x;
  }
  if constexpr (D > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = kC2[0] * xy;
    b[5] = kC2[1] * yz;
    b[6] = kC2[2] * (2.0f * zz - xx - yy);
    b[7] = kC2[3] * xz;
    b[8] = kC2[4] * (xx - yy);
    if constexpr (D > 2) {
      b[9] = kC3[0] * y * (3.0f * xx - yy);
      b[10] = kC3[1] * xy * z;
      b[11] = kC3[2] * y * (4.0f * zz - xx - yy);
      b[12] = kC3[3] * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = kC3[4] * x * (4.0f * zz - xx - yy);
      b[14] = kC3[5] * z * (xx - yy);
      b[15] = kC3[6] * x * (xx - 3.0f * yy);
    }
    if constexpr (D > 3) {
      b[16] = kC4[0] * xy * (xx - yy);
      b[17] = kC4[1] * yz * (3.0f * xx - yy);
      b[18] = kC4[2] * xy * (7.0f * zz - 1.0f);
      b[19] = kC4[3] * yz * (7.0f * zz - 3.0f);
      b[20] = kC4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = kC4[5] * xz * (7.0f * zz - 3.0f);
      b[22] = kC4[6] * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = kC4[7] * xz * (xx - 3.0f * yy);
      b[24] = kC4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// Channel c of the pre-clamp colour sum_k b[k] f[k][c], f_dc first, then the
// rest row (3 floats a coefficient): the einsum's two halves of k, each
// summed with fused multiply-adds from 0, then added.
template <int D>
__device__ __forceinline__ float sh_rgb(const float* b, float fdc, const float* row, int c) {
  constexpr int K = (D + 1) * (D + 1);
  constexpr int H = (K + 1) / 2;
  float lo = fmaf(b[0], fdc, 0.0f);
#pragma unroll
  for (int k = 1; k < H; ++k) lo = fmaf(b[k], row[3 * (k - 1) + c], lo);
  float hi = 0.0f;
#pragma unroll
  for (int k = H; k < K; ++k) hi = fmaf(b[k], row[3 * (k - 1) + c], hi);
  return lo + hi;
}

// Shared-memory slot of element e of the block's rows (row stride padded).
__device__ __forceinline__ int padded(int e, int len, int stride) {
  return (e / len) * stride + e % len;
}

// The block's `total` contiguous floats of f_rest (16-byte aligned when the
// tensor is) into shared memory, rows of `len` floats padded to `stride`.
template <int Block>
__device__ void stage_in(float* smem, const float* src, int total, int len, int stride) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = total >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int v = threadIdx.x; v < nv; v += Block) {
      const float4 q = __ldcs(src4 + v);
      const int e = v * 4;
      smem[padded(e, len, stride)] = q.x;
      smem[padded(e + 1, len, stride)] = q.y;
      smem[padded(e + 2, len, stride)] = q.z;
      smem[padded(e + 3, len, stride)] = q.w;
    }
    head = nv * 4;
  }
  for (int e = head + threadIdx.x; e < total; e += Block) {
    smem[padded(e, len, stride)] = __ldcs(src + e);
  }
}

}  // namespace
