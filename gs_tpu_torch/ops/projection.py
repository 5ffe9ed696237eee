"""Per-Gaussian preprocess: frustum cull, EWA projection, SH color.

Port of ``gs_tpu/ops/projection.py`` (the preprocess stage of the reference
CUDA rasterizer):

  1. transform centers to camera space, cull z <= 0.2
  2. 2D covariance by EWA splatting: cov2d = J W Sigma W^T J^T + 0.3*I,
     with camera-space x/y clamped to 1.3*tan(fov/2) before differentiating
  3. conic (inverse 2D covariance), screen radius = ceil(3 sqrt(lambda_max))
  4. SH -> RGB for the view direction, clamped at 0

Plain elementwise PyTorch, fp32 throughout (the conic inversion is
ill-conditioned). The operation order follows gs_tpu's so that the integer
radii agree exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs_tpu_torch.cameras import Camera
from gs_tpu_torch.ops import sh as sh_ops
from gs_tpu_torch.ops import transforms

FRUSTUM_NEAR_Z = 0.2  # hard near-cull of the reference preprocess
COV2D_DILATION = 0.3  # low-pass dilation added to the 2D covariance diagonal


class ProjectedSplats(NamedTuple):
    """Per-Gaussian screen-space splat parameters (all [N, ...])."""

    means2d: torch.Tensor  # [N,2] pixel coords of the projected center
    depths: torch.Tensor  # [N] camera-space z (inf where culled)
    conics: torch.Tensor  # [N,3] (a, b, c) inverse 2D covariance
    radii: torch.Tensor  # [N] int32 pixel radius (0 => culled)
    mask: torch.Tensor  # [N] bool, visible after frustum + degeneracy culls


def bin_radii(radii: torch.Tensor, opacities: torch.Tensor) -> torch.Tensor:
    """Opacity-tightened binning radius: the same image from fewer pairs.

    Compositing skips alpha = opac*exp(power) < 1/255, which happens beyond
    r = sigma*sqrt(2 ln(255*opac)); for opac < ~0.46 that is inside the
    3-sigma radius, so binning with min(3 sigma, cutoff) drops only pairs
    whose every pixel is skipped. Splats with opac <= 1/255 get radius 0.
    The compositor must keep the alpha < 1/255 skip exactly for this to
    hold (gs_tpu/ops/projection.py:46-65).
    """
    scale = torch.sqrt(
        torch.clamp(2.0 * torch.log(255.0 * torch.clamp(opacities, min=1e-12)), min=0.0)
    ) / 3.0  # cutoff radius as a fraction of the 3-sigma radius
    r = torch.ceil(radii.to(torch.float32) * torch.clamp(scale, max=1.0))
    return torch.where(opacities > 1.0 / 255.0, r, 0.0).to(torch.int32)


class Ewa(NamedTuple):
    """The EWA projection's intermediates (all [N] or [N,3]), as
    :func:`project_gaussians` computes them; ``preprocess_cuda``'s plain VJP
    recomputes them here, so its culls and clamps are the forward's."""

    t: torch.Tensor  # [N,3] camera-space centres
    in_front: torch.Tensor  # [N] bool, t_z > FRUSTUM_NEAR_Z
    tz: torch.Tensor  # t_z where in front, else 1
    txz: torch.Tensor  # x/z clamped to +-1.3 tan(fovx/2)
    tyz: torch.Tensor
    t0: torch.Tensor  # [N,3] rows of T = J W
    t1: torch.Tensor
    c_xx: torch.Tensor  # the 2D covariance
    c_xy: torch.Tensor
    c_yy: torch.Tensor
    det: torch.Tensor


def ewa(xyz: torch.Tensor, cov3d: torch.Tensor, camera: Camera) -> Ewa:
    """Camera-space centres and the 2D covariance J W Sigma W^T J^T + 0.3 I."""
    view = camera.view

    # camera-space transform & frustum cull
    t = xyz @ view[:3, :3].T + view[:3, 3]  # [N,3]
    in_front = t[:, 2] > FRUSTUM_NEAR_Z
    tz = torch.where(in_front, t[:, 2], 1.0)  # safe divisor

    # EWA: 2D covariance
    focal_x = camera.focal_x
    focal_y = camera.focal_y
    lim_x = 1.3 * camera.tan_fovx
    lim_y = 1.3 * camera.tan_fovy
    txz = torch.clamp(t[:, 0] / tz, -lim_x, lim_x)
    tyz = torch.clamp(t[:, 1] / tz, -lim_y, lim_y)

    inv_tz = 1.0 / tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * txz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -focal_y * tyz * inv_tz

    w_rot = view[:3, :3]  # world->cam rotation
    t0 = j00[:, None] * w_rot[0] + j02[:, None] * w_rot[2]  # [N,3]
    t1 = j11[:, None] * w_rot[1] + j12[:, None] * w_rot[2]  # [N,3]
    xx, xy, xz = cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]
    yy, yz, zz = cov3d[:, 3], cov3d[:, 4], cov3d[:, 5]

    def quad(a, b):  # a . Sigma . b for [N,3] row vectors
        return (
            xx * a[:, 0] * b[:, 0] + yy * a[:, 1] * b[:, 1]
            + zz * a[:, 2] * b[:, 2]
            + xy * (a[:, 0] * b[:, 1] + a[:, 1] * b[:, 0])
            + xz * (a[:, 0] * b[:, 2] + a[:, 2] * b[:, 0])
            + yz * (a[:, 1] * b[:, 2] + a[:, 2] * b[:, 1])
        )

    c_xx = quad(t0, t0) + COV2D_DILATION
    c_xy = quad(t0, t1)
    c_yy = quad(t1, t1) + COV2D_DILATION
    det = c_xx * c_yy - c_xy * c_xy
    return Ewa(t, in_front, tz, txz, tyz, t0, t1, c_xx, c_xy, c_yy, det)


def project_gaussians(xyz: torch.Tensor, cov3d: torch.Tensor, camera: Camera) -> ProjectedSplats:
    """Project N 3D Gaussians into screen space for one camera.

    ``xyz`` [N,3] world centers; ``cov3d`` [N,6] packed world covariance.
    Invalid entries get radius 0 and mask False, with finite numeric fields.
    """
    e = ewa(xyz, cov3d, camera)

    # full projection to pixel coords
    p_hom = xyz @ camera.full_proj[:, :3].T + camera.full_proj[:, 3]  # [N,4]
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    ndc = p_hom[:, :2] * p_w[:, None]
    mean_x = ((ndc[:, 0] + 1.0) * camera.width - 1.0) * 0.5
    mean_y = ((ndc[:, 1] + 1.0) * camera.height - 1.0) * 0.5
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    # conic & radius
    c_xx, c_xy, c_yy, det = e.c_xx, e.c_xy, e.c_yy, e.det
    valid = e.in_front & (det > 0.0)
    inv_det = torch.where(valid, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    conics = torch.stack([c_yy * inv_det, -c_xy * inv_det, c_xx * inv_det], dim=-1)

    mid = 0.5 * (c_xx + c_yy)
    lambda_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda_max))
    radii = torch.where(valid, radius_f, 0.0).to(torch.int32)

    means2d = torch.where(valid[:, None], means2d, 0.0)
    depths = torch.where(valid, e.t[:, 2], torch.inf)
    return ProjectedSplats(means2d=means2d, depths=depths, conics=conics, radii=radii,
                           mask=valid)


def sh_colors(
    xyz: torch.Tensor,
    features_dc: torch.Tensor,
    features_rest: torch.Tensor,
    cam_pos: torch.Tensor,
    active_degree: int,
) -> torch.Tensor:
    """View-dependent RGB from SH coefficients, clamped at 0.

    ``features_dc`` [N,1,3] + ``features_rest`` [N,K-1,3] in the reference
    layout, contracted as one [N,K] x [N,K,3] reduction.
    """
    k = sh_ops.num_sh_coeffs(active_degree)
    dirs = xyz - cam_pos
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
    basis = torch.cat(sh_ops.eval_sh_basis(active_degree, dirs), dim=-1)  # [N,K]
    feats = torch.cat([features_dc, features_rest], dim=1)[:, :k]
    rgb = torch.einsum("nk,nkc->nc", basis, feats)
    return torch.clamp(rgb + 0.5, min=0.0)


def compute_cov3d(
    log_scale: torch.Tensor, quat: torch.Tensor, scale_modifier: float | torch.Tensor = 1.0
) -> torch.Tensor:
    """Activated 3D covariance 6-pack from raw params
    (reference ``scene/gaussian_model.py:27-32``)."""
    return transforms.build_covariance_packed(torch.exp(log_scale) * scale_modifier, quat)
