"""Render API: one camera view of a GaussianState.

Port of ``gs_tpu/renderer.py`` (contract of the reference
``gaussian_renderer/__init__.py:20-112``): returns the image, per-Gaussian
screen radii and the visibility filter. ``means2d_offset`` is added to the
projected pixel centers; its gradient is the screen-space positional
gradient densification reads, in pixel units.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs_tpu_torch.cameras import Camera
from gs_tpu_torch.config import RasterizeConfig
from gs_tpu_torch.models.gaussians import GaussianState
from gs_tpu_torch.ops import preprocess_cuda, projection, sh, transforms
from gs_tpu_torch.ops.rasterize_oracle import rasterize_oracle
from gs_tpu_torch.ops.rasterize_tiled import rasterize_tiled, resolve_backend
from gs_tpu_torch.utils import profiling

_DEFAULT_CFG = RasterizeConfig()


class RenderOut(NamedTuple):
    image: torch.Tensor  # [3,H,W]
    radii: torch.Tensor  # [C] int32 screen radii (0 = invisible)
    visibility: torch.Tensor  # [C] bool, radii > 0
    final_t: torch.Tensor  # [H,W] remaining transmittance
    num_pairs: torch.Tensor | None = None  # true (tile, splat) pair count


class Splats(NamedTuple):
    """What the rasterizer takes from the projection of one view."""

    means2d: torch.Tensor  # [C, 2] pixel centers (+ means2d_offset)
    conics: torch.Tensor  # [C, 3]
    colors: torch.Tensor  # [C, 3]
    opacities: torch.Tensor  # [C], 0 on dead slots
    depths: torch.Tensor  # [C]
    radii: torch.Tensor  # [C] int32 screen radii, 0 on dead slots


def _project_routes(camera, state, active_sh_degree, scaling_modifier, override_color,
                    cov3d_precomp, convert_shs_python, compute_cov3d_python):
    """(ProjectedSplats, colors) of the routes other than the default one,
    under plain autograd."""
    with profiling.annotate("gs.render.project"):
        if cov3d_precomp is not None:
            cov3d = cov3d_precomp
        elif compute_cov3d_python:
            # L = R diag(s), Sigma = L L^T as dense [3,3] matmuls, then the 6-pack
            cov3d = transforms.pack_symmetric(
                transforms.build_covariance(torch.exp(state.log_scale) * scaling_modifier,
                                            state.quat))
        else:
            cov3d = projection.compute_cov3d(state.log_scale, state.quat, scaling_modifier)
        splats = projection.project_gaussians(state.xyz, cov3d, camera)
    with profiling.annotate("gs.render.sh"):
        if override_color is not None:
            colors = override_color
        elif convert_shs_python:
            # [N,K,3] features transposed to the [N,3,K] eval_sh layout
            dirs = state.xyz - camera.cam_pos
            dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
            shs_view = state.features.transpose(1, 2)
            colors = torch.clamp(sh.eval_sh(active_sh_degree, shs_view, dirs) + 0.5, min=0.0)
        else:
            colors = projection.sh_colors(state.xyz, state.features_dc, state.features_rest,
                                          camera.cam_pos, active_sh_degree)
    return splats, colors


def project_splats(
    camera: Camera,
    state: GaussianState,
    *,
    active_sh_degree: int,
    scaling_modifier: float | torch.Tensor = 1.0,
    override_color: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    means2d_offset: torch.Tensor | None = None,
    convert_shs_python: bool = False,
    compute_cov3d_python: bool = False,
) -> Splats:
    """Covariance, projection and colors of ``state`` seen from ``camera``
    (the part of :func:`render` before the rasterizer; the same arguments).
    Spans: ``gs.render.preprocess`` around it, ``gs.render.project`` (the
    covariance and the EWA projection) and ``gs.render.sh`` (the colors).

    The default route (no override, no precomputed covariance, neither
    ``*_python`` toggle) runs ``preprocess_cuda.preprocess``: where autograd
    needs a gradient of the state, one Function whose backward is a
    hand-written VJP; under ``no_grad`` the same plain forward. The other
    routes keep plain autograd: they are the reference's cross-checks."""
    with profiling.annotate("gs.render.preprocess"):
        if (override_color is None and cov3d_precomp is None and not convert_shs_python
                and not compute_cov3d_python):
            splats, colors = preprocess_cuda.preprocess(
                state.xyz, state.log_scale, state.quat, state.features_dc,
                state.features_rest, camera, scaling_modifier, active_sh_degree)
        else:
            splats, colors = _project_routes(camera, state, active_sh_degree, scaling_modifier,
                                             override_color, cov3d_precomp, convert_shs_python,
                                             compute_cov3d_python)

        means2d = splats.means2d
        if means2d_offset is not None:
            means2d = means2d + means2d_offset

        # dead padding slots are hard-culled
        alive = state.alive
        radii = torch.where(alive, splats.radii, 0).to(torch.int32)
        opacities = torch.where(alive[:, None], state.opacity, 0.0)[:, 0]
    return Splats(means2d, splats.conics, colors, opacities, splats.depths, radii)


def render(
    camera: Camera,
    state: GaussianState,
    *,
    active_sh_degree: int,
    bg_color,
    scaling_modifier: float | torch.Tensor = 1.0,
    override_color: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    means2d_offset: torch.Tensor | None = None,
    convert_shs_python: bool = False,
    compute_cov3d_python: bool = False,
    cfg: RasterizeConfig = _DEFAULT_CFG,
) -> RenderOut:
    """Render ``state`` from ``camera`` (both on the same device).

    override_color [C,3] replaces the SH colors; cov3d_precomp [C,6] the
    covariance from scale + rotation. convert_shs_python /
    compute_cov3d_python select the independently formulated SH and
    covariance routes (reference tensor layouts, dense matmuls), the
    reference's cross-checking toggles (``gaussian_renderer/__init__.py:74-94``).
    """
    with profiling.annotate("gs.render"):
        sp = project_splats(camera, state, active_sh_degree=active_sh_degree,
                            scaling_modifier=scaling_modifier, override_color=override_color,
                            cov3d_precomp=cov3d_precomp, means2d_offset=means2d_offset,
                            convert_shs_python=convert_shs_python,
                            compute_cov3d_python=compute_cov3d_python)
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=state.device)
        args = (*sp, camera.height, camera.width, bg)
        if resolve_backend(cfg.backend) == "oracle":
            out = rasterize_oracle(*args, tile_w=cfg.tile_w, tile_h=cfg.tile_h)
        else:
            out = rasterize_tiled(*args, cfg)
        return RenderOut(image=out.image, radii=sp.radii, visibility=sp.radii > 0,
                         final_t=out.final_t, num_pairs=out.num_pairs)
