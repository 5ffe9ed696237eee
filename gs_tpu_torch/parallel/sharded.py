"""The tile-sharded render and train step over a (data, shard) mesh (port
of ``gs_tpu/parallel/sharded.py``, its "tile" layout).

gs_tpu writes the step as one ``shard_map``: parameters and Adam are
replicated, the camera batch is split over ``data``, and image tile
COLUMNS are interleaved over ``shard`` (column ``gx`` belongs to shard
``gx % S``: splat density varies wildly across the screen, and
interleaving keeps the strips' loads close). Each shard bins and
composites only its own strip (``composite_strip``), an ``all_gather``
over ``shard`` reassembles the image, each shard takes the L1 + SSIM
terms of its own row band (``losses.banded_photometric_terms``), and
autodiff through the gather routes each pixel's cotangent back to the
strip that owns it. Gradients are summed over ``shard`` and averaged over
``data``; Adam then runs on every rank alike.

PyTorch's autograd does not run through ``torch.distributed``, so the port
writes the step as per-rank functions with the mesh's collectives between
them (``mesh.Mesh``):

  1. ``render_strip``: each rank renders its strip and keeps the graph;
  2. the detached strips are gathered over ``shard``;
  3. ``band_cotangent``: the gradient of this rank's band terms with
     respect to the gathered strips (the whole image);
  4. that cotangent is summed over ``shard`` and the rank keeps its strip's
     slice (the transpose of the gather);
  5. ``strip_backward``: the strip's graph takes that slice, giving the
     parameter and screen-offset gradients;
  6. parameter gradients and band terms are summed over ``shard``, then
     the gradients and the loss are averaged over ``data``; the densify
     terms are summed (``max_radii2d``: maxed) over ``data``;
  7. ``apply_step``: Adam and the densify statistics on the replicated state.

The same functions run on a process-group mesh (one rank a process) and on
an in-process mesh (every rank one after another in one process, the
collectives done by stacking and adding in rank order), so both give the
same numbers; with two ranks, the same bits.

The compositing kernels run inside each strip: B1 / B2 in the chunk form,
B3 / B4 when ``rasterize_tiled.KERNEL_MODE`` is "tile" (a strip takes the
global as gs_tpu's strip does, without the whole frame's 700 KiB rule),
and B5 / B6 under ``GRAD_REDUCE="cuda"`` or ``PAIR_SOURCE="carry"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs_tpu_torch.config import OptimizationParams, RasterizeConfig
from gs_tpu_torch.models import densify, optim
from gs_tpu_torch.ops import rasterize_tiled as rt
from gs_tpu_torch.ops.binning import strip_columns
from gs_tpu_torch.ops.projection import bin_radii
from gs_tpu_torch.renderer import project_splats
from gs_tpu_torch.utils import losses, schedules


def _tile_grid(height: int, width: int, cfg: RasterizeConfig) -> tuple[int, int]:
    return -(-width // cfg.tile_w), -(-height // cfg.tile_h)


def local_to_global_tiles(st, n_shard: int, me: int, device=None):
    """Global tile ids of shard ``me``'s column strip, in compact local
    order, and which of them are real: global column ``gx`` belongs to
    shard ``gx % n_shard``, so compact column ``cx`` is ``gx = me + cx *
    n_shard``; columns past the grid are clamped to its last one (their
    ranges are empty). Returns (ids int32 [T_local], valid bool [T_local])."""
    tiles_x_c = strip_columns(st.tiles_x, n_shard)
    local = torch.arange(st.tiles_y * tiles_x_c, dtype=torch.int32, device=device)
    ty = local // tiles_x_c
    gx = me + (local % tiles_x_c) * n_shard
    valid = gx < st.tiles_x
    return ty * st.tiles_x + torch.clamp(gx, max=st.tiles_x - 1), valid


def local_pair_budget(pair_budget: int, n_shard: int, chunk: int) -> int:
    """A strip's pair budget, the exact value ``composite_strip`` uses (so an
    overflow watcher compares against the real threshold)."""
    return max(-(-(pair_budget // n_shard) // chunk) * chunk, chunk)


def strip_static(raster_cfg: RasterizeConfig, height: int, width: int) -> rt.CompositeStatic:
    """The whole frame's compositing geometry; ``composite_strip`` picks the
    kernel form of each call."""
    backend = rt.resolve_backend(raster_cfg.backend)
    if backend == "oracle":
        raise ValueError("the sharded step composites with 'cuda' or 'torch'")
    tiles_x, tiles_y = _tile_grid(height, width, raster_cfg)
    return rt.CompositeStatic(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=raster_cfg.tile_w,
                              tile_h=raster_cfg.tile_h, chunk=raster_cfg.chunk,
                              tile_batch=raster_cfg.tile_batch, backend=backend)


def strip_kernel_mode(backend: str) -> str | None:
    """A strip's kernel form: gs_tpu's strip builds its CompositeStatic with
    no kernel_mode (gs_tpu/parallel/sharded.py:206-211), so its kernels take
    the KERNEL_MODE global, without the whole frame's 700 KiB rule; None
    for the plain backend."""
    if backend != "cuda":
        return None
    if rt.KERNEL_MODE not in rt.KERNEL_MODES:
        raise ValueError(f"unknown KERNEL_MODE {rt.KERNEL_MODE!r}; "
                         f"expected one of {rt.KERNEL_MODES}")
    return rt.KERNEL_MODE


def pair_budget_of(raster_cfg: RasterizeConfig, capacity: int, pair_budget: int | None) -> int:
    """The whole frame's pair budget (``rasterize_tiled.current_pair_budget``
    unless given), rounded up to a whole chunk."""
    if pair_budget is None:
        return rt.current_pair_budget(raster_cfg, capacity)
    return -(-pair_budget // raster_cfg.chunk) * raster_cfg.chunk


def composite_strip(st, means2d, depths, bin_radii_v, attr, n_shard: int, me: int,
                    pair_budget: int, truncate: bool):
    """Bin, take the pair attributes and composite shard ``me``'s column
    strip (gs_tpu ``composite_strip``): every pair-proportional stage runs
    on the strip only. Returns (tile_color [T_local, P, 3] without the
    background, tile_t [T_local, P], the strip's true pair count)."""
    st = st._replace(kernel_mode=strip_kernel_mode(st.backend))
    local_budget = local_pair_budget(pair_budget, n_shard, st.chunk)
    cs = rt.CarryStatic(st.tiles_x, st.tiles_y, st.tile_w, st.tile_h, local_budget,
                        rt.binning_align(st.chunk, st.backend, st.kernel_mode), n_shard)
    sp_attr, ab = rt.bin_pair_attributes(cs, attr, means2d, depths, bin_radii_v, me)
    my_tiles, _ = local_to_global_tiles(st, n_shard, me, device=attr.device)
    ends = ab.ends
    if truncate:
        with torch.no_grad():
            ends = rt.effective_ends(st, sp_attr, my_tiles, ab.starts, ab.ends)
    tile_color, tile_t, _ = rt.composite_tiles(st, sp_attr, my_tiles, ab.starts, ends)
    return tile_color, tile_t, ab.num_pairs


def reassemble_strips(st, n_shard: int, strips: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """The [3, H, W] image from the gathered strips [n_shard, T_local, P, 3]
    (gs_tpu ``reassemble_strips`` after its all_gather): global column
    ``gx = cx * n_shard + d`` comes from shard d's compact column cx."""
    p = st.tile_w * st.tile_h
    tiles_x_c = strip_columns(st.tiles_x, n_shard)
    by_col = strips.reshape(n_shard, st.tiles_y, tiles_x_c, p, 3)
    full = by_col.permute(1, 2, 0, 3, 4).reshape(st.tiles_y, tiles_x_c * n_shard, p, 3)
    img = full[:, :st.tiles_x].reshape(st.tiles_y, st.tiles_x, st.tile_h, st.tile_w, 3)
    img = img.permute(4, 0, 2, 1, 3).reshape(3, st.tiles_y * st.tile_h, st.tiles_x * st.tile_w)
    return img[:, :height, :width]


class Strip(NamedTuple):
    """One rank's rendered strip and what its backward needs."""

    tile_color: torch.Tensor  # [T_local, P, 3], background applied
    radii: torch.Tensor  # [C] int32
    num_pairs: torch.Tensor  # the strip's true pair count
    params: dict  # the leaves the graph starts from
    offset: torch.Tensor  # [C, 2] screen-offset leaf


def render_strip(state, camera, bg, st, active_sh_degree: int, n_shard: int, me: int,
                 pair_budget: int, truncate: bool, means2d_offset=None):
    """Project every Gaussian (cheap, on every rank) and composite shard
    ``me``'s strip over ``bg`` (gs_tpu ``_sharded_render_image`` before its
    gather). Returns (tile_color, radii, num_pairs)."""
    sp = project_splats(camera, state, active_sh_degree=active_sh_degree,
                        means2d_offset=means2d_offset)
    attr = rt.pack_attributes(sp.means2d, sp.conics, sp.colors, sp.opacities)
    with torch.no_grad():
        radii_b = bin_radii(sp.radii, sp.opacities)
    tile_color, tile_t, num_pairs = composite_strip(st, sp.means2d, sp.depths, radii_b, attr,
                                                    n_shard, me, pair_budget, truncate)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=state.device)
    return tile_color + tile_t[..., None] * bg[None, None, :], sp.radii, num_pairs


def strip_forward(state, camera, bg, st, active_sh_degree: int, n_shard: int, me: int,
                  pair_budget: int, truncate: bool) -> Strip:
    """Step 1: ``render_strip`` from fresh leaves of the parameters and a
    zero screen offset, keeping the graph."""
    params = {k: v.detach().requires_grad_() for k, v in state.params().items()}
    offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=state.device,
                         requires_grad=True)
    with torch.enable_grad():
        tile_color, radii, num_pairs = render_strip(
            state.with_params(params), camera, bg, st, active_sh_degree, n_shard, me,
            pair_budget, truncate, means2d_offset=offset)
    return Strip(tile_color, radii, num_pairs, params, offset)


def band_cotangent(st, n_shard: int, me: int, strips: torch.Tensor, target: torch.Tensor,
                   lambda_dssim: float):
    """Step 3: this rank's share of the loss, ((1 - l) L1 sum - l SSIM sum) /
    (3 H W) over its row band of the image reassembled from ``strips``
    [n_shard, T_local, P, 3], and its gradient with respect to ``strips``.
    Summed over the shards, the shares plus ``lambda_dssim`` are the
    photometric loss and the gradients its image cotangent."""
    height, width = target.shape[1], target.shape[2]
    band_rows = -(-height // n_shard)
    leaf = strips.detach().requires_grad_()
    with torch.enable_grad():
        img = reassemble_strips(st, n_shard, leaf, height, width)
        l1_sum, ssim_sum = losses.banded_photometric_terms(img, target, me * band_rows,
                                                           band_rows)
        contrib = ((1.0 - lambda_dssim) * l1_sum - lambda_dssim * ssim_sum) / (
            3.0 * height * width)
        g, = torch.autograd.grad(contrib, leaf)
    return contrib.detach(), g


def strip_backward(strip: Strip, g_strip: torch.Tensor) -> list[torch.Tensor]:
    """Step 5: the gradients of every parameter group (in ``params()``
    order) and of the screen offset, from the strip's image cotangent."""
    leaves = [*strip.params.values(), strip.offset]
    return list(torch.autograd.grad(strip.tile_color, leaves, grad_outputs=g_strip,
                                    allow_unused=True, materialize_grads=True))


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _split(flat: torch.Tensor, like) -> list[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def apply_step(state, adam, stats, g_params: dict, stat_terms, iteration, spatial_lr_scale,
               apply_update: bool, opt_cfg: OptimizationParams):
    """Step 7: Adam with the reduced gradients (skipped for
    ``apply_update=False``, the reference's final iteration) and the
    densify statistics plus the reduced ``stat_terms`` (grad-norm sum,
    visible count, max radius)."""
    xyz_lr = schedules.expon_lr(
        iteration,
        lr_init=opt_cfg.position_lr_init,
        lr_final=opt_cfg.position_lr_final,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    ) * torch.tensor(spatial_lr_scale, dtype=torch.float32)
    if apply_update:
        new_params, adam = optim.update(state.params(), g_params, adam,
                                        optim.group_lrs(opt_cfg, xyz_lr))
        state = state.with_params(new_params)
    d_accum, d_denom, r_max = stat_terms
    stats = densify.DensifyStats(
        xyz_grad_accum=stats.xyz_grad_accum + d_accum,
        denom=stats.denom + d_denom,
        max_radii2d=torch.maximum(stats.max_radii2d, r_max),
    )
    return state, adam, stats


def make_sharded_train_step(mesh, opt_cfg: OptimizationParams, raster_cfg: RasterizeConfig,
                            height: int, width: int, capacity: int, active_sh_degree: int,
                            pair_budget: int | None = None):
    """The tile-sharded train step on ``mesh`` (gs_tpu
    ``make_sharded_train_step``).

    ``step(state, adam, stats, cam_batch, bg, iteration, spatial_lr_scale,
    apply_update)``: ``cam_batch`` holds one camera a data row (data row d
    renders ``cam_batch[d]``); state, Adam, stats and ``bg`` are the same
    on every rank. Returns the updated (state, adam, stats) and
    ``{"loss", "num_pairs_max"}`` (the largest strip pair count of the
    mesh), alike on every rank.
    """
    n_data, n_shard = mesh.data, mesh.shard
    budget = pair_budget_of(raster_cfg, capacity, pair_budget)
    st = strip_static(raster_cfg, height, width)
    truncate = raster_cfg.truncate_tiles
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32, device=mesh.device)

    def step(state, adam, stats, cam_batch, bg, iteration, spatial_lr_scale, apply_update):
        ranks = mesh.ranks
        strips = {r: strip_forward(state, cam_batch[r[0]], bg, st, active_sh_degree, n_shard,
                                   r[1], budget, truncate) for r in ranks}
        gathered = mesh.gather_shard({r: s.tile_color.detach() for r, s in strips.items()})
        band = {r: band_cotangent(st, n_shard, r[1], gathered[r], cam_batch[r[0]].image,
                                  opt_cfg.lambda_dssim) for r in ranks}
        del gathered
        g_image = mesh.sum_shard({r: g for r, (_, g) in band.items()})
        grads = {r: strip_backward(strips[r], g_image[r][r[1]]) for r in ranks}
        del g_image
        # one buffer a rank: every parameter group, the screen offset, the band term
        row = mesh.sum_shard({r: _flat([*grads[r], band[r][0]]) for r in ranks})
        like = grads[ranks[0]]
        data_terms, r_terms = {}, {}
        for r in ranks:
            *g_params, g_offset, contrib = _split(row[r], [*like, band[r][0]])
            vis = strips[r].radii > 0
            norm = torch.linalg.norm(g_offset * scale, dim=-1)
            data_terms[r] = _flat([*g_params, contrib + opt_cfg.lambda_dssim,
                                   torch.where(vis, norm, 0.0), vis.to(torch.float32)])
            r_terms[r] = torch.where(vis, strips[r].radii.to(torch.float32), 0.0)
        data_terms = mesh.sum_data(data_terms)
        r_max = mesh.max_data(r_terms)
        pairs = mesh.max_all({r: strips[r].num_pairs.to(torch.int64).reshape(1)
                              for r in ranks})
        # every rank now holds the same reduced numbers: apply them once
        r0 = ranks[0]
        *g_params, loss, d_accum, d_denom = _split(
            data_terms[r0], [*like[:-1], like[-1].new_empty(()), like[-1][:, 0],
                             like[-1][:, 0]])
        g_params = {k: g / n_data for k, g in zip(state.params(), g_params)}
        state, adam, stats = apply_step(state, adam, stats, g_params,
                                        (d_accum, d_denom, r_max[r0]), iteration,
                                        spatial_lr_scale, apply_update, opt_cfg)
        return state, adam, stats, {"loss": loss / n_data, "num_pairs_max": pairs[r0][0]}

    return step


def make_sharded_render(mesh, raster_cfg: RasterizeConfig, height: int, width: int,
                        capacity: int, active_sh_degree: int, pair_budget: int | None = None):
    """Render one camera tile-sharded on ``mesh`` (gs_tpu
    ``make_sharded_render``): ``render(state, camera, bg)`` returns the
    [3, H, W] image (not clamped), alike on every rank."""
    n_shard = mesh.shard
    budget = pair_budget_of(raster_cfg, capacity, pair_budget)
    st = strip_static(raster_cfg, height, width)
    # an in-process mesh renders one data row; the others would repeat it
    row = [r for r in mesh.ranks if r[0] == mesh.ranks[0][0]]

    @torch.no_grad()
    def render(state, camera, bg):
        strips = {r: render_strip(state, camera, bg, st, active_sh_degree, n_shard, r[1], budget,
                                  raster_cfg.truncate_tiles)[0] for r in row}
        gathered = mesh.gather_shard(strips)
        return reassemble_strips(st, n_shard, gathered[row[0]], height, width)

    return render
