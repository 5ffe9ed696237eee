"""Tiled rasterizer: binning + chunked per-tile compositing, and its gradient.

Port of ``gs_tpu/ops/rasterize_tiled.py`` on its default path:

  bin (depth-ordered, chunk-aligned pair lists)
  -> one packed [AB, 9] gather ``attr_pad[pair_gauss]`` (a zero NULL row
     makes padding pairs inert)
  -> exact-conservative truncation of each tile's dead tail
  -> composite (CUDA kernel or plain PyTorch, see ``rasterize_cuda``)
  -> background -> untile.

The compositing semantics are the reference's sequential ones: skip
alpha < 1/255 and power > 0, cap alpha at 0.99, stop a pixel at the first
pair with T * (1 - alpha) < 1e-4 (T keeps its value before the stop).

``composite_tiles`` is a ``torch.autograd.Function``. Its backward walks
each tile only to its last contributor (``ncon_trimmed_ends``) and hands
the residuals to the backward kernel (``rasterize_cuda.composite_bwd_cuda``)
or its plain version. The ``[B, 9] -> [N, 9]`` reduction of pair gradients
onto Gaussians is autograd's backward of the ``attr_pad[pair_gauss]``
gather (an accumulating index_put), the twin of gs_tpu's default
``GRAD_REDUCE="scatter"``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gs_tpu_torch.config import RasterizeConfig
from gs_tpu_torch.ops import binning
from gs_tpu_torch.ops.projection import bin_radii
from gs_tpu_torch.ops.rasterize_cuda import (ATTR_W, composite_bwd_cuda, composite_bwd_torch,
                                             composite_fwd_cuda, composite_fwd_torch)
from gs_tpu_torch.ops.rasterize_oracle import ALPHA_MAX, ALPHA_SKIP, T_EPS, RasterOut

BACKENDS = ("auto", "cuda", "torch", "oracle")


def resolve_backend(backend: str) -> str:
    """'auto' -> 'cuda': its wrapper launches the kernel on CUDA tensors and
    runs the plain version on CPU tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown rasterizer backend {backend!r}; expected one of {BACKENDS}")
    return "cuda" if backend == "auto" else backend


def current_pair_budget(cfg: RasterizeConfig, capacity: int) -> int:
    """The pair budget rasterize_tiled derives from cfg and the Gaussian
    capacity, rounded up to a whole chunk (gs_tpu training.py:45-48)."""
    budget = max(int(cfg.pair_budget_factor * capacity), cfg.min_pair_budget)
    return -(-budget // cfg.chunk) * cfg.chunk


def pack_attributes(means2d, conics, colors, opacities) -> torch.Tensor:
    """[N,2]+[N,3]+[N,3]+[N] -> [N, ATTR_W] packed splat attributes."""
    f32 = torch.float32
    return torch.cat([means2d.to(f32), conics.to(f32), colors.to(f32),
                      opacities.to(f32)[:, None]], dim=1)


class CompositeStatic(NamedTuple):
    """Static compositing configuration."""

    tiles_x: int
    tiles_y: int
    tile_w: int
    tile_h: int
    chunk: int
    tile_batch: int
    backend: str  # "cuda" | "torch"


def effective_ends(st: CompositeStatic, sp_attr, tile_ids, starts, ends,
                   margin: float = 0.5) -> torch.Tensor:
    """Chunk-aligned per-tile range ends with the dead tail proven off.

    A pixel terminates at the first pair where T*(1-alpha) < T_EPS; pairs
    past that point contribute nothing. Per tile, alpha_j at any pixel is at
    least alpha_min_j = opac_j * exp(min over the tile rect of power_j) (the
    concave power's minimum over a rect is at a corner), and only pairs
    clearing ALPHA_SKIP at every pixel count, so

        T_pixel(s) <= T_ub(s) = prod_{j<=s} (1 - alpha'_j),
        alpha'_j = alpha_min_j if alpha_min_j >= ALPHA_SKIP else 0.

    Once T_ub < T_EPS * margin every pixel has terminated and the remaining
    chunks are dead weight. Truncating there leaves color, T and ncon
    unchanged; margin < 1 absorbs the rounding of the log-space product
    (gs_tpu rasterize_tiled.py:377-468).

    Works on any disjoint ascending (tile_ids, starts, ends) entry list.
    Returns ends_eff with starts <= ends_eff <= ends, multiples of chunk.
    """
    s = st.chunk
    dev = sp_attr.device
    nchunks = sp_attr.shape[0] // s
    m = tile_ids.shape[0]
    starts64, ends64 = starts.to(torch.int64), ends.to(torch.int64)

    # owning entry of each chunk (-1 where no entry covers it)
    n_own = (ends64 - starts64) // s
    first_chunk = starts64 // s
    entry = torch.repeat_interleave(torch.arange(m, device=dev), n_own)
    chunk_idx = first_chunk[entry] + torch.arange(entry.numel(), device=dev) \
        - (torch.cumsum(n_own, 0) - n_own)[entry]
    owner = torch.full((nchunks,), -1, dtype=torch.int64, device=dev)
    owner[chunk_idx] = entry
    covered = owner >= 0
    owner_c = owner.clamp(min=0)

    # min power over the tile rect at its 4 corners, per pair
    tid = tile_ids.to(torch.int64)[owner_c]  # [nchunks]
    x0 = ((tid % st.tiles_x) * st.tile_w).to(torch.float32)[:, None]
    y0 = ((tid // st.tiles_x) * st.tile_h).to(torch.float32)[:, None]
    x1 = x0 + (st.tile_w - 1)
    y1 = y0 + (st.tile_h - 1)
    a2 = sp_attr[:nchunks * s].reshape(nchunks, s, ATTR_W)
    mx, my = a2[..., 0], a2[..., 1]
    ca, cb, cc = a2[..., 2], a2[..., 3], a2[..., 4]

    def power_at(cx, cy):
        dx = cx - mx
        dy = cy - my
        return -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy

    min_power = torch.minimum(torch.minimum(power_at(x0, y0), power_at(x1, y0)),
                              torch.minimum(power_at(x0, y1), power_at(x1, y1)))
    alpha_min = torch.clamp(a2[..., 8] * torch.exp(min_power), max=ALPHA_MAX)
    alpha_eff = torch.where(alpha_min >= ALPHA_SKIP, alpha_min, 0.0)
    chunk_log = torch.log1p(-alpha_eff).sum(dim=1)  # [nchunks], <= 0

    cum_incl = torch.cumsum(chunk_log, 0)
    cum_excl = cum_incl - chunk_log
    entry_base = cum_excl[first_chunk.clamp(max=max(nchunks - 1, 0))]  # [m]
    t_enter_log = cum_excl - entry_base[owner_c]  # log T_ub entering the chunk
    alive = covered & (t_enter_log > math.log(T_EPS * margin))
    needed = torch.zeros(m, dtype=torch.int64, device=dev)
    needed.index_add_(0, owner_c, alive.to(torch.int64))
    return (starts64 + needed * s).to(torch.int32)


def ncon_trimmed_ends(st: CompositeStatic, starts, ends, ncon) -> torch.Tensor:
    """Backward-only range ends: stop at each tile's last contributor.

    ``ncon`` [M, P] holds global pair positions + 1, so chunks at or past a
    tile's max ncon have zero gradient for every pair and leave the reverse
    walk's carries (T, suffix sum) unchanged: skipping them is exact
    (gs_tpu rasterize_tiled.py:471-484).
    """
    s = st.chunk
    starts64 = starts.to(torch.int64)
    ncon_max = ncon.to(torch.int64).amax(dim=1)
    ne = starts64 + (-(-torch.clamp(ncon_max - starts64, min=0) // s)) * s
    return torch.minimum(torch.maximum(ne, starts64), ends.to(torch.int64)).to(torch.int32)


class CompositeTiles(torch.autograd.Function):
    """Tile compositing with the hand-written backward (see module doc)."""

    @staticmethod
    def forward(ctx, st: CompositeStatic, sp_attr, tile_ids, starts, ends):
        fn = composite_fwd_cuda if st.backend == "cuda" else composite_fwd_torch
        color, t_final, ncon = fn(st, sp_attr, tile_ids, starts, ends)
        ctx.mark_non_differentiable(ncon)
        ctx.st = st
        ctx.save_for_backward(sp_attr, tile_ids, starts, ends, t_final, ncon)
        return color, t_final, ncon

    @staticmethod
    def backward(ctx, g_color, g_t, g_ncon):
        sp_attr, tile_ids, starts, ends, t_final, ncon = ctx.saved_tensors
        st = ctx.st
        if g_color is None:
            g_color = torch.zeros((*t_final.shape, 3), dtype=torch.float32,
                                  device=t_final.device)
        gt_term = torch.zeros_like(t_final) if g_t is None else g_t * t_final
        fn = composite_bwd_cuda if st.backend == "cuda" else composite_bwd_torch
        d_attr = fn(st, sp_attr, tile_ids, starts, ncon_trimmed_ends(st, starts, ends, ncon),
                    t_final, ncon, g_color.contiguous(), gt_term.contiguous())
        return None, d_attr, None, None, None


def composite_tiles(st: CompositeStatic, sp_attr, tile_ids, starts, ends):
    """Composite an explicit tile set. ``sp_attr`` is the packed [B, ATTR_W]
    per-pair table; returns (colors [M,P,3], T_final [M,P], ncon [M,P])."""
    return CompositeTiles.apply(st, sp_attr, tile_ids, starts, ends)


def rasterize_tiled(
    means2d: torch.Tensor,
    conics: torch.Tensor,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    height: int,
    width: int,
    bg: torch.Tensor,
    cfg: RasterizeConfig,
) -> RasterOut:
    """Bin -> gather -> composite -> background + untile.

    ``conics`` must be positive definite (projection guarantees it through
    the +0.3 dilation); the ``power > 0`` cull is kept exactly as in the
    reference. The pair budget comes from ``cfg`` and N; ``num_pairs`` in
    the result reports the true pair count, so a caller can see truncation
    (num_pairs > budget) and grow the budget.
    """
    n = means2d.shape[0]
    tiles_x = -(-width // cfg.tile_w)
    tiles_y = -(-height // cfg.tile_h)
    num_tiles = tiles_x * tiles_y
    pair_budget = current_pair_budget(cfg, n)
    backend = resolve_backend(cfg.backend)
    if backend == "oracle":
        raise ValueError("rasterize_tiled composites with 'cuda' or 'torch'; "
                         "the oracle is rasterize_oracle")

    attr = pack_attributes(means2d, conics, colors, opacities)
    with torch.no_grad():  # binning geometry is not differentiated
        ab = binning.bin_gaussians_aligned(
            means2d, depths, bin_radii(radii, opacities), tiles_x, tiles_y,
            cfg.tile_w, cfg.tile_h, pair_budget, cfg.chunk)
    attr_pad = torch.cat([attr, attr.new_zeros(1, ATTR_W)])
    sp_attr = attr_pad[ab.pair_gauss]

    st = CompositeStatic(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=cfg.tile_w,
                         tile_h=cfg.tile_h, chunk=cfg.chunk, tile_batch=cfg.tile_batch,
                         backend=backend)
    tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=means2d.device)
    ends = ab.ends
    if cfg.truncate_tiles:
        with torch.no_grad():
            ends = effective_ends(st, sp_attr, tile_ids, ab.starts, ab.ends)
    tile_color, tile_t, _ = composite_tiles(st, sp_attr, tile_ids, ab.starts, ends)

    tile_color = tile_color + tile_t[..., None] * bg[None, None, :]
    # untile [T, P, 3] -> [3, H, W]
    img = tile_color.reshape(tiles_y, tiles_x, cfg.tile_h, cfg.tile_w, 3)
    img = img.permute(4, 0, 2, 1, 3).reshape(3, tiles_y * cfg.tile_h, tiles_x * cfg.tile_w)
    ft = tile_t.reshape(tiles_y, tiles_x, cfg.tile_h, cfg.tile_w)
    ft = ft.permute(0, 2, 1, 3).reshape(tiles_y * cfg.tile_h, tiles_x * cfg.tile_w)
    return RasterOut(image=img[:, :height, :width], final_t=ft[:height, :width],
                     num_pairs=ab.num_pairs)
