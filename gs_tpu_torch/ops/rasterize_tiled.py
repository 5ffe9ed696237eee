"""Tiled rasterizer: binning + chunked per-tile compositing, and its gradient.

Port of ``gs_tpu/ops/rasterize_tiled.py`` on its default path:

  bin (depth-ordered, chunk-aligned pair lists)
  -> one packed [AB, 9] gather ``attr_pad[pair_gauss]`` (a zero NULL row
     makes padding pairs inert)
  -> exact-conservative truncation of each tile's dead tail
  -> composite (CUDA kernel or plain PyTorch, see ``rasterize_cuda``)
  -> background -> untile.

The compositing kernel comes in gs_tpu's two forms, picked per call by
``pick_kernel_mode`` from ``KERNEL_MODE`` and the pair budget, as gs_tpu's
``_pick_kernel_mode`` picks them: the chunk-grid kernels B1 / B2 and the
tile-walk kernels B3 / B4 (whose pair layout is aligned to lcm(chunk,
128), ``binning_align``), which ``"chunk"`` turns to past gs_tpu's switch
point. The startup autotune (``ops/autotune.py``) sets ``KERNEL_MODE``.

The compositing semantics are the reference's sequential ones: skip
alpha < 1/255 and power > 0, cap alpha at 0.99, stop a pixel at the first
pair with T * (1 - alpha) < 1e-4 (T keeps its value before the stop).

``composite_tiles`` is a ``torch.autograd.Function``. Its backward walks
each tile only to its last contributor (``ncon_trimmed_ends``) and hands
the residuals to the backward kernel of the call's form
(``rasterize_cuda.composite_bwd_cuda`` or ``composite_bwd_tile_cuda``) or
its plain version.

The ``[B, 9] -> [N, 9]`` reduction of pair gradients onto Gaussians is
picked by ``GRAD_REDUCE``, as gs_tpu's is: by default (``"scatter"``)
autograd's backward of the ``attr_pad[pair_gauss]`` gather (an
accumulating index_put); for ``"cuda"`` ``GatherPairsSegsum``, whose
backward sorts the pair gradients by Gaussian and sums each Gaussian's
contiguous rows with the segment-reduce kernel B5 (``reduce_pair_grads``).
Binning's expansion path is ``binning.EXPAND_IMPL``'s.

``PAIR_SOURCE="carry"`` (gs_tpu's gather-free carry pipeline) replaces the
gather: ``BinCarryPairs`` bins with the attributes carried through the
depth sort, B6 and the pair sort (``binning.bin_gaussians_aligned``'s
``carry_attr``), bitwise equal to the gather, and its backward is
``reduce_pair_grads`` (B5) whatever ``GRAD_REDUCE`` says.

Spans (``utils/profiling.annotate``): ``gs.render.bin`` from packing the
attributes through the pair source, ``gs.render.composite`` from the
truncation through the untile, ``gs.backward.composite`` (the compositing
backward) and ``gs.backward.pair_reduce`` (``reduce_pair_grads``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gs_tpu_torch.config import RasterizeConfig
from gs_tpu_torch.ops import binning, pairmove, switches
from gs_tpu_torch.ops.projection import bin_radii
from gs_tpu_torch.ops.rasterize_cuda import (ATTR_W, composite_bwd_cuda, composite_bwd_tile_cuda,
                                             composite_bwd_torch, composite_fwd_cuda,
                                             composite_fwd_tile_cuda, composite_fwd_torch)
from gs_tpu_torch.ops.rasterize_oracle import ALPHA_MAX, ALPHA_SKIP, T_EPS, RasterOut
from gs_tpu_torch.utils import profiling

BACKENDS = ("auto", "cuda", "torch", "oracle")


# gradient reduction of the pair gather (gs_tpu rasterize_tiled.GRAD_REDUCE,
# whose "pallas" is spelled "cuda" here, as RasterizeConfig.backend spells it):
#   "scatter" - autograd's backward of attr_pad[pair_gauss];
#   "cuda"    - sort the pair gradients by Gaussian, then the segment-reduce
#               kernel B5.
# gs_tpu's third value, "segsum" (a matrix-unit cumsum kept exact on the TPU),
# computes the same sums as B5 and is not ported. Set from GS_TPU_GRAD_REDUCE
# at import, as gs_tpu's is (ops/switches.py).
GRAD_REDUCES = switches.values("GRAD_REDUCE")
GRAD_REDUCE = switches.read("GRAD_REDUCE")


def check_grad_reduce() -> str:
    if GRAD_REDUCE not in GRAD_REDUCES:
        raise ValueError(f"unknown GRAD_REDUCE {GRAD_REDUCE!r}; expected one of {GRAD_REDUCES}")
    return GRAD_REDUCE


# where the per-pair attributes come from (gs_tpu rasterize_tiled.PAIR_SOURCE):
#   "gather" - attr_pad[pair_gauss], reduced by GRAD_REDUCE's path;
#   "carry"  - BinCarryPairs: carried through binning, reduced by B5.
# gs_tpu carries only below 2^24 pairs and Gaussians (its f32 ids); the
# port's B5 and B6 index in int32, so "carry" holds at every size. Set from
# GS_TPU_PAIR_SOURCE at import.
PAIR_SOURCES = switches.values("PAIR_SOURCE")
PAIR_SOURCE = switches.read("PAIR_SOURCE")


def check_pair_source() -> str:
    if PAIR_SOURCE not in PAIR_SOURCES:
        raise ValueError(f"unknown PAIR_SOURCE {PAIR_SOURCE!r}; expected one of {PAIR_SOURCES}")
    return PAIR_SOURCE


def reduce_pair_grads(g, pair_gauss, seg_cum, n1) -> torch.Tensor:
    """Sum per-pair gradient rows [AB, K] onto Gaussians -> [n1, K] (gs_tpu
    ``reduce_pair_grads``, rasterize_tiled.py:199-223).

    A stable sort of ``pair_gauss`` puts each Gaussian's rows next to each
    other (the null row N's pairs last); ``seg_cum`` [N] int32 is the
    inclusive cumulative pair count per Gaussian (binning's
    ``gauss_counts``). Then B5 (``pairmove.segment_reduce_sorted``), at any
    size its int32 indices take: gs_tpu takes its kernel only below 2^24
    rows and Gaussians, where its f32 row ids are exact, and the port's
    kernel has no such limit. Row N (the null row, whose pairs composite
    against zeros) gets 0. Span: ``gs.backward.pair_reduce``.
    """
    with profiling.annotate("gs.backward.pair_reduce"):
        k = g.shape[1]
        order = torch.sort(pair_gauss, stable=True).indices
        n = n1 - 1
        d = pairmove.segment_reduce_sorted(g[order], seg_cum, n)
        return torch.cat([d, d.new_zeros(n1 - n, k)])


class GatherPairsSegsum(torch.autograd.Function):
    """``attr_pad[pair_gauss]`` whose backward is ``reduce_pair_grads``
    (gs_tpu ``gather_pairs_segsum``) instead of autograd's scatter-add."""

    @staticmethod
    def forward(ctx, attr_pad, pair_gauss, seg_cum):
        ctx.save_for_backward(pair_gauss, seg_cum)
        ctx.n1 = attr_pad.shape[0]
        return attr_pad[pair_gauss]

    @staticmethod
    def backward(ctx, g):
        pair_gauss, seg_cum = ctx.saved_tensors
        return reduce_pair_grads(g.contiguous(), pair_gauss, seg_cum, ctx.n1), None, None


class CarryStatic(NamedTuple):
    """Binning geometry of ``bin_pair_attributes`` and ``BinCarryPairs``;
    ``col_stride`` > 1 bins one column strip of a tile-sharded mesh
    (binning's ``col_stride``)."""

    tiles_x: int
    tiles_y: int
    tile_w: int
    tile_h: int
    pair_budget: int
    align: int
    col_stride: int = 1


class BinCarryPairs(torch.autograd.Function):
    """Binning with the attributes carried to their pair slots (gs_tpu
    ``bin_carry_pairs``, rasterize_tiled.py:239-289): returns the [AB, K]
    per-pair table, bitwise equal to ``attr_pad[pair_gauss]``, then the
    binning's fields (``AlignedBinningOut`` without ``pair_attr``). The
    backward sums the table's gradient rows onto Gaussians with
    ``reduce_pair_grads`` (B5); the binning geometry (means2d, depths, the
    int32 binning radii) and the strip's ``col_offset`` (gs_tpu
    rasterize_tiled.py:240-276) get None, as they are not differentiated."""

    @staticmethod
    def forward(ctx, cs: CarryStatic, attr, means2d, depths, radii_b, col_offset=0):
        ab = binning.bin_gaussians_aligned(
            means2d, depths, radii_b, cs.tiles_x, cs.tiles_y, cs.tile_w, cs.tile_h,
            cs.pair_budget, cs.align, count_by_gauss=True, expand_impl="cuda", carry_attr=attr,
            col_stride=cs.col_stride, col_offset=col_offset)
        seg_cum = torch.cumsum(ab.gauss_counts, 0, dtype=torch.int32)
        aux = ab[:-1]
        ctx.mark_non_differentiable(*aux)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(ab.pair_gauss, seg_cum)
        ctx.n1 = attr.shape[0] + 1
        return (ab.pair_attr, *aux)

    @staticmethod
    def backward(ctx, g, *_):
        pair_gauss, seg_cum = ctx.saved_tensors
        d_attr = None
        if g is not None:
            d_attr = reduce_pair_grads(g.contiguous(), pair_gauss, seg_cum, ctx.n1)[:-1]
        return None, d_attr, None, None, None, None


def bin_carry_pairs(cs: CarryStatic, attr, means2d, depths, radii_b, col_offset: int = 0):
    """(sp_attr [AB, K], binning.AlignedBinningOut without pair_attr)."""
    sp_attr, *aux = BinCarryPairs.apply(cs, attr, means2d, depths, radii_b, col_offset)
    return sp_attr, binning.AlignedBinningOut(*aux)


def bin_pair_attributes(cs: CarryStatic, attr, means2d, depths, radii_b, col_offset: int = 0):
    """Binning and the per-pair attribute table ``sp_attr`` [AB, ATTR_W] on
    the paths ``PAIR_SOURCE`` and ``GRAD_REDUCE`` pick: carried through
    binning (``bin_carry_pairs``), or gathered from ``attr`` with a zero
    NULL row (``attr_pad[pair_gauss]``), whose backward is autograd's
    scatter-add or, for ``"cuda"``, ``GatherPairsSegsum``. ``cs`` (with its
    ``col_stride``) and ``col_offset`` give the binning geometry. Returns
    (sp_attr, binning.AlignedBinningOut without pair_attr)."""
    if check_pair_source() == "carry":
        return bin_carry_pairs(cs, attr, means2d, depths, radii_b, col_offset)
    segred = check_grad_reduce() == "cuda"
    with torch.no_grad():  # binning geometry is not differentiated
        ab = binning.bin_gaussians_aligned(
            means2d, depths, radii_b, cs.tiles_x, cs.tiles_y, cs.tile_w, cs.tile_h,
            cs.pair_budget, cs.align, count_by_gauss=segred, col_stride=cs.col_stride,
            col_offset=col_offset)
    attr_pad = torch.cat([attr, attr.new_zeros(1, ATTR_W)])
    if segred:
        seg_cum = torch.cumsum(ab.gauss_counts, 0, dtype=torch.int32)
        return GatherPairsSegsum.apply(attr_pad, ab.pair_gauss, seg_cum), ab
    return attr_pad[ab.pair_gauss], ab


def resolve_backend(backend: str) -> str:
    """'auto' -> 'cuda': its wrapper launches the kernel on CUDA tensors and
    runs the plain version on CPU tensors."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown rasterizer backend {backend!r}; expected one of {BACKENDS}")
    return "cuda" if backend == "auto" else backend


# the compositing kernel form (gs_tpu rasterize_pallas.KERNEL_MODE):
#   "chunk" - the chunk-grid kernels B1 / B2, until gs_tpu's switch point below;
#   "tile"  - the tile-walk kernels B3 / B4 always.
# The startup autotune (ops/autotune.py) sets it to the form it measures faster;
# GS_TPU_PALLAS_KERNEL sets it at import.
KERNEL_MODES = switches.values("KERNEL_MODE")
KERNEL_MODE = switches.read("KERNEL_MODE")

# gs_tpu's switch point between its two kernel forms
# (gs_tpu/ops/rasterize_tiled.py:309-329): the chunk-grid kernels
# scalar-prefetch two int32[pair_budget // chunk] visit tables and
# int32[num_tiles + 1] tile ids, and past 700 KiB those no longer fit a TPU
# core's scalar memory. The card has no such limit; the port keeps gs_tpu's
# number so that both packages run the same kernel form on the same scene.
TILE_MODE_TABLE_BYTES = 700 * 1024


def pick_kernel_mode(backend: str, pair_budget: int, chunk: int, num_tiles: int) -> str | None:
    """The compositing kernel form for one call (gs_tpu ``_pick_kernel_mode``):
    ``KERNEL_MODE``, except that ``"chunk"`` turns ``"tile"`` (B3 / B4) when
    gs_tpu's chunk-grid tables would pass ``TILE_MODE_TABLE_BYTES``; None for
    the plain PyTorch backend."""
    if resolve_backend(backend) != "cuda":
        return None
    if KERNEL_MODE not in KERNEL_MODES:
        raise ValueError(f"unknown KERNEL_MODE {KERNEL_MODE!r}; expected one of {KERNEL_MODES}")
    tables = 4 * (2 * (pair_budget // chunk) + num_tiles + 1)
    if KERNEL_MODE == "chunk" and tables > TILE_MODE_TABLE_BYTES:
        return "tile"
    return KERNEL_MODE


def binning_align(chunk: int, backend: str, kernel_mode: str | None) -> int:
    """Pair-layout alignment (gs_tpu ``binning_align``): lcm(chunk, 128) for
    the tile-walk kernels, whose TPU form DMAs 128-aligned column blocks,
    else ``chunk``. B3 / B4 take any chunk-aligned layout; the port keeps
    gs_tpu's so that its tile-mode pair layout equals gs_tpu's."""
    if resolve_backend(backend) == "cuda" and kernel_mode == "tile":
        return math.lcm(chunk, 128)
    return chunk


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
    # kernel form of the "cuda" backend: "chunk" (B1 / B2), "tile" (B3 / B4);
    # rasterize_tiled sets it from pick_kernel_mode
    kernel_mode: str | None = None


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


def _compositors(st: CompositeStatic):
    """(forward, backward) for ``st``: the plain versions for the "torch"
    backend, else the wrappers of the kernels of ``st.kernel_mode``'s form."""
    if st.backend == "torch":
        return composite_fwd_torch, composite_bwd_torch
    if st.kernel_mode == "tile":
        return composite_fwd_tile_cuda, composite_bwd_tile_cuda
    return composite_fwd_cuda, composite_bwd_cuda


class CompositeTiles(torch.autograd.Function):
    """Tile compositing with the hand-written backward (see module doc)."""

    @staticmethod
    def forward(ctx, st: CompositeStatic, sp_attr, tile_ids, starts, ends):
        color, t_final, ncon = _compositors(st)[0](st, sp_attr, tile_ids, starts, ends)
        ctx.mark_non_differentiable(ncon)
        ctx.st = st
        ctx.save_for_backward(sp_attr, tile_ids, starts, ends, t_final, ncon)
        return color, t_final, ncon

    @staticmethod
    def backward(ctx, g_color, g_t, g_ncon):
        with profiling.annotate("gs.backward.composite"):
            sp_attr, tile_ids, starts, ends, t_final, ncon = ctx.saved_tensors
            st = ctx.st
            if g_color is None:
                g_color = torch.zeros((*t_final.shape, 3), dtype=torch.float32,
                                      device=t_final.device)
            gt_term = torch.zeros_like(t_final) if g_t is None else g_t * t_final
            trimmed = ncon_trimmed_ends(st, starts, ends, ncon)
            d_attr = _compositors(st)[1](st, sp_attr, tile_ids, starts, trimmed, t_final, ncon,
                                         g_color.contiguous(), gt_term.contiguous())
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
    pair_budget: int | None = None,
) -> RasterOut:
    """Bin -> gather -> composite -> background + untile.

    ``conics`` must be positive definite (projection guarantees it through
    the +0.3 dilation); the ``power > 0`` cull is kept exactly as in the
    reference. The pair budget is ``pair_budget`` if given, else it comes
    from ``cfg`` and N (``current_pair_budget``); either is rounded up to a
    whole chunk, and the kernel form is picked at it (gs_tpu
    rasterize_tiled.py:801-808). ``num_pairs`` in the result reports the
    true pair count, so a caller can see truncation (num_pairs > budget)
    and grow the budget.
    """
    n = means2d.shape[0]
    tiles_x = -(-width // cfg.tile_w)
    tiles_y = -(-height // cfg.tile_h)
    num_tiles = tiles_x * tiles_y
    if pair_budget is None:
        pair_budget = current_pair_budget(cfg, n)
    else:
        pair_budget = -(-pair_budget // cfg.chunk) * cfg.chunk
    backend = resolve_backend(cfg.backend)
    if backend == "oracle":
        raise ValueError("rasterize_tiled composites with 'cuda' or 'torch'; "
                         "the oracle is rasterize_oracle")

    kernel_mode = pick_kernel_mode(backend, pair_budget, cfg.chunk, num_tiles)
    with profiling.annotate("gs.render.bin"):
        attr = pack_attributes(means2d, conics, colors, opacities)
        with torch.no_grad():
            radii_b = bin_radii(radii, opacities)
        cs = CarryStatic(tiles_x, tiles_y, cfg.tile_w, cfg.tile_h, pair_budget,
                         binning_align(cfg.chunk, backend, kernel_mode))
        sp_attr, ab = bin_pair_attributes(cs, attr, means2d, depths, radii_b)

    with profiling.annotate("gs.render.composite"):
        st = CompositeStatic(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=cfg.tile_w,
                             tile_h=cfg.tile_h, chunk=cfg.chunk, tile_batch=cfg.tile_batch,
                             backend=backend, kernel_mode=kernel_mode)
        tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=means2d.device)
        ends = ab.ends
        if cfg.truncate_tiles:
            with torch.no_grad():
                ends = effective_ends(st, sp_attr, tile_ids, ab.starts, ab.ends)
        tile_color, tile_t, _ = composite_tiles(st, sp_attr, tile_ids, ab.starts, ends)

        tile_color = tile_color + tile_t[..., None] * bg[None, None, :]
        # untile [T, P, 3] -> [3, H, W]
        img = tile_color.reshape(tiles_y, tiles_x, cfg.tile_h, cfg.tile_w, 3)
        img = img.permute(4, 0, 2, 1, 3).reshape(3, tiles_y * cfg.tile_h,
                                                 tiles_x * cfg.tile_w)
        ft = tile_t.reshape(tiles_y, tiles_x, cfg.tile_h, cfg.tile_w)
        ft = ft.permute(0, 2, 1, 3).reshape(tiles_y * cfg.tile_h, tiles_x * cfg.tile_w)
        return RasterOut(image=img[:, :height, :width], final_t=ft[:height, :width],
                         num_pairs=ab.num_pairs)
