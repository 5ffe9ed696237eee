"""Tile binning: depth ordering + chunk-aligned (tile, splat) pair layout.

Port of ``gs_tpu/ops/binning.py``: ``tile_rect``, ``bin_gaussians_aligned``
(the rasterizer's binning) and ``bin_gaussians`` (gs_tpu's reference
per-tile binning, which its tests hold the aligned one against; no
render path runs it). The reference rasterizer duplicates
each splat per covered tile with 64-bit [tile | depth] keys and one radix
sort. Here, as in gs_tpu:

  1. a stable depth sort of the Gaussians (culled ones last),
  2. per Gaussian, its clamped tile rect and covered-tile count; a running
     sum gives its slot range in a fixed pair budget (Gaussians whose range
     would cross the budget are dropped, deepest first, and ``num_pairs``
     still reports the true total),
  3. one stable sort of the pairs by tile id, which keeps each tile's run in
     depth order,
  4. each tile's run placed at a chunk-aligned offset; padding slots point
     at the NULL row N.

gs_tpu computes steps 2-4 with TPU-specific workarounds (f32 delta
scatters + two-level ``vec_cumsum``, an MXU tile-count contraction). On
the GPU these are plain ``repeat_interleave``, ``bincount``, ``cumsum`` and
a stable ``sort``; the integer outputs are identical.

Step 2's per-slot owner fields come from one of two paths, as in gs_tpu
(``EXPAND_IMPL`` / ``expand_impl``): ``"scatter"`` (the default, gs_tpu's
default's counterpart) expands the surviving pairs with
``repeat_interleave``; ``"cuda"`` (gs_tpu's ``"pallas"``) expands the
owner fields over every budget slot with the interval-expand kernel B6
(``pairmove.expand_intervals``). Both give the same integers.

``carry_attr`` (gs_tpu's carry pair source) adds the per-pair attribute
table ``pair_attr``, bitwise equal to ``attr_pad[pair_gauss]`` without a
pair gather: the [N, K] attributes ride the depth sort, B6 (in the same
launch as the five owner fields) and the pair sort into their slots. It
takes the B6 path, as gs_tpu asserts (gs_tpu/ops/binning.py:255-256).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gs_tpu_torch.ops import pairmove, switches

EXPAND_IMPLS = switches.values("EXPAND_IMPL")
# step 2's path when bin_gaussians_aligned is not told one (gs_tpu's
# binning.EXPAND_IMPL, whose "pallas" is spelled "cuda" here), set from
# GS_TPU_BIN_EXPAND at import
EXPAND_IMPL = switches.read("EXPAND_IMPL")
# B6's columns on the "cuda" path: offset, original index, x0, y0, max(w, 1),
# then carry_attr's, all in one launch
OWNER_FIELDS = 5
MAX_CARRY_COLUMNS = pairmove.MAX_COLUMNS - OWNER_FIELDS


def tile_rect(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamped tile rect [x0,x1) x [y0,y1) covered by each splat: the bbox
    of center +- radius snapped outward to tile boundaries (``getRect``)."""
    r = radii.to(torch.float32)
    i32 = torch.int32
    x0 = torch.clamp(torch.floor((means2d[:, 0] - r) / tile_w), 0, tiles_x).to(i32)
    y0 = torch.clamp(torch.floor((means2d[:, 1] - r) / tile_h), 0, tiles_y).to(i32)
    x1 = torch.clamp(torch.floor((means2d[:, 0] + r + tile_w - 1) / tile_w), 0, tiles_x).to(i32)
    y1 = torch.clamp(torch.floor((means2d[:, 1] + r + tile_h - 1) / tile_h), 0, tiles_y).to(i32)
    empty = radii <= 0
    x1 = torch.where(empty, x0, x1)
    y1 = torch.where(empty, y0, y1)
    return x0, y0, x1, y1


class TileBinning(NamedTuple):
    """``bin_gaussians``' result. The pair arrays have length ``pair_budget``;
    ``pair_gauss`` indexes the original Gaussian arrays. Padding pairs carry
    ``pair_tile == tiles_x * tiles_y`` and are sorted to the end."""

    pair_gauss: torch.Tensor  # [B] int32, original Gaussian index per pair
    pair_tile: torch.Tensor  # [B] int32, tile id per pair (T for padding)
    tile_offsets: torch.Tensor  # [T+1] int32, tile t's pairs are [off[t], off[t+1])
    num_pairs: torch.Tensor  # 0-d int64, true pair count (may exceed the budget)
    depth_order: torch.Tensor  # [N] int32, Gaussian indices sorted by depth


class AlignedBinningOut(NamedTuple):
    """Chunk-aligned binning result.

    ``pair_gauss`` [AB] indexes the original Gaussian arrays; padding and
    unused slots hold N, so gathering from an attribute table with one zero
    NULL row appended makes them inert. Tile t owns slots
    [starts[t], ends[t]), a multiple of ``align`` long, in depth order.
    """

    pair_gauss: torch.Tensor  # [AB] int32, original index (N = null row)
    depth_order: torch.Tensor  # [N] int32
    valid: torch.Tensor  # [AB] bool
    starts: torch.Tensor  # [T] int32, multiples of align
    ends: torch.Tensor  # [T] int32
    num_pairs: torch.Tensor  # 0-d int64, true (unclamped) pair count
    # count_by_gauss only: [N] int32 surviving pair count per ORIGINAL
    # gaussian, the multiset of pair_gauss values < N
    gauss_counts: torch.Tensor | None = None
    # carry_attr only: [AB, K] float32 per-pair attributes, carry_attr[pair_gauss]
    # with zero rows on null slots (gs_tpu's pair_attr_t, row-major here)
    pair_attr: torch.Tensor | None = None


def vec_cumsum(x: torch.Tensor) -> torch.Tensor:
    """1-D inclusive running sum (gs_tpu's two-level [rows, 128] scan, a TPU
    layout of the same sums; here one ``cumsum`` in ``x``'s dtype)."""
    return torch.cumsum(x, 0, dtype=x.dtype)


def vec_cummax(x: torch.Tensor) -> torch.Tensor:
    """1-D inclusive running maximum (gs_tpu's two-level scan, as ``vec_cumsum``)."""
    return torch.cummax(x, 0).values


def strip_columns(tiles_x: int, col_stride: int) -> int:
    """Tile columns of one strip: ceil(tiles_x / col_stride)."""
    return -(-tiles_x // col_stride)


def aligned_buffer_size(pair_budget: int, num_tiles: int, align: int) -> int:
    """AB: the pair budget plus room for every tile's alignment padding."""
    return -(-(pair_budget + num_tiles * (align - 1)) // align) * align


def resolve_expand_impl(expand_impl: str | None) -> str:
    """Step 2's path: ``expand_impl``, or ``EXPAND_IMPL`` for None. "cuda"
    holds at any size B6's int32 indices take: gs_tpu takes its kernel only
    below 2^24 slots and Gaussians, where its f32 ids are exact
    (gs_tpu/ops/binning.py:252-254), and the port's kernel has no such limit."""
    impl = EXPAND_IMPL if expand_impl is None else expand_impl
    if impl not in EXPAND_IMPLS:
        raise ValueError(f"unknown expand_impl {impl!r}; expected one of {EXPAND_IMPLS}")
    return impl


def bin_gaussians_aligned(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_budget: int,
    align: int,
    count_by_gauss: bool = False,
    expand_impl: str | None = None,
    carry_attr: torch.Tensor | None = None,
    col_stride: int = 1,
    col_offset: int = 0,
) -> AlignedBinningOut:
    """Depth-ordered per-tile pair lists in a chunk-aligned fixed-size buffer
    (gs_tpu ``binning.bin_gaussians_aligned``). ``count_by_gauss`` adds
    ``gauss_counts``; ``expand_impl`` picks step 2's path (see
    ``resolve_expand_impl``); ``carry_attr`` [N, K] float32 adds
    ``pair_attr`` and takes the B6 path (None means "cuda" then; "scatter"
    raises), with K at most ``MAX_CARRY_COLUMNS``.

    ``col_stride`` / ``col_offset`` bin one column strip of a tile-sharded
    mesh: every ``col_stride``-th tile column from ``col_offset``
    (gs_tpu/ops/binning.py:178-243). Tile ids are then compact: tile
    ``ty * ceil(tiles_x / col_stride) + cx`` is global column
    ``col_offset + cx * col_stride`` (``parallel.sharded.local_to_global_tiles``)."""
    n = means2d.shape[0]
    dev = means2d.device
    tiles_x_c = strip_columns(tiles_x, col_stride)
    num_tiles = tiles_x_c * tiles_y
    ab = aligned_buffer_size(pair_budget, num_tiles, align)
    i64 = torch.int64

    # 1. depth order + per-gaussian tile rects
    safe_depth = torch.where(radii > 0, depths, torch.inf)
    x0, y0, x1, y1 = tile_rect(means2d, radii, tiles_x, tiles_y, tile_w, tile_h)
    if col_stride > 1:
        # a rect's global columns [x0, x1) cover the strip's compact columns
        # [ceil((x0 - off) / stride), ceil((x1 - off) / stride))
        x0 = -torch.div(col_offset - x0, col_stride, rounding_mode="floor")
        x1 = -torch.div(col_offset - x1, col_stride, rounding_mode="floor")
        x0 = torch.clamp(x0, 0, tiles_x_c)
        x1 = torch.clamp(torch.maximum(x1, x0), max=tiles_x_c)
    depth_order = torch.sort(safe_depth, stable=True).indices
    sx0, sy0 = x0[depth_order].to(i64), y0[depth_order].to(i64)
    w = (x1 - x0)[depth_order].to(i64)
    h = (y1 - y0)[depth_order].to(i64)
    counts = w * h
    inc_cum = torch.cumsum(counts, 0)
    num_pairs = inc_cum[-1] if n > 0 else torch.zeros((), dtype=i64, device=dev)
    # budget overflow drops whole deepest gaussians (a depth prefix fits)
    fit_counts = torch.where(inc_cum <= pair_budget, counts, 0)

    # 2. expand: one (tile, original index) entry per surviving pair, in depth order
    fields = (sx0, sy0, w, inc_cum - counts, fit_counts, depth_order, tiles_x_c, tiles_y,
              pair_budget)
    carry_words = None
    if carry_attr is not None:
        check_carry_attr(carry_attr, n, expand_impl)
        # the depth sort's payload: a gather of the attributes' 32-bit words
        # (they travel as int32 words from here to pair_attr; see expand_owner_fields)
        carry_words = carry_attr.view(torch.int32)[depth_order]
        tile, gauss, carry_words = expand_owner_fields(*fields, carry_words=carry_words)
    elif resolve_expand_impl(expand_impl) == "cuda":
        tile, gauss = expand_owner_fields(*fields)
    else:
        tile, gauss = repeat_owner_fields(*fields)

    # 3. stable sort by tile keeps each tile's run in depth order
    tile_sorted, perm = torch.sort(tile, stable=True)
    gauss_sorted = gauss[perm]

    # 4. chunk-aligned placement of each tile's run
    tile_counts = torch.bincount(tile, minlength=num_tiles)
    acnt = -(-tile_counts // align) * align
    astarts = torch.cumsum(acnt, 0) - acnt
    first = torch.cumsum(tile_counts, 0) - tile_counts  # run start in tile_sorted
    dest = astarts[tile_sorted] + torch.arange(tile_sorted.numel(), device=dev) \
        - first[tile_sorted]
    pair_gauss = torch.full((ab,), n, dtype=torch.int32, device=dev)
    pair_gauss[dest] = gauss_sorted.to(torch.int32)
    valid = torch.zeros(ab, dtype=torch.bool, device=dev)
    valid[dest] = True
    pair_attr = None
    if carry_words is not None:
        # the pair sort's payload; zero words (+0.0) on the null slots, as the
        # gather reads them from attr_pad's zero row
        words = torch.zeros((ab, carry_words.shape[0]), dtype=torch.int32, device=dev)
        words[dest] = carry_words.t()[perm]
        pair_attr = words.view(torch.float32)
    gauss_counts = None
    if count_by_gauss:
        # un-permute the depth-ordered surviving counts to original indices
        gauss_counts = torch.empty(n, dtype=torch.int32, device=dev)
        gauss_counts[depth_order] = fit_counts.to(torch.int32)
    return AlignedBinningOut(
        pair_gauss=pair_gauss,
        depth_order=depth_order.to(torch.int32),
        valid=valid,
        starts=astarts.to(torch.int32),
        ends=(astarts + acnt).to(torch.int32),
        num_pairs=num_pairs,
        gauss_counts=gauss_counts,
        pair_attr=pair_attr,
    )


def repeat_owner_fields(sx0, sy0, w, offsets, fit_counts, depth_order, tiles_x, tiles_y,
                        pair_budget):
    """Step 2 on the "scatter" path: ``repeat_interleave`` lists each
    surviving pair's depth-sorted owner; (tile, original index) per pair.
    Arguments are per depth-sorted Gaussian (rect corner, width, slot
    offset, surviving count) as ``expand_owner_fields`` takes them."""
    owner = torch.repeat_interleave(torch.arange(w.shape[0], device=w.device), fit_counts)
    local = torch.arange(owner.numel(), device=w.device) - offsets[owner]
    w_o = w[owner]
    return (sy0[owner] + local // w_o) * tiles_x + sx0[owner] + local % w_o, depth_order[owner]


def check_carry_attr(carry_attr: torch.Tensor, n: int, expand_impl: str | None) -> None:
    if (carry_attr.dtype != torch.float32 or carry_attr.dim() != 2 or carry_attr.shape[0] != n
            or not 1 <= carry_attr.shape[1] <= MAX_CARRY_COLUMNS):
        raise ValueError(f"carry_attr must be float32 [{n}, K<={MAX_CARRY_COLUMNS}], got "
                         f"{carry_attr.dtype} {tuple(carry_attr.shape)}")
    if expand_impl is not None and resolve_expand_impl(expand_impl) != "cuda":
        raise ValueError("carry_attr rides the interval expand: expand_impl must be 'cuda' "
                         f"(or None), got {expand_impl!r}")


def expand_owner_fields(sx0, sy0, w, offsets, fit_counts, depth_order, tiles_x, tiles_y,
                        pair_budget, carry_words=None):
    """Step 2 through B6 (gs_tpu ``binning.py:322-343``): slot p's owner is
    the depth-sorted Gaussian with offsets[n] <= p < offsets[n] + its
    surviving count. Its offset, original index, x0, y0 and max(w, 1) are
    expanded over the budget's slots; the surviving pairs are the slot
    prefix below the surviving total (the fit Gaussians are a depth
    prefix), whose (tile, original index) entries are returned.

    ``carry_words`` [N, K] int32 (depth-sorted attributes as 32-bit words)
    ride the same launch as K more columns and come back as a third result,
    [K, surviving pairs]. B6 and its plain version copy words, and the
    floats stay int32 words until binning views pair_attr as float32, so no
    float operation sees them (an int32 owner field viewed as float32 would
    be a denormal, and a float attribute's NaN payload must survive)."""
    i32 = torch.int32
    # Gaussians past the budget own no slot; clamping their offsets to the
    # budget keeps the intervals ordered and the offsets inside int32
    off = offsets.clamp(max=pair_budget)
    cols = torch.stack([off, depth_order, sx0, sy0, w.clamp(min=1)]).to(i32)
    if carry_words is not None:
        cols = torch.cat([cols, carry_words.t()])
    total_fit = int(fit_counts.sum())
    ex = pairmove.expand_intervals(off.to(i32), (off + fit_counts).to(i32), cols,
                                   pair_budget)[:, :total_fit]
    ex_off, ex_idx, ex_x0, ex_y0, ex_w = ex[:OWNER_FIELDS].to(torch.int64)
    local = torch.arange(total_fit, device=w.device) - ex_off
    tile = (ex_y0 + local // ex_w) * tiles_x + ex_x0 + local % ex_w
    if carry_words is None:
        return tile, ex_idx
    return tile, ex_idx, ex[OWNER_FIELDS:]


def bin_gaussians(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_budget: int,
) -> TileBinning:
    """Depth-ordered per-tile splat lists in a fixed pair budget (gs_tpu
    ``binning.bin_gaussians``, its integers exactly): a stable depth sort,
    each pair slot's owner by ``searchsorted`` over the depth-sorted slot
    offsets, a stable sort of the slots by tile and each tile's
    ``[start, end)`` by ``searchsorted``. Slots past ``num_pairs`` (or past
    the budget's end of a Gaussian's run) are padding."""
    n = means2d.shape[0]
    dev = means2d.device
    num_tiles = tiles_x * tiles_y
    i32, i64 = torch.int32, torch.int64

    # 1. depth order (culled splats last)
    safe_depth = torch.where(radii > 0, depths, torch.inf)
    depth_order = torch.sort(safe_depth, stable=True).indices

    # 2. each depth-sorted Gaussian's rect and slot range
    x0, y0, x1, y1 = tile_rect(means2d, radii, tiles_x, tiles_y, tile_w, tile_h)
    sx0, sy0 = x0[depth_order].to(i64), y0[depth_order].to(i64)
    w = (x1 - x0)[depth_order].to(i64)
    counts = w * (y1 - y0)[depth_order].to(i64)
    offsets = torch.cumsum(counts, 0) - counts
    if n == 0:  # no Gaussian: every slot is padding
        sx0 = sy0 = w = offsets = counts = torch.zeros(1, dtype=i64, device=dev)
    num_pairs = offsets[-1] + counts[-1]

    # 3. each slot's owner and tile
    slot = torch.arange(pair_budget, dtype=i64, device=dev)
    owner = (torch.searchsorted(offsets, slot, right=True) - 1).clamp(min=0)
    local = slot - offsets[owner]
    valid = (slot < num_pairs) & (local >= 0) & (local < counts[owner])
    ow = w[owner].clamp(min=1)
    tile = (sy0[owner] + local // ow) * tiles_x + sx0[owner] + local % ow
    pair_tile = torch.where(valid, tile, num_tiles).to(i32)

    # 4. a stable sort by tile keeps each tile's run in depth order
    pair_tile_sorted, tile_order = torch.sort(pair_tile, stable=True)
    pair_gauss = owner[tile_order]
    if n > 0:
        pair_gauss = depth_order[pair_gauss]
    tile_offsets = torch.searchsorted(pair_tile_sorted,
                                      torch.arange(num_tiles + 1, dtype=i32, device=dev))
    return TileBinning(
        pair_gauss=pair_gauss.to(i32),
        pair_tile=pair_tile_sorted,
        tile_offsets=tile_offsets.to(i32),
        num_pairs=num_pairs,
        depth_order=depth_order.to(i32),
    )
