"""The compositing backward's (B2) warp cull, held against the plain version's decisions on the CPU.

``gs_tpu_torch/csrc/composite_bwd.cu`` skips a pair for a whole warp when
the pair's conservative screen extent (its ``pair_extent``) misses the
warp's pixel rectangle. That keeps every contribution decision only if no
pixel outside the extent passes the forward's tests for the pair. The
kernel runs only on the card; ``pair_extent`` below mirrors its formula in
float64, and the tests hold it against the decisions of the plain version
(``rasterize_cuda._chunk_alpha``, the arithmetic ``composite_bwd_torch``
takes them with) on the golden splats and on seeded draws of bench.py's two
scenes, binned by the port at 16x16 and 48x32 tiles:

- every pair x pixel of the pair's tile that passes the forward's tests
  (power <= 0, alpha >= 1/255) lies inside the extent; these include every
  pair x pixel ``composite_bwd_torch`` counts (which also needs position <
  ncon), and the counted ones are checked as well;
- the extent is tight enough to cull: a good share of each tile's pixels
  lies outside it.

The tile-walk kernels B3 / B4 (``composite_{fwd,bwd}_tile.cu``) share the
cull and B2's pixel layout through ``composite_warps.cuh``, and the
chunk-grid forward B1 (``composite_fwd.cu``) the cull and the layout rule
with a first limit of its own. B1 and B3 walk the untrimmed ranges, so the
extent is also held over those; a mirror of the header's ``choose_layout``
/ ``cell_origin`` is checked against the layouts the header documents for
B2-B4 and for B1; and the share of (pair, warp rectangle) and (pair, 8x4
cell) combinations the culls skip is counted on the heavy draw and, in
B1's layout, on the bench draw (the CPU-side predictors of their gain).
"""

import math
import os

import numpy as np
import pytest
import torch

from gs_tpu_torch import cameras
from gs_tpu_torch.config import RasterizeConfig
from gs_tpu_torch.models import gaussians
from gs_tpu_torch.ops import rasterize_cuda, rasterize_tiled
from gs_tpu_torch.ops.rasterize_oracle import ALPHA_SKIP
from gs_tpu_torch.renderer import render

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "raster_golden.npz")
INPUTS = ("means2d", "conics", "colors", "opacities", "depths", "radii")
TILES = [(16, 16), (48, 32)]
MAX_SKEW = 1e4  # composite_bwd.cu's kMaxSkew
PAIRS_AT_ONCE = 1024
MAX_TILES = 96  # tiles checked per draw, spread evenly over the non-empty ones


def pair_extent(sp_attr: torch.Tensor) -> torch.Tensor:
    """[B, 4] (x lo, x hi, y lo, y hi) float32: composite_bwd.cu's
    ``pair_extent``, formula for formula, in float64."""
    a = sp_attr.double()
    mx, my, ca, cb, cc, op = (a[:, i] for i in (0, 1, 2, 3, 4, 8))
    inf = math.inf
    finite = torch.isfinite(a[:, [0, 1, 2, 3, 4, 8]]).all(1)
    skip = float(np.float32(ALPHA_SKIP))
    nowhere = finite & (op * (1.0 + 1e-6) < skip)
    det = ca * cc - cb * cb
    bounded = finite & ~nowhere & (ca > 0) & (cc > 0) & (det > 0) & (ca * cc <= MAX_SKEW * det)
    safe_det = torch.where(bounded, det, 1.0)
    safe_op = torch.where(bounded, op, 1.0)
    tau = torch.clamp(2.0 * torch.log(255.0 * safe_op), min=0.0) + 1e-4
    tw = tau * (1.0 + 1e-4 * (ca * cc / safe_det))
    hx = torch.sqrt(torch.clamp(tw * cc / safe_det, min=0.0)) + 1.0
    hy = torch.sqrt(torch.clamp(tw * ca / safe_det, min=0.0)) + 1.0
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], 1).float()
    box[~bounded] = torch.tensor([-inf, inf, -inf, inf])
    box[nowhere] = torch.tensor([inf, -inf, inf, -inf])
    return box


def _tile_pairs(starts, ends):
    """(tile index, global position) of every pair of every tile's range."""
    lengths = (ends - starts).long()
    m_of = torch.repeat_interleave(torch.arange(starts.shape[0]), lengths)
    first = torch.cumsum(lengths, 0) - lengths
    pos = starts.long()[m_of] + torch.arange(m_of.numel()) - first[m_of]
    return m_of, pos


def _sample_tiles(tile_ids, starts, ends):
    """Up to MAX_TILES of the non-empty tiles, spread evenly over them."""
    busy = torch.nonzero(ends > starts).flatten()
    keep = busy[::max(1, -(-busy.numel() // MAX_TILES))]
    return tile_ids[keep], starts[keep], ends[keep]


def decisions_vs_extent(st, sp_attr, tile_ids, starts, ends, trim=True):
    """Counts over every pair x pixel of its tile, on up to MAX_TILES of the
    non-empty tiles: (passes the forward's tests, counted by the backward, of
    those outside the extent, counted outside the extent, all pixels outside
    the extent, all pixels). The pairs are those of the ranges trimmed to
    each tile's last contributor (the backward's walk), or with ``trim``
    False of the whole ranges (the forward's)."""
    tile_ids, starts, ends = _sample_tiles(tile_ids, starts, ends)
    _, _, ncon = rasterize_cuda.composite_fwd_torch(st, sp_attr, tile_ids, starts, ends)
    walked = rasterize_tiled.ncon_trimmed_ends(st, starts, ends, ncon) if trim else ends
    m_of, pos = _tile_pairs(starts, walked)
    box = pair_extent(sp_attr)
    counts = torch.zeros(5, dtype=torch.int64)
    for i in range(0, pos.numel(), PAIRS_AT_ONCE):
        m, p = m_of[i:i + PAIRS_AT_ONCE], pos[i:i + PAIRS_AT_ONCE]
        px, py = rasterize_cuda._tile_pixel_coords(tile_ids[m], st)  # [n, P]
        _, _, power, _, _, alpha = rasterize_cuda._chunk_alpha(sp_attr[p][:, None, :],
                                                               px[:, None, :], py[:, None, :])
        passes = ((power <= 0.0) & (alpha >= ALPHA_SKIP))[:, 0]  # [n, P]
        counted = passes & (p[:, None] < ncon[m].long())
        b = box[p]
        inside = ((px >= b[:, 0:1]) & (px <= b[:, 1:2]) & (py >= b[:, 2:3])
                  & (py <= b[:, 3:4]))
        counts += torch.stack([passes.sum(), counted.sum(), (passes & ~inside).sum(),
                               (counted & ~inside).sum(), (~inside).sum()])
    return dict(zip(("passes", "counted", "passes_outside", "counted_outside", "outside"),
                    counts.tolist()), evaluated=int(pos.numel()) * st.tile_w * st.tile_h)


def _static(tw, th, width, height, chunk):
    return rasterize_tiled.CompositeStatic(tiles_x=-(-width // tw), tiles_y=-(-height // th),
                                           tile_w=tw, tile_h=th, chunk=chunk, tile_batch=64,
                                           backend="torch")


def golden_inputs(tw, th):
    g = np.load(GOLDEN)
    h, w = int(g["height"]), int(g["width"])
    ins = [torch.from_numpy(g[k]) for k in INPUTS]
    st = _static(tw, th, w, h, 32)
    ab = rasterize_tiled.binning.bin_gaussians_aligned(
        ins[0], ins[4], rasterize_tiled.bin_radii(ins[5], ins[3]), st.tiles_x, st.tiles_y, tw,
        th, 8192, st.chunk)
    attr = rasterize_tiled.pack_attributes(*ins[:4])
    sp_attr = torch.cat([attr, attr.new_zeros(1, 9)])[ab.pair_gauss]
    tile_ids = torch.arange(st.tiles_x * st.tiles_y, dtype=torch.int32)
    return st, sp_attr, tile_ids, ab.starts, ab.ends


def scene_inputs(kind, tw, th, n=1024, seed=0):
    """bench.py's scene (or its heavy variant) drawn from ``default_rng(seed)``
    at n Gaussians, seen by its 1920x1080 camera; the compositing inputs
    rasterize_tiled builds for it (the render itself is skipped)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    state = gaussians.create_from_pcd(pts, cols, max_sh_degree=3, capacity=n, device="cpu")
    if kind == "bench":
        state.log_scale.clamp_(-6.0, -3.5)
        state.logit_opacity.zero_()
    else:
        state = state.replace(
            log_scale=torch.from_numpy(rng.uniform(-5.5, -2.0, (n, 3)).astype(np.float32)),
            logit_opacity=torch.from_numpy(rng.uniform(-1.5, 2.5, (n, 1)).astype(np.float32)))
    cam = cameras.make_camera(np.eye(3), np.array([0.0, 0.0, 5.0]), fovx=math.radians(70),
                              fovy=math.radians(46), width=1920, height=1080, device="cpu")
    calls = []
    original = rasterize_tiled.composite_tiles

    def recording(st, sp_attr, tile_ids, starts, ends):  # records, composites nothing
        calls.append((st, sp_attr.detach(), tile_ids, starts, ends))
        m, p = tile_ids.shape[0], st.tile_w * st.tile_h
        return (torch.zeros(m, p, 3), torch.ones(m, p), torch.zeros(m, p, dtype=torch.int32))

    rasterize_tiled.composite_tiles = recording
    try:
        with torch.no_grad():
            render(cam, state, active_sh_degree=3, bg_color=torch.zeros(3),
                   cfg=RasterizeConfig(tile_w=tw, tile_h=th, backend="torch",
                                       pair_budget_factor=64.0))
    finally:
        rasterize_tiled.composite_tiles = original
    st, sp_attr, tile_ids, starts, ends = calls[0]
    return st, sp_attr, tile_ids, starts, ends


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("source", ["golden", "bench", "heavy"])
def test_cull_extent_holds_every_counted_pixel(source, tile):
    args = golden_inputs(*tile) if source == "golden" else scene_inputs(source, *tile)
    c = decisions_vs_extent(*args)
    assert c["counted"] > 0 and c["passes"] >= c["counted"]
    assert c["passes_outside"] == 0, c
    assert c["counted_outside"] == 0, c
    # the extent culls: many of the pairs' tile pixels lie outside it
    assert c["outside"] > 0.2 * c["evaluated"], c


def test_pair_extent_edge_values():
    inf = math.inf
    rows = torch.tensor([
        [5.0, 7.0, 0.5, 0.0, 0.5, 0.0, 0.0, 0.0, 0.9],  # round: a finite box
        [5.0, 7.0, 0.5, 0.0, 0.5, 0.0, 0.0, 0.0, 1e-3],  # below 1/255: counts nowhere
        [5.0, 7.0, 0.5, 0.6, 0.5, 0.0, 0.0, 0.0, 0.9],  # indefinite conic: no cull
        [5.0, 7.0, 1.0, 0.99999, 1.0, 0.0, 0.0, 0.0, 0.9],  # skew past MAX_SKEW: no cull
        [math.nan, 7.0, 0.5, 0.0, 0.5, 0.0, 0.0, 0.0, 0.9],  # non-finite: no cull
    ])
    box = pair_extent(rows)
    half = math.sqrt((2 * math.log(255 * 0.9) + 1e-4) * (1 + 1e-4) / 0.5) + 1.0
    torch.testing.assert_close(box[0], torch.tensor([5 - half, 5 + half, 7 - half, 7 + half]))
    assert box[1].tolist() == [inf, -inf, inf, -inf]
    for i in (2, 3, 4):
        assert box[i].tolist() == [-inf, inf, -inf, inf]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("source", ["golden", "bench", "heavy"])
def test_cull_extent_holds_over_untrimmed_ranges(source, tile):
    """B3 walks each tile's whole range [start, end), past its last
    contributor: no pair x pixel there passes the forward's tests outside
    the extent either."""
    args = golden_inputs(*tile) if source == "golden" else scene_inputs(source, *tile)
    c = decisions_vs_extent(*args, trim=False)
    assert c["passes"] > 0 and c["passes_outside"] == 0, c
    assert c["outside"] > 0.2 * c["evaluated"], c


# --- the warp layout of composite_warps.cuh -----------------------------------------------

MAX_WARPS, CELLS_PER_WARP, MAX_PPT = 8, 4, 8  # kMaxWarps, kCellsPerWarp, kMaxPixelsPerThread
# tile -> (warps, (warps_x, cells_x, cells_y), pixels a thread), the header's table
LAYOUTS = {
    (16, 16): (2, (1, 2, 2), 4),
    (48, 32): (8, (2, 3, 2), 6),
    (8, 8): (1, (1, 1, 2), 2),
    (32, 16): (4, (2, 2, 2), 4),
    (20, 12): (4, (4, 1, 3), 3),
    (32, 32): (8, (2, 2, 2), 4),
    (64, 32): (8, (4, 2, 4), 8),
    (72, 28): (8, (0, 0, 0), 8),
}


FWD_CELLS_PER_WARP = 2  # kFwdCellsPerWarp: B1's first limit
# the same for B1 (choose_layout with its first limit), the header's table
FWD_LAYOUTS = {
    (16, 16): (4, (2, 1, 2), 2),
    (48, 32): (8, (2, 3, 2), 6),
    (8, 8): (1, (1, 1, 2), 2),
    (32, 16): (8, (4, 1, 2), 2),
    (20, 12): (8, (4, 1, 2), 2),
    (32, 32): (8, (2, 2, 2), 4),
    (64, 32): (8, (4, 2, 4), 8),
    (72, 28): (8, (0, 0, 0), 8),
}


def choose_layout(tile_w, tile_h, first=CELLS_PER_WARP):
    """composite_warps.cuh's ``choose_layout`` with first limit ``first``
    (B2-B4's, or FWD_CELLS_PER_WARP for B1): (warps, (warps_x, cells_x,
    cells_y), pixels a thread); warps_x 0 is the strided map."""
    cw, ch = -(-tile_w // 8), -(-tile_h // 4)
    limit = first
    while limit <= MAX_PPT:
        nw = 1
        while nw <= MAX_WARPS:
            best = None
            wx = 1
            while wx <= nw:
                ax, ay = -(-cw // wx), -(-ch // (nw // wx))
                aspect = abs(8 * ax - 4 * ay)
                if ax * ay <= limit and (best is None or (ax * ay, aspect) < best[:2]):
                    best = (ax * ay, aspect, (wx, ax, ay))
                wx *= 2
            if best is not None:
                return nw, best[2], best[0]
            nw *= 2
        limit *= 2
    return MAX_WARPS, (0, 0, 0), -(-tile_w * tile_h // (32 * MAX_WARPS))


def slot_pixels(tile_w, tile_h, first=CELLS_PER_WARP):
    """[warps, 32, ppt, 2] tile-local (x, y) of every thread's pixel slots,
    as ``slot_pixel`` maps them (``cell_origin`` plus the lane's (l % 8, l /
    8), or the strided map) in the layout of first limit ``first``; they may
    lie past the tile."""
    warps, (wx, cx, cy), ppt = choose_layout(tile_w, tile_h, first)
    w = torch.arange(warps)[:, None, None]
    lane = torch.arange(32)[None, :, None]
    k = torch.arange(ppt)[None, None, :]
    if wx == 0:
        p = w * 32 + lane + k * 32 * warps
        x, y = p % tile_w, p // tile_w
    else:
        x = ((w % wx) * cx + k % cx) * 8 + lane % 8
        y = ((w // wx) * cy + k // cx) * 4 + lane // 8
    return torch.stack(torch.broadcast_tensors(x, y), -1)


def _in_tile(xy, tile_w, tile_h):
    x, y = xy[..., 0], xy[..., 1]
    return (x < tile_w) & (y < tile_h) & (y * tile_w + x < tile_w * tile_h)


@pytest.mark.parametrize("tile", sorted(LAYOUTS))
def test_layout_mirror_matches_the_header(tile):
    """The mirror gives the header's table, and its slots hold every pixel
    of the tile exactly once."""
    import chip_smoke

    assert set(TILES) | set(chip_smoke.LAYOUT_TILES) <= set(LAYOUTS)
    assert choose_layout(*tile) == LAYOUTS[tile]
    tw, th = tile
    xy = slot_pixels(tw, th)
    inside = _in_tile(xy, tw, th)
    flat = (xy[..., 1] * tw + xy[..., 0])[inside]
    assert flat.numel() == tw * th and torch.equal(flat.sort().values, torch.arange(tw * th))


def cull_shares(st, sp_attr, tile_ids, starts, ends, first=CELLS_PER_WARP, real_only=False):
    """Over the whole ranges (B3's and B1's walk) of up to MAX_TILES tiles, in
    the layout of first limit ``first``: the share of (pair, warp rectangle)
    combinations whose extent misses the warp's rectangle, of (pair, cell)
    combinations skipped by either cull, and of the cells of the reached
    warps skipped by the cell cull; and the count of pair x pixels that pass
    the forward's tests in a skipped cell. ``real_only`` counts only the
    splats' pairs, not the null rows that pad each range to whole chunks
    (which every warp skips)."""
    warps, (wx, _, _), ppt = choose_layout(st.tile_w, st.tile_h, first)
    assert wx > 0, "the cell cull needs a cell layout"
    tile_ids, starts, ends = _sample_tiles(tile_ids, starts, ends)
    xy = slot_pixels(st.tile_w, st.tile_h, first)  # [warps, 32, ppt, 2]
    inside = _in_tile(xy, st.tile_w, st.tile_h)
    big = 1 << 20
    # each warp's rectangle over its pixels in the tile, tile-local
    wx0 = torch.where(inside, xy[..., 0], big).amin((1, 2))
    wx1 = torch.where(inside, xy[..., 0], -big).amax((1, 2))
    wy0 = torch.where(inside, xy[..., 1], big).amin((1, 2))
    wy1 = torch.where(inside, xy[..., 1], -big).amax((1, 2))
    cell_x, cell_y = xy[:, 0, :, 0], xy[:, 0, :, 1]  # lane 0: each cell's origin [warps, ppt]
    m_of, pos = _tile_pairs(starts, ends)
    if real_only:
        keep = sp_attr[pos, 8] > 0  # the null row has opacity 0
        m_of, pos = m_of[keep], pos[keep]
    box = pair_extent(sp_attr)[pos].double()  # [n, 4]
    tid = tile_ids.long()[m_of]
    ox = ((tid % st.tiles_x) * st.tile_w).double()[:, None]
    oy = ((tid // st.tiles_x) * st.tile_h).double()[:, None]
    bx0, bx1, by0, by1 = (box[:, i:i + 1] for i in range(4))
    warp_hit = ((wx0 <= wx1) & (bx1 >= ox + wx0) & (bx0 <= ox + wx1)
                & (by1 >= oy + wy0) & (by0 <= oy + wy1))  # [n, warps]
    cx, cy = ox[:, :, None] + cell_x, oy[:, :, None] + cell_y  # [n, warps, ppt]
    cell_hit = (warp_hit[:, :, None] & (bx1[:, :, None] >= cx) & (bx0[:, :, None] <= cx + 7)
                & (by1[:, :, None] >= cy) & (by0[:, :, None] <= cy + 3))
    reached_cells = warp_hit[:, :, None].expand_as(cell_hit)
    # pair x pixels that pass the forward's tests in a cell the culls skip
    px, py = rasterize_cuda._tile_pixel_coords(tile_ids[m_of], st)  # [n, P]
    _, _, power, _, _, alpha = rasterize_cuda._chunk_alpha(sp_attr[pos][:, None, :],
                                                           px[:, None, :], py[:, None, :])
    passes = ((power <= 0.0) & (alpha >= ALPHA_SKIP))[:, 0]  # [n, P]
    flat = (xy[..., 1] * st.tile_w + xy[..., 0]).clamp(max=st.tile_w * st.tile_h - 1)
    slot_passes = passes[:, flat] & inside  # [n, warps, 32, ppt]
    missed = int((slot_passes & ~cell_hit[:, :, None, :]).sum())
    return dict(warp_skipped=float((~warp_hit).double().mean()),
                cell_skipped=float((~cell_hit).double().mean()),
                cell_skipped_in_reached_warps=float(
                    (~cell_hit[reached_cells]).double().mean()),
                passes_in_skipped_cells=missed, pairs=int(pos.numel()))


def test_cull_shares_on_the_heavy_draw():
    """The warp and cell culls skip a positive share of their combinations
    on the heavy draw at 48x32 (PERF.md quotes them), and no pixel that
    passes the forward's tests lies in a skipped cell."""
    shares = cull_shares(*scene_inputs("heavy", 48, 32))
    print("cull shares, heavy draw at 48x32:", shares)
    assert shares["passes_in_skipped_cells"] == 0, shares
    assert 0 < shares["warp_skipped"] <= shares["cell_skipped"] < 1, shares
    assert shares["cell_skipped_in_reached_warps"] > 0, shares


@pytest.mark.parametrize("tile", sorted(FWD_LAYOUTS))
def test_fwd_layout_mirror_matches_the_header(tile):
    """B1's layout rule (choose_layout with kFwdCellsPerWarp as its first
    limit) gives the header's table, and its slots hold every pixel of the
    tile exactly once."""
    import chip_smoke

    assert set(TILES) | set(chip_smoke.LAYOUT_TILES) <= set(FWD_LAYOUTS)
    assert choose_layout(*tile, FWD_CELLS_PER_WARP) == FWD_LAYOUTS[tile]
    tw, th = tile
    xy = slot_pixels(tw, th, FWD_CELLS_PER_WARP)
    flat = (xy[..., 1] * tw + xy[..., 0])[_in_tile(xy, tw, th)]
    assert flat.numel() == tw * th and torch.equal(flat.sort().values, torch.arange(tw * th))


@pytest.mark.parametrize("tile", TILES)
def test_cull_shares_on_the_bench_draw(tile):
    """The CPU predictor of B1's cull on bench.py's draw in B1's layout
    (PERF.md quotes the shares): over the splats' pairs, the share of (pair,
    warp) combinations whose extent misses the warp's rectangle and of
    (pair, cell) ones; no pixel that passes the forward's tests lies in a
    skipped cell. The draw's splats all have the clipped log-scale -3.5 and
    span 40-90 pixels at this camera, so little is skipped at 16x16."""
    args = scene_inputs("bench", *tile, n=4096)
    shares = cull_shares(*args, first=FWD_CELLS_PER_WARP, real_only=True)
    print(f"cull shares, bench draw at {tile[0]}x{tile[1]} in B1's layout:", shares)
    assert shares["passes_in_skipped_cells"] == 0, shares
    assert 0 < shares["warp_skipped"] <= shares["cell_skipped"] < 1, shares
