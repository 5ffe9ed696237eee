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


def decisions_vs_extent(st, sp_attr, tile_ids, starts, ends):
    """Counts over every pair x pixel of its tile, on up to MAX_TILES of the
    non-empty tiles: (passes the forward's tests, counted by the backward, of
    those outside the extent, counted outside the extent, all pixels outside
    the extent, all pixels)."""
    busy = torch.nonzero(ends > starts).flatten()
    keep = busy[::max(1, -(-busy.numel() // MAX_TILES))]
    tile_ids, starts, ends = tile_ids[keep], starts[keep], ends[keep]
    _, _, ncon = rasterize_cuda.composite_fwd_torch(st, sp_attr, tile_ids, starts, ends)
    trimmed = rasterize_tiled.ncon_trimmed_ends(st, starts, ends, ncon)
    m_of, pos = _tile_pairs(starts, trimmed)
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
