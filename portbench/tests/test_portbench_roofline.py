"""The frozen roofline count: the same from the inputs whichever kernel
form ran, and equal to a count by hand."""

import torch

from gs_tpu_torch.ops import rasterize_tiled
from gs_tpu_torch.ops.rasterize_cuda import composite_fwd_torch
from gs_tpu_torch.ops.rasterize_tiled import CompositeStatic

from portbench import roofline, scenes
from portbench.tests.small import SEED, small_cell


def captured_bounds(monkeypatch, mode):
    """fwd and bwd bounds of one CPU step's compositing calls, with the
    program's kernel form forced to ``mode``."""
    from gs_tpu_torch import cameras
    from gs_tpu_torch.models.gaussians import GaussianState
    from gs_tpu_torch.renderer import render
    from gs_tpu_torch.config import RasterizeConfig

    monkeypatch.setattr(rasterize_tiled, "KERNEL_MODE", mode)
    calls = {}
    for name, key in (("composite_fwd_cuda", "fwd"), ("composite_fwd_tile_cuda", "fwd"),
                      ("composite_bwd_cuda", "bwd"), ("composite_bwd_tile_cuda", "bwd")):
        real = getattr(rasterize_tiled, name)

        def keep(*args, _real=real, _key=key, _name=name):
            out = _real(*args)
            calls[_key] = (_name, args, out)
            return out

        monkeypatch.setattr(rasterize_tiled, name, keep)
    cfg = small_cell("tandt-view").config
    p = scenes.gaussians(cfg, SEED, "cpu")
    leaves = {k: p[k].clone().requires_grad_() for k in ("xyz", "f_dc", "f_rest", "scaling",
                                                         "rotation", "opacity")}
    state = GaussianState(xyz=leaves["xyz"], features_dc=leaves["f_dc"],
                          features_rest=leaves["f_rest"], log_scale=leaves["scaling"],
                          quat=leaves["rotation"], logit_opacity=leaves["opacity"],
                          alive=p["alive"])
    r, t = scenes.views(cfg, SEED)[2]
    fx, fy = scenes.fov(cfg)
    cam = cameras.make_camera(r, t, fx, fy, cfg["width"], cfg["height"], device="cpu")
    out = render(cam, state, active_sh_degree=3, bg_color=torch.zeros(3), cfg=RasterizeConfig())
    out.image.square().sum().backward()
    fname, (st, attr, ids, starts, ends), (_, _, ncon) = calls["fwd"]
    bname, (bst, battr, bids, bstarts, bends, t_final, bncon, _, _), _ = calls["bwd"]
    return (fname, bname, roofline.fwd_bound(st, attr, ids, starts, ends, ncon),
            roofline.bwd_bound(bst, battr, bids, bstarts, bends, t_final, bncon))


def test_bound_is_the_same_for_both_kernel_forms(monkeypatch):
    chunk = captured_bounds(monkeypatch, "chunk")
    tile = captured_bounds(monkeypatch, "tile")
    assert chunk[:2] == ("composite_fwd_cuda", "composite_bwd_cuda")
    assert tile[:2] == ("composite_fwd_tile_cuda", "composite_bwd_tile_cuda")
    for a, b in ((chunk[2], tile[2]), (chunk[3], tile[3])):
        for key in ("evals", "past_cull", "contributions", "fp32_ops", "pairs"):
            assert a[key] == b[key] > 0, key


def test_bound_matches_a_count_by_hand():
    """Two 16x16 tiles: tile 0 walks five wide splats of alpha 0.95 (each
    pixel stops at the fourth: T 1, 0.05, 0.0025, 1.25e-4, then below
    1e-4), tile 1 two of alpha 0.5 (no stop)."""
    st = CompositeStatic(tiles_x=2, tiles_y=1, tile_w=16, tile_h=16, chunk=64, tile_batch=8,
                         backend="torch")
    attr = torch.zeros(128, 9)
    attr[:, 2] = attr[:, 4] = 1e-9  # a conic this flat: exp(power) = 1 over the tile
    attr[:, 0], attr[:, 1] = 8.0, 8.0
    attr[:5, 8] = 0.95
    attr[64:66, 0] = 24.0
    attr[64:66, 8] = 0.5
    attr[:, 5:8] = 0.5
    ids = torch.tensor([0, 1], dtype=torch.int32)
    starts = torch.tensor([0, 64], dtype=torch.int32)
    ends = torch.tensor([5, 66], dtype=torch.int32)
    color, t_final, ncon = composite_fwd_torch(st, attr, ids, starts, ends)
    assert ncon[0].eq(3).all() and ncon[1].eq(66).all()
    fwd = roofline.fwd_bound(st, attr, ids, starts, ends, ncon)
    # tile 0: 4 evaluations a pixel, all past the cull and the skip, 3
    # contributions; tile 1: 2 of each
    assert (fwd["evals"], fwd["past_cull"], fwd["contributions"]) == (256 * 6, 256 * 6, 256 * 5)
    per = roofline.OPS_EVAL + roofline.OPS_PAST_CULL + roofline.OPS_PAST_SKIP
    assert fwd["fp32_ops"] == 256 * (6 * per + 5 * roofline.OPS_CONTRIB)
    assert fwd["pairs"] == 7
    trimmed = torch.tensor([3, 66], dtype=torch.int32)
    bwd = roofline.bwd_bound(st, attr, ids, starts, trimmed, t_final, ncon)
    per_bwd = roofline.BWD_OPS_EVAL + roofline.BWD_OPS_PAST_CULL + roofline.BWD_OPS_CONTRIB
    assert (bwd["evals"], bwd["contributions"]) == (256 * 5, 256 * 5)
    assert bwd["fp32_ops"] == 256 * 5 * per_bwd
