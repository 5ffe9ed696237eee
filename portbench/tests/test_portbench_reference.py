"""The reference against the port's plain path (the CPU's compositing) at a
small size: a sound run of each cell comes out correct, with room under
every limit."""

import torch

from portbench import common
from portbench.reference import splat
from portbench.traffic import fit, viewer
from portbench.tests.small import SEED, small_cell

CPU = torch.device("cpu")


def test_fit_cell_agrees_with_the_reference():
    cell = small_cell("mipnerf360-train")
    out = fit.run(cell, SEED, 1.0, False, CPU, 0.0)
    for name, value, limit in out.checks:
        assert value <= limit, (name, value, limit)
    # both stretches were compared: the first steps and those after the window
    names = {name for name, _, _ in out.checks}
    assert {"loss_gap", "window_loss_gap", "window_change_gap"} <= names
    first, last = (ph.watch for ph in out.notes["phases"])
    assert last.iterations[0] == cell.traffic["resume_iteration"] + out.attempted + \
        cell.traffic["warmup_steps"]
    result, correct = common.result_line(out, cell, False, {"kind": "cpu"})
    assert correct and list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"step_ms", "setup_s"}
    assert out.attempted >= 1


def test_viewer_cell_agrees_with_the_reference():
    cell = small_cell("tandt-view")
    out = viewer.run(cell, SEED, 1.0, False, CPU, 0.0)
    checks = {name: (value, limit) for name, value, limit in out.checks}
    assert checks["byte_gap"][0] <= 1.0
    assert checks["bytes_off_share"][0] <= checks["bytes_off_share"][1]
    result, correct = common.result_line(out, cell, False, {"kind": "cpu"})
    assert correct and set(result["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}


def test_reference_render_matches_the_port_image():
    """One view: the reference's image and the port's eval render agree."""
    from gs_tpu_torch import cameras
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.models.gaussians import GaussianState
    from gs_tpu_torch.training import eval_render

    from portbench import scenes

    cfg = small_cell("tandt-view").config
    p = scenes.gaussians(cfg, SEED, CPU)
    r, t = scenes.views(cfg, SEED)[3]
    fx, fy = scenes.fov(cfg)
    state = GaussianState(xyz=p["xyz"], features_dc=p["f_dc"], features_rest=p["f_rest"],
                          log_scale=p["scaling"], quat=p["rotation"],
                          logit_opacity=p["opacity"], alive=p["alive"])
    cam = cameras.make_camera(r, t, fx, fy, cfg["width"], cfg["height"], device="cpu")
    got = eval_render(state, cam, torch.zeros(3), active_sh_degree=3,
                      raster_cfg=RasterizeConfig())
    ref = splat.render(p, p["alive"],
                       splat.camera(r, t, fx, fy, cfg["width"], cfg["height"], CPU), 3,
                       torch.zeros(3))
    gap = (got - ref.clamp(0, 1)).abs()
    # a splat whose alpha sits on the 1/255 skip threshold may fall either
    # side of it in the two orders of rounding: at most 1/255 of a colour
    assert float(gap.max()) < 1.0 / 255.0 and float(gap.mean()) < 1e-6
    assert float(ref.std()) > 0.01  # the view is not empty
