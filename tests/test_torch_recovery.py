"""gs_tpu_torch trains a scene from scratch on the CPU.

- The recovery smoke at tests/test_e2e_quality.py's size and bar: 48 px,
  150 iterations, 8 views, 512 ground-truth Gaussians, 256 initial points;
  test-view PSNR above 20 dB (gs_tpu reaches ~26.8 dB there).
- ``run_training`` with an early, dense schedule, so that densify, prune,
  opacity reset and capacity growth all run inside a few dozen iterations.
- ``run_training(debug_from=...)`` snapshots the step's inputs and raises
  once the loss turns non-finite.
- ``python -m gs_tpu_torch.synthetic`` at a tiny size.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gs_tpu_torch import synthetic, training
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.models import gaussians

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_recovery_smoke():
    info = {}
    psnr, state = synthetic.recover(iters=150, res=48, gt_gaussians=512, init_points=256,
                                    views=8, device="cpu", verbose=False, info=info)
    assert psnr > 20.0, f"recovery smoke PSNR {psnr:.2f} dB"
    assert len(info["psnrs"]) == 1 and info["alive"] == int(state.num_alive) == 256


def test_run_training_densifies_prunes_and_grows():
    torch.manual_seed(0)
    gt = synthetic.make_gt_scene(256, device="cpu")
    rng = np.random.default_rng(1)
    cams = []
    for i in range(6):
        cam = synthetic.orbit_camera(i, rng.uniform(-0.5, 0.5), 3.5, 32, device="cpu")
        img = training.eval_render(gt, cam, torch.zeros(3), active_sh_degree=0,
                                   raster_cfg=RasterizeConfig())
        cams.append(dataclasses.replace(cam, image=img))
    pts = gt.xyz.numpy()[:120] + rng.normal(0, 0.03, (120, 3)).astype(np.float32)
    model = gaussians.create_from_pcd(pts, rng.uniform(0.2, 0.8, (120, 3)).astype(np.float32),
                                      max_sh_degree=0, capacity=128, device="cpu")
    opt = OptimizationParams(iterations=60, densify_from_iter=5, densification_interval=10,
                             densify_until_iter=55, opacity_reset_interval=30,
                             densify_grad_threshold=1e-5, position_lr_max_steps=60)
    losses = []
    ts = training.run_training(
        synthetic.SyntheticScene(model, cams[1:], cams[:1]), opt, PipelineParams(),
        test_iterations=(60,), save_iterations=(), log_every=1,
        progress=lambda it, m: losses.append(m["loss"]))
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert ts.state.capacity > 128  # densify filled the slots, and maybe_grow doubled them
    assert int(ts.state.num_alive) > 120
    assert ts.adam.mu["xyz"].shape[0] == ts.stats.denom.shape[0] == ts.state.capacity
    # the reset at iteration 30 clamped every opacity to 0.01; training then
    # raised some again
    assert float(ts.state.opacity[ts.state.alive].max()) > 0.01


def test_debug_from_dumps_snapshot_on_non_finite_loss(tmp_path):
    rng = np.random.default_rng(2)
    cam = synthetic.orbit_camera(0.3, 0.2, 3.5, 16, device="cpu")
    cam = dataclasses.replace(cam, image=torch.full((3, 16, 16), float("nan")))
    model = gaussians.create_from_pcd(rng.normal(0, 0.3, (32, 3)).astype(np.float32),
                                      rng.uniform(0.2, 0.8, (32, 3)).astype(np.float32),
                                      max_sh_degree=0, capacity=32, device="cpu")
    scene = synthetic.SyntheticScene(model, [cam], [])
    scene.model_path = str(tmp_path)
    opt = OptimizationParams(iterations=3, densify_until_iter=0, position_lr_max_steps=3)
    with pytest.raises(RuntimeError, match=r"\[iter 2\] non-finite loss"):
        training.run_training(scene, opt, PipelineParams(), test_iterations=(),
                              save_iterations=(), log_every=1, debug_from=2)
    data = np.load(tmp_path / "snapshot_debug_iter2.npz")
    assert {"param_xyz", "alive", "cam_view", "cam_full_proj", "width", "height",
            "loss"} <= set(data.files)
    assert data["iteration"] == 2 and np.isnan(data["loss"])
    assert data["param_xyz"].shape == (32, 3) and data["cam_view"].shape == (4, 4)
    assert int(data["width"]) == int(data["height"]) == 16


def test_synthetic_module_runs():
    proc = subprocess.run(
        [sys.executable, "-m", "gs_tpu_torch.synthetic", "--iters", "20", "--res", "24",
         "--views", "8", "--gt_gaussians", "128", "--init_points", "64", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    m = re.search(r"test PSNR: mean ([0-9.]+)", proc.stdout)
    assert m and float(m.group(1)) > 5.0, proc.stdout[-2000:]
