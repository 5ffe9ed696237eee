"""End-to-end quality check: recover a synthetic scene from scratch.

Port of ``benchmarks/synthetic_e2e.py``. Ground-truth renders of a random
Gaussian cloud from orbiting cameras stand in for a dataset; a fresh model
(a noisy subsample of the GT positions, the full densify / prune /
opacity-reset schedule) is trained against them with ``run_training``,
and the mean test-view PSNR says how well it recovered the scene. The
scene, cameras and initial points are drawn from the same numpy seeds as
gs_tpu's, so both packages train on the same data.

    python -m gs_tpu_torch.synthetic [--iters 2000] [--res 256] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from gs_tpu_torch import cameras
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.models import gaussians
from gs_tpu_torch.training import eval_render, run_training
from gs_tpu_torch.utils import metrics


def orbit_camera(theta: float, phi: float, radius: float, res: int, *, device="cuda"):
    """Camera on a sphere looking at the origin (COLMAP convention)."""
    eye = radius * np.array([math.cos(phi) * math.sin(theta), math.sin(phi),
                             math.cos(phi) * math.cos(theta)])
    fwd = -eye / np.linalg.norm(eye)  # camera +z looks at the origin
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot_w2c = np.stack([right, down, fwd])  # rows: world->cam; R is cam->world
    fov = math.radians(50)
    return cameras.make_camera(rot_w2c.T, -rot_w2c @ eye, fov, fov, res, res, device=device)


def make_gt_scene(n: int, seed: int = 0, *, device="cuda") -> gaussians.GaussianState:
    """A colorful cloud of anisotropic Gaussians inside the unit ball."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts *= 0.8 / np.abs(pts).max()
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    state = gaussians.create_from_pcd(pts, cols, max_sh_degree=0, capacity=n, device=device)

    def draw(*args, size):
        return torch.from_numpy(rng.uniform(*args, size=size).astype(np.float32)).to(state.device)

    log_scale = draw(-3.8, -2.6, size=(n, 3))
    logit_opacity = draw(0.5, 3.0, size=(n, 1))
    quat = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)).to(state.device)
    return state.replace(log_scale=log_scale, logit_opacity=logit_opacity, quat=quat)


class SyntheticScene:
    """The scene interface ``run_training`` reads, over in-memory cameras."""

    cameras_extent = 1.6
    model_path = ""

    def __init__(self, model, train_cams, test_cams):
        self.gaussians = model
        self._train, self._test = train_cams, test_cams

    def get_train_cameras(self):
        return self._train

    def get_test_cameras(self):
        return self._test

    def save(self, iteration, state=None):
        pass


def recover(iters=2000, res=256, gt_gaussians=4096, init_points=2048, views=64,
            device="cuda", verbose=True, info: dict | None = None):
    """Train a fresh model against GT renders; return (mean test PSNR, state).

    ``info``, if given, receives the training wall seconds (``train_s``,
    ending in a device sync), the alive count and the per-view PSNRs.
    """
    raster_cfg = RasterizeConfig()
    gt_state = make_gt_scene(gt_gaussians, device=device)
    dev = gt_state.device
    bg = torch.zeros(3, device=dev)

    # GT renders from orbiting cameras; every 8th is a test view (the
    # reference's llffhold split, dataset_readers.py:191)
    rng = np.random.default_rng(1)
    cams = []
    for i in range(views):
        theta = 2 * math.pi * i / views + rng.uniform(0, 0.05)
        phi = rng.uniform(-0.9, 0.9)
        cams.append(orbit_camera(theta, phi, 3.5, res, device=dev))
    if verbose:
        print(f"rendering {views} GT views at {res}^2 ...", flush=True)
    gt_cams = [dataclasses.replace(c, image=eval_render(gt_state, c, bg, active_sh_degree=0,
                                                        raster_cfg=raster_cfg))
               for c in cams]
    train_cams = [c for i, c in enumerate(gt_cams) if i % 8 != 0]
    test_cams = [c for i, c in enumerate(gt_cams) if i % 8 == 0]

    # fresh model from a noisy subsample of GT positions (SfM-like init)
    idx = rng.choice(gt_gaussians, init_points, replace=False)
    pts = gt_state.xyz.cpu().numpy()[idx] + rng.normal(
        scale=0.03, size=(init_points, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, size=(init_points, 3)).astype(np.float32)
    model = gaussians.create_from_pcd(pts, cols, max_sh_degree=0, device=dev)

    opt = OptimizationParams(
        iterations=iters,
        densify_from_iter=200,
        densification_interval=100,
        densify_until_iter=int(iters * 0.7),
        opacity_reset_interval=1200,
        position_lr_max_steps=iters,
    )

    def progress(it, m):
        if verbose and it % 200 == 0:
            print(f"[{it:5d}] loss {m['ema_loss']:.4f}", flush=True)

    t0 = time.perf_counter()
    ts = run_training(SyntheticScene(model, train_cams, test_cams), opt, PipelineParams(),
                      raster_cfg=raster_cfg, test_iterations=(), save_iterations=(),
                      progress=progress)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    psnrs = [float(metrics.psnr(eval_render(ts.state, c, bg, active_sh_degree=0,
                                            raster_cfg=raster_cfg), c.image)[0, 0])
             for c in test_cams]
    alive = int(ts.state.num_alive)
    if verbose:
        print(f"\nsynthetic e2e: {iters} iters in {train_s:.0f}s "
              f"({iters / train_s:.1f} it/s), alive {alive} gaussians\n"
              f"test PSNR: mean {np.mean(psnrs):.2f} dB  min {np.min(psnrs):.2f}  "
              f"max {np.max(psnrs):.2f}")
    if info is not None:
        info.update(train_s=train_s, alive=alive, psnrs=psnrs)
    return float(np.mean(psnrs)), ts.state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--gt_gaussians", type=int, default=4096)
    ap.add_argument("--init_points", type=int, default=2048)
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()
    psnr, _ = recover(iters=args.iters, res=args.res, gt_gaussians=args.gt_gaussians,
                      init_points=args.init_points, views=args.views, device=args.device)
    return psnr


if __name__ == "__main__":
    main()
