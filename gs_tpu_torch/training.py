"""Training: the optimization step and the outer loop (port of ``gs_tpu/training.py``).

One ``train_step`` renders, takes the photometric loss, differentiates it
with ``torch.autograd.grad`` over the six parameter groups and the
screen-space offset, steps Adam and accumulates the densify statistics.
The compositing forward and backward run the hand-written kernels on the
card (``RasterizeConfig.backend="auto"``). ``run_training`` keeps the
reference's schedule (``train.py:31-146``):

  - loss = 0.8 L1 + 0.2 (1 - SSIM)                       (:103-104)
  - xyz lr log-lerp schedule per step                     (:80)
  - SH degree +1 every 1000 iterations up to the max      (:82-83)
  - densify every 100 iterations in [500, 15000], grad threshold 2e-4,
    min opacity 0.005, size pruning only after the first opacity reset
                                                          (:125-133)
  - opacity reset every 3000 iterations (+ at densify start on white bg)
                                                          (:135-136)

Cameras are drawn with Python's ``random`` seeded as gs_tpu seeds it, so
both packages visit the same camera order. Split noise and random
backgrounds come from a ``torch.Generator`` seeded with ``seed`` (gs_tpu
draws them from ``jax.random``, so those draws differ). Checkpoints,
autotuning, the viewer and profiler hooks are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import random
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from gs_tpu_torch.cameras import Camera
from gs_tpu_torch.config import OptimizationParams, PipelineParams, RasterizeConfig
from gs_tpu_torch.models import densify, gaussians, optim
from gs_tpu_torch.models.gaussians import GaussianState
from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget
from gs_tpu_torch.renderer import render
from gs_tpu_torch.utils import losses, metrics, schedules

GROW_WATERMARK = 0.9  # grow capacity when alive exceeds this fraction
GROW_FACTOR = 2.0
MIN_OPACITY = 0.005  # train.py:133


@dataclass
class TrainState:
    """Everything that evolves during training."""

    state: GaussianState
    adam: optim.AdamState
    stats: densify.DensifyStats
    iteration: int = 0
    spatial_lr_scale: float = 1.0
    max_sh_degree: int = 0

    @property
    def active_sh_degree(self) -> int:
        # oneupSHdegree schedule (train.py:82-83)
        return min(self.iteration // 1000, self.max_sh_degree)


def init_train_state(state: GaussianState, spatial_lr_scale: float,
                     max_sh_degree: int) -> TrainState:
    return TrainState(
        state=state,
        adam=optim.init(state.params()),
        stats=densify.DensifyStats.zeros(state.capacity, state.device),
        spatial_lr_scale=spatial_lr_scale,
        max_sh_degree=max_sh_degree,
    )


def train_step(
    state: GaussianState,
    adam: optim.AdamState,
    stats: densify.DensifyStats,
    camera: Camera,
    bg,
    iteration: int,
    spatial_lr_scale: float,
    *,
    active_sh_degree: int,
    opt_cfg: OptimizationParams,
    raster_cfg: RasterizeConfig,
    accumulate_stats: bool,
    pipe: PipelineParams = PipelineParams(),
    apply_update: bool = True,
):
    """One optimization step. Returns (state, adam, stats, metrics).

    ``iteration`` is the 0-based step the xyz lr schedule reads.
    ``apply_update=False`` computes loss, gradients and stats but skips the
    Adam step: the reference's final iteration (``train.py:139-141``).
    """
    params = {k: v.detach().requires_grad_() for k, v in state.params().items()}
    offset = torch.zeros((state.capacity, 2), dtype=torch.float32, device=state.device,
                         requires_grad=True)
    with torch.enable_grad():
        out = render(camera, state.with_params(params), active_sh_degree=active_sh_degree,
                     bg_color=bg, means2d_offset=offset,
                     convert_shs_python=pipe.convert_SHs_python,
                     compute_cov3d_python=pipe.compute_cov3D_python, cfg=raster_cfg)
        loss = losses.photometric_loss(out.image, camera.image, opt_cfg.lambda_dssim)
        # groups the step does not reach (f_rest below SH degree 1) get zeros
        grads = torch.autograd.grad(loss, [*params.values(), offset], allow_unused=True,
                                    materialize_grads=True)
    g_params = dict(zip(params, grads[:-1]))

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
    if accumulate_stats:
        stats = densify.add_stats(stats, grads[-1], out.radii, out.visibility, camera.width,
                                  camera.height)
    step_metrics = {"loss": loss.detach(), "n_visible": out.visibility.sum(),
                    "xyz_lr": xyz_lr, "num_pairs": out.num_pairs}
    return state, adam, stats, step_metrics


@torch.no_grad()
def eval_render(state: GaussianState, camera: Camera, bg, *, active_sh_degree: int,
                raster_cfg: RasterizeConfig,
                pipe: PipelineParams = PipelineParams()) -> torch.Tensor:
    """Render one view for evaluation: the [3,H,W] image clamped to [0, 1]."""
    out = render(camera, state, active_sh_degree=active_sh_degree, bg_color=bg,
                 convert_shs_python=pipe.convert_SHs_python,
                 compute_cov3d_python=pipe.compute_cov3D_python,
                 cfg=raster_cfg)
    return torch.clamp(out.image, 0.0, 1.0)


def debug_dump(path: str, ts: TrainState, camera: Camera, loss: float) -> str:
    """Write the rasterizer inputs of a failing step (``pipe.debug``), as the
    reference snapshots its rasterizer's inputs under ``--debug``."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"snapshot_debug_iter{ts.iteration}.npz")
    payload = {f"param_{k}": v.detach().cpu().numpy() for k, v in ts.state.params().items()}
    payload.update(
        alive=ts.state.alive.cpu().numpy(),
        cam_view=camera.view.cpu().numpy(),
        cam_full_proj=camera.full_proj.cpu().numpy(),
        cam_pos=camera.cam_pos.cpu().numpy(),
        tan_fovx=camera.tan_fovx.cpu().numpy(),
        tan_fovy=camera.tan_fovy.cpu().numpy(),
        width=np.int32(camera.width),
        height=np.int32(camera.height),
        iteration=np.int32(ts.iteration),
        loss=np.float32(loss),
    )
    np.savez_compressed(out, **payload)
    return out


def maybe_grow(ts: TrainState) -> TrainState:
    """Double the capacity once the alive slots pass the watermark."""
    if int(ts.state.num_alive) <= GROW_WATERMARK * ts.state.capacity:
        return ts
    new_cap = gaussians.round_capacity(int(ts.state.capacity * GROW_FACTOR))
    pad = new_cap - ts.state.capacity
    ts.state = gaussians.grow_capacity(ts.state, new_cap)
    ts.adam = optim.grow(ts.adam, new_cap)
    ts.stats = densify.DensifyStats(*(torch.cat([s, s.new_zeros(pad)]) for s in ts.stats))
    return ts


def densify_step(ts: TrainState, generator: torch.Generator, opt_cfg: OptimizationParams,
                 use_size_prune: bool):
    """One densify round with split noise drawn from ``generator``."""
    noise = densify.split_noise(generator, ts.state.capacity, ts.state.device)
    return densify.densify_and_prune(
        ts.state, ts.adam, ts.stats, noise,
        max_grad=opt_cfg.densify_grad_threshold,
        min_opacity=MIN_OPACITY,
        extent=ts.spatial_lr_scale,
        percent_dense=opt_cfg.percent_dense,
        use_size_prune=use_size_prune,
    )


def evaluate_and_report(scene, ts: TrainState, bg, raster_cfg: RasterizeConfig,
                        iteration: int, pipe: PipelineParams = PipelineParams()) -> dict:
    """In-training evaluation (``training_report``, train.py:173-260): mean
    L1 and PSNR over the test cameras and five training cameras. Prints them
    and returns {name: (l1, psnr)}."""
    train_cams = scene.get_train_cameras()
    configs = [
        ("test", scene.get_test_cameras()),
        ("train", [train_cams[idx % len(train_cams)] for idx in range(5, 30, 5)]),
    ]
    report = {}
    for name, cams in configs:
        if not cams:
            continue
        l1s, psnrs = [], []
        for cam in cams:
            img = eval_render(ts.state, cam, bg, active_sh_degree=ts.active_sh_degree,
                              raster_cfg=raster_cfg, pipe=pipe)
            gt = torch.clamp(cam.image, 0.0, 1.0)
            l1s.append(float(losses.l1_loss(img, gt)))
            psnrs.append(float(metrics.psnr(img, gt)[0, 0]))
        report[name] = (float(np.mean(l1s)), float(np.mean(psnrs)))
        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {report[name][0]:.5f} "
              f"PSNR {report[name][1]:.2f}")
    return report


def run_training(
    scene,
    opt_cfg: OptimizationParams,
    pipe: PipelineParams,
    raster_cfg: RasterizeConfig | None = None,
    white_background: bool = False,
    test_iterations: tuple[int, ...] = (7000, 30000),
    save_iterations: tuple[int, ...] = (7000, 30000),
    log_every: int = 10,
    progress: Callable[[int, dict], None] | None = None,
    seed: int = 0,
    debug_from: int = -1,
) -> TrainState:
    """The optimization loop (``training``, train.py:31-146).

    ``scene`` provides ``gaussians`` (a GaussianState, whose device the run
    uses), ``cameras_extent``, ``model_path``, ``get_train_cameras()``,
    ``get_test_cameras()`` (cameras with images) and ``save(iteration,
    state)``. ``progress(iteration, metrics)`` is called every
    ``log_every`` iterations with floats.
    """
    if raster_cfg is None:
        raster_cfg = RasterizeConfig()
    random.seed(seed)
    ts = init_train_state(scene.gaussians, scene.cameras_extent,
                          scene.gaussians.max_sh_degree)
    dev = ts.state.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    bg_fixed = torch.tensor([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
                            dtype=torch.float32, device=dev)

    viewpoint_stack: list = []
    ema_loss: float | None = None
    for iteration in range(1, opt_cfg.iterations + 1):
        ts.iteration = iteration
        if debug_from >= 0 and iteration == debug_from and not pipe.debug:
            pipe = dataclasses.replace(pipe, debug=True)  # train.py:91-92
        if not viewpoint_stack:
            viewpoint_stack = list(scene.get_train_cameras())
        cam = viewpoint_stack.pop(random.randint(0, len(viewpoint_stack) - 1))
        if opt_cfg.random_background:
            bg = torch.rand(3, generator=generator, device=dev)
        else:
            bg = bg_fixed

        in_densify_phase = iteration < opt_cfg.densify_until_iter
        ts.state, ts.adam, ts.stats, m = train_step(
            ts.state, ts.adam, ts.stats, cam, bg, iteration - 1, ts.spatial_lr_scale,
            active_sh_degree=ts.active_sh_degree,
            opt_cfg=opt_cfg,
            raster_cfg=raster_cfg,
            accumulate_stats=in_densify_phase,
            pipe=pipe,
            # the reference skips the optimizer step at the final iteration
            apply_update=iteration < opt_cfg.iterations,
        )

        # read the device only at log / report points
        if iteration % log_every == 0 or iteration == opt_cfg.iterations \
                or iteration in test_iterations:
            # pair-budget overflow drops the deepest splats: grow the budget
            budget = current_pair_budget(raster_cfg, ts.state.capacity)
            if int(m["num_pairs"]) > budget:
                raster_cfg = dataclasses.replace(
                    raster_cfg, pair_budget_factor=raster_cfg.pair_budget_factor * 1.5)
                print(f"[iter {iteration}] pair budget overflow ({int(m['num_pairs'])} > "
                      f"{budget}); factor -> {raster_cfg.pair_budget_factor:.1f}")
            loss = float(m["loss"])
            if pipe.debug and not np.isfinite(loss):
                out = debug_dump(scene.model_path or ".", ts, cam, loss)
                raise RuntimeError(f"[iter {iteration}] non-finite loss {loss}; rasterizer "
                                   f"inputs dumped to {out} (pipe.debug snapshot)")
            ema_loss = loss if ema_loss is None else 0.4 * loss + 0.6 * ema_loss
        if progress is not None and iteration % log_every == 0:
            progress(iteration, {"ema_loss": ema_loss, **{k: float(v) for k, v in m.items()}})

        # --- densification schedule (train.py:125-136) ---------------------
        if in_densify_phase:
            if (iteration > opt_cfg.densify_from_iter
                    and iteration % opt_cfg.densification_interval == 0):
                ts = maybe_grow(ts)
                use_size_prune = iteration > opt_cfg.opacity_reset_interval
                ts.state, ts.adam, ts.stats, rep = densify_step(ts, generator, opt_cfg,
                                                                use_size_prune)
                if int(rep.n_dropped) > 0:
                    print(f"[iter {iteration}] capacity overflow: dropped "
                          f"{int(rep.n_dropped)} children; growing next round")
            if iteration % opt_cfg.opacity_reset_interval == 0 or (
                    white_background and iteration == opt_cfg.densify_from_iter):
                ts.state, ts.adam = densify.reset_opacity(ts.state, ts.adam)

        if iteration in test_iterations:
            evaluate_and_report(scene, ts, bg_fixed, raster_cfg, iteration, pipe=pipe)
        if iteration in save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(iteration, ts.state)
    return ts
