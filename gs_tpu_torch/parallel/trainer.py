"""Training across a (data, shard) mesh: the reference loop over the
tile-sharded step (port of ``gs_tpu/parallel/trainer.py``, layout "tile").

``training.run_training`` delegates here when a ``ParallelConfig`` spans
more than one device. Every rank of the world runs this loop alike; the
loop mirrors ``train.py:58-146`` (camera sampling, the densify / opacity
reset / save schedule, evaluation) but drives
``sharded.make_sharded_train_step``:

  - each step takes ``data_parallel`` cameras, one a data row
    (``multihost.BatchSampler`` from the shared ``random`` seed, so every
    rank draws the same batches); gradients are averaged over them like a
    batch and the densify statistics count each camera, so one loop
    iteration is one reference iteration for every schedule;
  - parameters, Adam and the densify statistics are replicated: densify and
    the opacity reset run on every rank through the single-device
    ``training.densify_step`` / ``densify.reset_opacity`` with the same
    generator draws, so the ranks stay equal;
  - the capacity stays a multiple of ``4096 * shard`` (gs_tpu's quantum);
  - a strip whose pairs pass its budget (``sharded.local_pair_budget``)
    grows the pair budget factor by 1.5, as on one device.

Only rank 0 writes PLYs and checkpoints, evaluates, and records a profiler
trace. The startup autotune runs only in a one-process world, as gs_tpu's
(its timing renders would run unsynchronized on each rank); a
multi-process fit takes its kernel paths from the environment
(``ops/switches.py``). Layout "gauss" is ROADMAP A14b.
"""

from __future__ import annotations

import dataclasses
import os
import random

import numpy as np
import torch

from gs_tpu_torch.config import (OptimizationParams, ParallelConfig, PipelineParams,
                                 RasterizeConfig)
from gs_tpu_torch.data import multihost
from gs_tpu_torch.training import (GROW_FACTOR, GROW_WATERMARK, debug_dump, densify_step,
                                   evaluate_and_report, grow_train_state, init_train_state)
from gs_tpu_torch.models import densify, gaussians
from gs_tpu_torch.ops import autotune
from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget
from gs_tpu_torch.parallel import mesh as mesh_mod
from gs_tpu_torch.parallel.sharded import local_pair_budget, make_sharded_train_step
from gs_tpu_torch.utils import ckpt, profiling


def check_layout(parallel: ParallelConfig) -> None:
    if parallel.layout == "gauss":
        raise NotImplementedError(
            "parallel layout 'gauss' (Gaussian-sharded state) is not ported yet (ROADMAP A14b); "
            "use layout 'tile'")
    if parallel.layout != "tile":
        raise ValueError(f"unknown parallel layout {parallel.layout!r}; expected 'tile' or "
                         "'gauss'")


def maybe_grow_parallel(ts, cap_quantum: int, watermark: float, factor: float):
    """The tile layout's capacity growth (gs_tpu ``_maybe_grow_parallel``):
    ``factor`` x the capacity, rounded up to ``cap_quantum``, once the alive
    slots pass ``watermark``."""
    if int(ts.state.num_alive) <= watermark * ts.state.capacity:
        return ts
    return grow_train_state(ts, -(-int(ts.state.capacity * factor) // cap_quantum) * cap_quantum)


def run_training_parallel(
    scene,
    opt_cfg: OptimizationParams,
    pipe: PipelineParams,
    parallel: ParallelConfig,
    raster_cfg: RasterizeConfig | None = None,
    white_background: bool = False,
    test_iterations: tuple[int, ...] = (7000, 30000),
    save_iterations: tuple[int, ...] = (7000, 30000),
    checkpoint_iterations: tuple[int, ...] = (),
    start_checkpoint: str | None = None,
    log_every: int = 10,
    progress=None,
    seed: int = 0,
    gui_server=None,
    profile_dir: str | None = None,
    profile_iters: tuple[int, int] = (50, 60),
    debug_from: int = -1,
):
    """The reference training loop over the (data, shard) mesh of the
    process world (``run_training``'s arguments, plus ``parallel``).
    Returns this rank's final TrainState, equal on every rank."""
    check_layout(parallel)
    if raster_cfg is None:
        raster_cfg = RasterizeConfig()
    random.seed(seed)
    np.random.seed(seed)

    dev = scene.gaussians.device
    mesh = mesh_mod.make_mesh(parallel.data_parallel, parallel.shard_parallel, device=dev)
    rank, n_proc = mesh_mod.world()
    lead = rank == 0
    n_data, n_shard = mesh.data, mesh.shard
    cap_quantum = 4096 * n_shard  # keep the capacity divisible by the shard axis

    state = scene.gaussians
    if state.capacity % n_shard:
        state = gaussians.grow_capacity(state, -(-state.capacity // cap_quantum) * cap_quantum)
    ts = init_train_state(state, scene.cameras_extent, state.max_sh_degree)

    if raster_cfg.autotune and n_proc == 1:
        tune_cams = list(scene.get_train_cameras())
        if tune_cams:
            tuned = autotune.autotune_formulation(ts.state, tune_cams[0], raster_cfg)
            if tuned is not None:
                raster_cfg = tuned["cfg"]
    first_iter = 0
    if start_checkpoint:
        ts = ckpt.load_train_state(start_checkpoint, device=dev)
        if ts.state.capacity % n_shard:
            ts = grow_train_state(ts, -(-ts.state.capacity // cap_quantum) * cap_quantum)
        first_iter = ts.iteration
        print(f"Restored checkpoint at iteration {first_iter}")

    steps: dict[tuple, object] = {}

    def step_for(h, w):
        key = (h, w, ts.state.capacity, ts.active_sh_degree, raster_cfg)
        if key not in steps:
            steps[key] = make_sharded_train_step(mesh, opt_cfg, raster_cfg, h, w,
                                                 ts.state.capacity, ts.active_sh_degree)
        return steps[key]

    # one generator a run, seeded alike on every rank: the same backgrounds
    # and split noise everywhere keep the replicated state equal
    generator = torch.Generator(device=dev).manual_seed(seed)
    bg_fixed = torch.tensor([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
                            dtype=torch.float32, device=dev)
    # every rank loads every image in this slice: single-process ownership,
    # data row d takes slot d of each batch
    sampler = multihost.BatchSampler(scene.get_train_cameras(), [0] * n_data, 1)
    ema_loss = None
    timer = profiling.StepTimer()
    tracer = None

    if gui_server is not None:
        gui_server.convert_SHs_python = pipe.convert_SHs_python
        gui_server.compute_cov3D_python = pipe.compute_cov3D_python

    for iteration in range(first_iter + 1, opt_cfg.iterations + 1):
        ts.iteration = iteration
        if gui_server is not None:
            gui_server.poll(ts, raster_cfg, iterations=opt_cfg.iterations)
            pipe = dataclasses.replace(pipe, convert_SHs_python=gui_server.convert_SHs_python,
                                       compute_cov3D_python=gui_server.compute_cov3D_python)
        if debug_from >= 0 and iteration == debug_from and not pipe.debug:
            pipe = dataclasses.replace(pipe, debug=True)
        if lead and profile_dir is not None and iteration == profile_iters[0]:
            tracer = profiling.Tracer(profile_dir)
            tracer.start()
        timer.start()

        batch = [c if c.image.device == dev else dataclasses.replace(c, image=c.image.to(dev))
                 for c in sampler.next_batch()]
        w, h = batch[0].width, batch[0].height
        if opt_cfg.random_background:
            bg = torch.rand(3, generator=generator, device=dev)
        else:
            bg = bg_fixed

        in_densify_phase = iteration < opt_cfg.densify_until_iter
        ts.state, ts.adam, new_stats, m = step_for(h, w)(
            ts.state, ts.adam, ts.stats, batch, bg, iteration - 1, ts.spatial_lr_scale,
            iteration < opt_cfg.iterations)
        if in_densify_phase:
            ts.stats = new_stats

        # overflow is read at every densify boundary too, before a densify
        # round acts on a truncated step
        at_densify = in_densify_phase and iteration % opt_cfg.densification_interval == 0
        sync = (iteration % log_every == 0 or iteration == opt_cfg.iterations
                or iteration in test_iterations or at_densify)
        if sync:
            loss = float(m["loss"])
            if pipe.debug and not np.isfinite(loss):
                out = (debug_dump(scene.model_path or ".", ts, batch[0], loss) if lead
                       else "rank 0's model path")
                raise RuntimeError(f"[iter {iteration}] non-finite loss {loss}; rasterizer "
                                   f"inputs dumped to {out} (pipe.debug snapshot)")
            budget = local_pair_budget(current_pair_budget(raster_cfg, ts.state.capacity),
                                       n_shard, raster_cfg.chunk)
            if int(m["num_pairs_max"]) > budget:
                raster_cfg = dataclasses.replace(
                    raster_cfg, pair_budget_factor=raster_cfg.pair_budget_factor * 1.5)
                print(f"[iter {iteration}] local pair budget overflow "
                      f"({int(m['num_pairs_max'])} > {budget}); "
                      f"factor -> {raster_cfg.pair_budget_factor:.1f}")
            ema_loss = loss if ema_loss is None else 0.4 * loss + 0.6 * ema_loss
        timer.stop(synced=sync)
        if tracer is not None and iteration == profile_iters[1]:
            print(f"[iter {iteration}] wrote profiler trace to {tracer.stop()}")
            tracer = None
        if progress is not None and iteration % log_every == 0:
            progress(iteration, {
                "ema_loss": ema_loss, "step_s": timer.ema_s,
                "pix_per_s": timer.pixels_per_s(w * h * n_data),
                **{k: float(v) for k, v in m.items()},
            })

        # --- densification schedule (train.py:125-136) ----------------------
        if in_densify_phase:
            if (iteration > opt_cfg.densify_from_iter
                    and iteration % opt_cfg.densification_interval == 0):
                ts = maybe_grow_parallel(ts, cap_quantum, GROW_WATERMARK, GROW_FACTOR)
                use_size_prune = iteration > opt_cfg.opacity_reset_interval
                ts.state, ts.adam, ts.stats, rep = densify_step(ts, generator, opt_cfg,
                                                                use_size_prune)
                if int(rep.n_dropped) > 0:
                    print(f"[iter {iteration}] capacity overflow: dropped "
                          f"{int(rep.n_dropped)} children; growing next round")
            if iteration % opt_cfg.opacity_reset_interval == 0 or (
                    white_background and iteration == opt_cfg.densify_from_iter):
                ts.state, ts.adam = densify.reset_opacity(ts.state, ts.adam)

        # --- reporting / persistence (rank 0) --------------------------------
        if lead and iteration in test_iterations:
            evaluate_and_report(scene, ts, bg_fixed, raster_cfg, iteration, pipe=pipe)
        if lead and iteration in save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(iteration, ts.state)
        if lead and iteration in checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            ckpt.save_train_state(os.path.join(scene.model_path, f"chkpnt{iteration}.npz"), ts)
    if tracer is not None:  # the run ended inside the profiled iterations
        print(f"[iter {opt_cfg.iterations}] wrote profiler trace to {tracer.stop()}")
    return ts
