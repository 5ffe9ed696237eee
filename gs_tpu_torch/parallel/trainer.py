"""Training across a (data, shard) mesh: the reference loop over the sharded
steps (port of ``gs_tpu/parallel/trainer.py``).

``training.run_training`` delegates here when a ``ParallelConfig`` spans
more than one device. Every rank of the world runs this loop alike; the
loop mirrors ``train.py:58-146`` (camera sampling, the densify / opacity
reset / save schedule, evaluation) over one of two layouts:

  - "tile": ``sharded.make_sharded_train_step``; parameters, Adam and the
    densify statistics are replicated, and densify and the opacity reset
    run on every rank through the single-device ``training.densify_step``
    / ``densify.reset_opacity`` with the same generator draws, so the
    ranks stay equal;
  - "gauss": ``gauss_sharded.make_gauss_sharded_train_step``; each rank
    holds its shard's rows of the state, Adam and the statistics
    (``gauss_sharded.shard_rows`` after init and after a resume), densifies
    them with ``densify_sharded.make_sharded_densify`` (the whole
    capacity's split noise drawn alike on every rank) and rebalances the
    shards when their occupancy skews past ``rebalance_skew``
    (``densify_sharded.make_sharded_rebalance_loop``); the opacity reset is
    elementwise, so it runs on each shard.

Both layouts:

  - each step takes ``data_parallel`` cameras, one a data row
    (``multihost.BatchSampler`` from the shared ``random`` seed, so every
    rank draws the same batches); gradients are averaged over them like a
    batch and the densify statistics count each camera, so one loop
    iteration is one reference iteration for every schedule;
  - the ranks of data row d own the train images that slot d can draw
    (``multihost.data_row_feeders``, loaded by ``Scene(data_row=...)``);
    ``multihost.assemble_global_batch`` checks that each rank holds its
    slot's image;
  - the capacity stays a multiple of ``4096 * shard`` (gs_tpu's quantum);
    under "gauss" it grows as gs_tpu's global layout does: the whole
    capacity, padded at the end and cut again into shards;
  - a strip whose pairs pass its budget (``sharded.local_pair_budget``)
    grows the pair budget factor by 1.5, as on one device.

Only rank 0 writes PLYs and checkpoints, evaluates, serves the viewer and
records a profiler trace. Under "gauss" these read the whole state,
gathered in shard order (``gauss_sharded.gather_rows``) on every rank in
step, since a gather is a collective. The startup autotune runs only in a
one-process world, as gs_tpu's (its timing renders would run
unsynchronized on each rank); a multi-process fit takes its kernel paths
from the environment (``ops/switches.py``).
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
from gs_tpu_torch.training import (GROW_FACTOR, GROW_WATERMARK, TrainState, debug_dump,
                                   densify_step, evaluate_and_report, grow_train_state,
                                   init_train_state)
from gs_tpu_torch.models import densify, gaussians
from gs_tpu_torch.ops import autotune
from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget
from gs_tpu_torch.parallel import mesh as mesh_mod
from gs_tpu_torch.parallel.densify_sharded import (make_sharded_densify,
                                                   make_sharded_rebalance_loop, shard_occupancy)
from gs_tpu_torch.parallel.gauss_sharded import (gather_rows, make_gauss_sharded_train_step,
                                                 shard_rows)
from gs_tpu_torch.parallel.sharded import local_pair_budget, make_sharded_train_step
from gs_tpu_torch.utils import ckpt, profiling


def check_layout(parallel: ParallelConfig) -> None:
    if parallel.layout not in ("tile", "gauss"):
        raise ValueError(f"unknown parallel layout {parallel.layout!r}; expected 'tile' or "
                         "'gauss'")


def maybe_grow_parallel(ts, cap_quantum: int, watermark: float, factor: float):
    """The tile layout's capacity growth (gs_tpu ``_maybe_grow_parallel``):
    ``factor`` x the capacity, rounded up to ``cap_quantum``, once the alive
    slots pass ``watermark``."""
    if int(ts.state.num_alive) <= watermark * ts.state.capacity:
        return ts
    return grow_train_state(ts, -(-int(ts.state.capacity * factor) // cap_quantum) * cap_quantum)


def maybe_grow_gauss(mesh, states, adams, stats, cap_quantum: int, watermark: float,
                     factor: float):
    """The gauss layout's capacity growth (gs_tpu ``_maybe_grow_parallel`` +
    ``_place_sharded``): once the alive rows of all shards pass
    ``watermark`` of the whole capacity, the whole capacity grows by
    ``factor`` (rounded up to ``cap_quantum``) with the new slots at its
    end, and is cut into shards again, so rows move between shards exactly
    as gs_tpu's re-placement moves them (a shard-local pad would put the
    slots where gs_tpu's are not, and every later densify and rebalance
    would differ). It gathers the whole state onto every rank for the
    moment, as gs_tpu's ``device_put`` re-layout moves it."""
    n_shard = mesh.shard
    capacity = next(iter(states.values())).capacity * n_shard
    if sum(shard_occupancy(mesh, states)) <= watermark * capacity:
        return states, adams, stats
    whole = gather_rows(mesh, {s: (states[s], adams[s], stats[s]) for s in states})
    ts = grow_train_state(TrainState(*whole),
                          -(-int(capacity * factor) // cap_quantum) * cap_quantum)
    shards = {s: shard_rows((ts.state, ts.adam, ts.stats), n_shard, s) for s in states}
    return ({s: v[0] for s, v in shards.items()}, {s: v[1] for s, v in shards.items()},
            {s: v[2] for s, v in shards.items()})


def maybe_rebalance(mesh, parallel: ParallelConfig, states, adams, stats):
    """Rebalance after a densify once the occupancy skew (max / mean, from
    gathered counts) passes ``parallel.rebalance_skew`` (gs_tpu
    ``_maybe_rebalance``): the rounds of ``make_sharded_rebalance_loop``,
    at most ``parallel.migration_budget`` rows a shard each."""
    if mesh.shard == 1:
        return states, adams, stats
    occ = np.asarray(shard_occupancy(mesh, states))
    if occ.max() / max(occ.mean(), 1.0) <= parallel.rebalance_skew:
        return states, adams, stats
    loop = make_sharded_rebalance_loop(mesh, migration_budget=parallel.migration_budget,
                                       max_rounds=8)
    return loop(states, adams, stats, parallel.rebalance_skew)[:3]


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
    Returns this rank's final TrainState: the whole state, equal on every
    rank, under "tile"; this rank's shard under "gauss"."""
    check_layout(parallel)
    if raster_cfg is None:
        raster_cfg = RasterizeConfig()
    random.seed(seed)
    np.random.seed(seed)

    dev = scene.gaussians.device
    mesh = mesh_mod.make_mesh(parallel.data_parallel, parallel.shard_parallel, device=dev)
    rank, n_proc = mesh_mod.world()
    lead = rank == 0
    me = mesh.ranks[0]
    sh = me[1]  # this rank's shard
    n_data, n_shard = mesh.data, mesh.shard
    gauss = parallel.layout == "gauss"
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
    if gauss:  # each rank keeps its shard's rows
        ts.state, ts.adam, ts.stats = shard_rows((ts.state, ts.adam, ts.stats), n_shard, sh)

    def capacity():
        return ts.state.capacity * (n_shard if gauss else 1)

    def whole():
        """The whole TrainState; under "gauss" a gather every rank must join."""
        if not gauss:
            return ts
        state, adam, stats = gather_rows(mesh, {sh: (ts.state, ts.adam, ts.stats)})
        return dataclasses.replace(ts, state=state, adam=adam, stats=stats)

    def mine():
        """This rank's shard in the gauss functions' {shard index: ...} form."""
        return {sh: ts.state}, {sh: ts.adam}, {sh: ts.stats}

    def local_step(step):
        def run(state, adam, stats, *args):
            states, adams, stats, m = step({sh: state}, {sh: adam}, {sh: stats}, *args)
            return states[sh], adams[sh], stats[sh], m
        return run

    steps: dict[tuple, object] = {}

    def step_for(h, w):
        key = (h, w, capacity(), ts.active_sh_degree, raster_cfg)
        if key not in steps:
            if gauss:
                steps[key] = local_step(make_gauss_sharded_train_step(
                    mesh, opt_cfg, raster_cfg, h, w, capacity(), ts.active_sh_degree,
                    visible_budget=parallel.visible_budget))
            else:
                steps[key] = make_sharded_train_step(mesh, opt_cfg, raster_cfg, h, w,
                                                     capacity(), ts.active_sh_degree)
        return steps[key]

    # one generator a run, seeded alike on every rank: the same backgrounds
    # and split noise everywhere keep the replicated state (and the shards'
    # densify decisions) equal
    generator = torch.Generator(device=dev).manual_seed(seed)
    bg_fixed = torch.tensor([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
                            dtype=torch.float32, device=dev)
    # data row d draws slot d of each batch from the cameras its ranks own
    feeders = multihost.data_row_feeders(mesh)
    sampler = multihost.BatchSampler(scene.get_train_cameras(), feeders, len(feeders))
    ema_loss = None
    timer = profiling.StepTimer()
    tracer = None
    # under "gauss" a viewer frame needs the gathered state, so every rank
    # learns whether rank 0 serves one and joins the gathers it needs
    viewer_world = gauss and bool(mesh.max_all(
        {me: torch.tensor([int(gui_server is not None)], device=mesh.device)})[me])

    if gui_server is not None:
        gui_server.convert_SHs_python = pipe.convert_SHs_python
        gui_server.compute_cov3D_python = pipe.compute_cov3D_python

    for iteration in range(first_iter + 1, opt_cfg.iterations + 1):
        ts.iteration = iteration
        if viewer_world:
            if gui_server is not None and gui_server.conn is None:
                gui_server.try_connect()
            connected = int(gui_server is not None and gui_server.conn is not None)
            if bool(mesh.max_all({me: torch.tensor([connected], device=mesh.device)})[me]):
                full = whole()
                if gui_server is not None:
                    gui_server.poll(full, raster_cfg, iterations=opt_cfg.iterations)
        elif gui_server is not None:
            gui_server.poll(ts, raster_cfg, iterations=opt_cfg.iterations)
        if gui_server is not None:
            pipe = dataclasses.replace(pipe, convert_SHs_python=gui_server.convert_SHs_python,
                                       compute_cov3D_python=gui_server.compute_cov3D_python)
        if debug_from >= 0 and iteration == debug_from and not pipe.debug:
            pipe = dataclasses.replace(pipe, debug=True)
        if lead and profile_dir is not None and iteration == profile_iters[0]:
            tracer = profiling.Tracer(profile_dir)
            tracer.start()
        timer.start()

        batch = multihost.assemble_global_batch(mesh, sampler.next_batch())
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
                full = whole()
                out = (debug_dump(scene.model_path or ".", full, batch[me[0]], loss) if lead
                       else "rank 0's model path")
                raise RuntimeError(f"[iter {iteration}] non-finite loss {loss}; rasterizer "
                                   f"inputs dumped to {out} (pipe.debug snapshot)")
            if parallel.visible_budget and int(m.get("num_visible_max", 0)) > \
                    parallel.visible_budget:
                print(f"[iter {iteration}] visible budget overflow "
                      f"({int(m['num_visible_max'])} > {parallel.visible_budget}); splats "
                      f"dropped — raise ParallelConfig.visible_budget")
            budget = local_pair_budget(current_pair_budget(raster_cfg, capacity()),
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
                use_size_prune = iteration > opt_cfg.opacity_reset_interval
                if gauss:
                    grown = maybe_grow_gauss(mesh, *mine(), cap_quantum, GROW_WATERMARK,
                                             GROW_FACTOR)
                    ts.state, ts.adam, ts.stats = (x[sh] for x in grown)
                    noise = densify.split_noise(generator, capacity(), dev)
                    *shards, rep = make_sharded_densify(mesh, opt_cfg, capacity(),
                                                        use_size_prune)(
                        *mine(), noise, ts.spatial_lr_scale)
                    shards = maybe_rebalance(mesh, parallel, *shards)
                    ts.state, ts.adam, ts.stats = (x[sh] for x in shards)
                else:
                    ts = maybe_grow_parallel(ts, cap_quantum, GROW_WATERMARK, GROW_FACTOR)
                    ts.state, ts.adam, ts.stats, rep = densify_step(ts, generator, opt_cfg,
                                                                    use_size_prune)
                if int(rep.n_dropped) > 0:
                    print(f"[iter {iteration}] capacity overflow: dropped "
                          f"{int(rep.n_dropped)} children; growing next round")
            if iteration % opt_cfg.opacity_reset_interval == 0 or (
                    white_background and iteration == opt_cfg.densify_from_iter):
                ts.state, ts.adam = densify.reset_opacity(ts.state, ts.adam)

        # --- reporting / persistence (rank 0; under "gauss" every rank gathers) --
        writes = (iteration in test_iterations or iteration in save_iterations
                  or iteration in checkpoint_iterations)
        full = whole() if writes else None
        if lead and iteration in test_iterations:
            evaluate_and_report(scene, full, bg_fixed, raster_cfg, iteration, pipe=pipe)
        if lead and iteration in save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(iteration, full.state)
        if lead and iteration in checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            ckpt.save_train_state(os.path.join(scene.model_path, f"chkpnt{iteration}.npz"), full)
        del full
    if tracer is not None:  # the run ended inside the profiled iterations
        print(f"[iter {opt_cfg.iterations}] wrote profiler trace to {tracer.stop()}")
    return ts
