#!/usr/bin/env python3
"""On-card smoke run of the gs_tpu_torch port (one NVIDIA GPU).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc:

1. prints the card (name, count, ``nvidia-smi`` name and power limit);
2. builds the six kernels from ``gs_tpu_torch/csrc`` (``ops/cuda_build``),
   one nvcc per source, all at once (nvcc's register / shared-memory report
   is printed for each), and checks that ptxas gives the warp-layout
   kernels (``NO_STACK_FRAME``) no stack frame: an array fallen to local
   memory once tripled B2's time;
3. on the golden bundle (``tests/golden/raster_golden.npz``): holds the
   forward and backward kernels against their plain PyTorch versions (the
   backward twice for the same bits) at the bench tile sizes and at one
   tile size per pixel layout of the backward kernel (``LAYOUT_TILES``),
   and the card's render and ``rasterize_tiled`` gradients against the
   bundle's float64 image and gradients;
4. drives the port's render path at full width: the bench scene (262,144
   Gaussians, SH degree 3, uniform in [-2,2]^3, camera at z=5, fov 70x46
   deg, 1920x1080) made from ``np.random.default_rng(0)``, written with the
   port's ``save_gaussian_ply``, loaded back on the card, its pair budget
   grown to 1.05 x num_pairs, rendered through ``training.eval_render`` at
   16x16 and 48x32 tiles with the launch counts reset just before and read
   just after; then the forward kernel is held against the plain version
   on the inputs that run gave it, and both are timed with CUDA events;
5. drives the training path at the same width: 5 ``training.train_step``
   calls per tile size from that scene towards the image of the same
   construction made from ``default_rng(1)``, counts reset just before and
   read just after; the loss must fall and every group move; the backward
   kernel is held against its plain version on the last step's inputs, and
   kernel, plain version and train_step are timed and profiled, and the
   backward kernel runs twice on those inputs for the same bits;
6. holds the tile-walk kernels B3 / B4 against B1 / B2 on the bench
   scene's captured inputs (both bitwise, B4 also at B2's tolerance) and
   times each pair in turns;
7. drives the pair-movement kernels on the bench scene at both tile sizes:
   3 ``train_step``s with ``GRAD_REDUCE="cuda"`` (B5: the loss falls, one
   step's gradients agree with the default reduction's, B5 agrees with its
   plain version (run on the CPU, where ``index_add_`` adds in row order)
   bitwise and gives the same bits twice, B5 / the sort feeding it /
   ``index_add_`` / autograd's gather backward / both train_steps timed in
   turns), then one ``eval_render`` and one ``train_step`` with
   ``EXPAND_IMPL="cuda"`` (B6: the render and every binning integer equal
   the default path's bitwise, B6 equals its plain version bitwise, B6 /
   ``repeat_interleave`` / binning's step 2 on both paths timed); and
   holds B5 against its plain version on the CPU, twice for the same bits,
   on the edge layouts of its block-window design (n not a multiple of
   256, empty segments at block boundaries, a block whose whole window is
   empty, one segment of 100,000 rows, every 16th segment ~1,000 rows,
   ``num_rows`` cutting the last segment), with NaN rows past what it may
   read: bitwise for segments B5 sums in row order, within one float
   rounding for the longer ones it sums as a block; and times B5 beside
   ``index_add_`` on each layout;
8. drives the heavy scene (bench.py's second configuration: 1,048,576
   Gaussians, unclipped log-scales, varied opacities, from
   ``default_rng(0)``) at 48x32 tiles, which ``pick_kernel_mode`` routes to
   the tile-walk kernels: one ``eval_render`` and 3 ``train_step``s with
   the counts reset just before and read just after; the distribution of
   the tiles' range lengths; B3 / B4 against B1 / B2 (bitwise) and against
   their plain versions over the whole frame, B4 twice for the same bits,
   times, bounds and a profile of one ``train_step``; then step 7's B5
   path (2 steps) and B6 path on it, and one ``train_step`` with both
   switches on, which launches B3, B4, B5 and B6 once each;
9. runs ``synthetic.recover`` (``run_training`` with densify, prune,
   opacity reset and capacity / pair-budget growth) at
   benchmarks/synthetic_e2e.py's defaults and checks the test PSNR.

Every phase checks its exact launch counts. The bench and recovery phases
must launch no tile-walk kernel, the heavy phase no chunk-grid kernel, and
nothing but steps 7 and 8's switched runs a pair-movement kernel.

It prints a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": ...}`` line. Any failed check raises: the exit
code is then non-zero and neither line is printed. Without a CUDA device,
or without the repository around it, it fails the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "raster_golden.npz")
N_GAUSS = 262_144
WIDTH, HEIGHT = 1920, 1080
TILES = ((16, 16), (48, 32))
# tile sizes that take each of composite_bwd.cu's pixel layouts on the golden
# bundle: 1 warp (8x8), 4 warps (32x16; 20x12, whose cells overhang the
# tile), 8 warps of 4 cells (32x32) and of 8 (64x32), the strided map (72x28)
LAYOUT_TILES = ((8, 8), (32, 16), (20, 12), (32, 32), (64, 32), (72, 28))
# kernel vs plain version (same decisions by design; color sums may round
# differently): color and T absolute error, share of pixels whose ncon differs
TOL_COLOR, TOL_T, TOL_NCON_SHARE = 2e-5, 2e-6, 1e-5
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth; special-function results (the exp2
# inside expf): 16 per SM per clock (CUDA programming guide, compute
# capability 9.0) x 132 SMs x the 1.98 GHz boost clock the fp32 peak assumes
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 16 * 132 * 1.98e9
# fp32 operations of composite_fwd.cu per pair x pixel evaluation, by how far
# the evaluation gets: every one computes dx, dy (2) and power (9) and tests
# the cull (1); past the cull, expf (counted as 1), * opac, min and the skip
# test (4); past the skip, 1 - alpha, * T and the stop test (3); a
# contribution then w = alpha * T and 3 mul + 3 add of color (7)
OPS_EVAL, OPS_PAST_CULL, OPS_PAST_SKIP, OPS_CONTRIB = 12, 4, 3, 7
# fp32 operations of composite_bwd.cu per pair x pixel evaluation: the same
# 12 up to the cull and 4 past it; a contribution then costs 1 - alpha, the
# division of T, w (3), b = rgb . g_color (5), d_alpha (4), the suffix sum
# (2), d_power (1) and the nine accumulated gradients (6 + 6 + 4 + 4 + 4 +
# 2 + 2 + 2 + 2 = 32): 47
BWD_OPS_EVAL, BWD_OPS_PAST_CULL, BWD_OPS_CONTRIB = 12, 4, 47
# backward kernel vs plain version, per column of d_attr (the pixel sums are
# taken in another order): rtol, and atol as a share of the column's max
BWD_RTOL, BWD_ATOL_SHARE = 1e-4, 1e-5
# rasterize_tiled gradients vs the float64 golden (tests/test_golden.py:76-81)
GOLD_GRAD_RTOL, GOLD_GRAD_ATOL_SHARE = 2e-3, 2e-5
TRAIN_STEPS = 5
# the kernels on composite_warps.cuh's warp layout, whose ptxas report must
# show no stack frame (an array in local memory)
NO_STACK_FRAME = ("composite_bwd", "composite_fwd_tile", "composite_bwd_tile")
# B5's path: train_steps with GRAD_REDUCE="cuda" per bench tile size and on
# the heavy scene; B5 vs its plain version: |d| <= SEGRED_TOL x the
# segment's sum of |rows|; one step's gradients, cuda vs scatter reduction,
# per group (tests/test_tiled.py:401-407): rtol, and atol as a share of the
# group's max
REDUCE_STEPS, HEAVY_REDUCE_STEPS = 3, 2
# ~5 ms at the 1.98 GHz boost clock: longer than the host takes to launch
# 20 runs of the shortest kernel timed here (B5 / B6, ~0.1 ms each)
HOST_AHEAD_CYCLES = 10_000_000
SEGRED_TOL = 2e-5
# B5 sums segments of at most this many rows in row order, as the plain
# version's CPU index_add_ does, and longer ones as a block
# (csrc/segment_reduce.cu, kLongRows)
SEGRED_ROW_ORDER_MAX = 512
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-5
RECOVERY_PSNR_MIN = 30.0
# bench.py's heavy scene (bench.py:21-25,64-92) at its tile size
N_HEAVY = 1_048_576
HEAVY_TILE = (48, 32)
HEAVY_TRAIN_STEPS = 3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs (CUDA
    events). The card first spins for HOST_AHEAD_CYCLES, so that the host
    queues the runs of a short kernel ahead of the card and the events time
    the card's work, not the Python that launches it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, ref):
    """Max abs error of color and T, and the count of ncon mismatches."""
    color_err = float((got[0] - ref[0]).abs().max()) if got[0].numel() else 0.0
    t_err = float((got[1] - ref[1]).abs().max()) if got[1].numel() else 0.0
    return color_err, t_err, int((got[2] != ref[2]).sum())


def needed_work(torch, st, sp_attr, tile_ids, starts, ends, ncon) -> dict:
    """The pair x pixel evaluations these inputs need at least, and how far
    each gets (see OPS_*). Each pixel alone, whatever its tile does: it walks
    its tile's pairs in order up to and including the pair that stops it, or
    to the end of the range if none does. The stop is the first pair past
    the cull and the skip after the last contributor (ncon - 1), since any
    later such pair that did not stop the pixel would have contributed."""
    s, p, b = st.chunk, st.tile_w * st.tile_h, sp_attr.shape[0]
    dev = sp_attr.device
    lane = torch.arange(s, device=dev)
    pix = torch.arange(p, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    batch = max(1, (1 << 16) // p)  # tiles at a time: [batch, S, P] temporaries
    for b0 in range(0, tile_ids.shape[0], batch):
        sl = slice(b0, b0 + batch)
        tid = tile_ids[sl].long()[:, None, None]
        px = ((tid % st.tiles_x) * st.tile_w + pix % st.tile_w).float()  # [tb, 1, P]
        py = ((tid // st.tiles_x) * st.tile_h + pix // st.tile_w).float()
        start, end = starts[sl].long(), ends[sl].long()
        last = ncon[sl].long()[:, None, :]
        stopped = torch.zeros_like(last, dtype=torch.bool)
        for k in range(int(((end - start + s - 1) // s).max())):
            pos = start[:, None] + k * s + lane  # [tb, S]
            a = sp_attr[pos.clamp(max=b - 1)][..., None]  # [tb, S, 9, 1]
            dx, dy = a[:, :, 0] - px, a[:, :, 1] - py
            power = -0.5 * (a[:, :, 2] * dx * dx + a[:, :, 4] * dy * dy) - a[:, :, 3] * dx * dy
            alpha = torch.clamp(a[:, :, 8] * torch.exp(power), max=0.99)
            past_cull = power <= 0.0
            past_skip = past_cull & (alpha >= 1.0 / 255.0)
            pos = pos[..., None]
            in_range = pos < end[:, None, None]
            stop = past_skip & in_range & (pos >= last)
            stop_i = stop.int()
            need = in_range & ~stopped & (torch.cumsum(stop_i, 1) - stop_i == 0)
            counts += torch.stack([need.sum(), (need & past_cull).sum(),
                                   (need & past_skip).sum(), (need & past_skip & (pos < last)).sum()])
            stopped |= stop.any(1, keepdim=True)
    evals, past_cull, past_skip, contrib = (int(c) for c in counts.cpu())
    return dict(evals=evals, past_cull=past_cull, past_skip=past_skip, contributions=contrib,
                fp32_ops=OPS_EVAL * evals + OPS_PAST_CULL * past_cull
                + OPS_PAST_SKIP * past_skip + OPS_CONTRIB * contrib)


def needed_work_bwd(torch, st, sp_attr, tile_ids, starts, ends, ncon) -> dict:
    """The pair x pixel evaluations the backward needs, and how far each
    gets (see BWD_OPS_*): each pixel needs the pairs of its tile's range
    below its own ncon; of those, the ones past the cull and the skip are
    exactly its contributors."""
    s, p, b = st.chunk, st.tile_w * st.tile_h, sp_attr.shape[0]
    dev = sp_attr.device
    lane = torch.arange(s, device=dev)
    pix = torch.arange(p, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    batch = max(1, (1 << 16) // p)
    for b0 in range(0, tile_ids.shape[0], batch):
        sl = slice(b0, b0 + batch)
        tid = tile_ids[sl].long()[:, None, None]
        px = ((tid % st.tiles_x) * st.tile_w + pix % st.tile_w).float()  # [tb, 1, P]
        py = ((tid // st.tiles_x) * st.tile_h + pix // st.tile_w).float()
        start, end = starts[sl].long(), ends[sl].long()
        last = ncon[sl].long()[:, None, :]
        n_chunks = int(((end - start + s - 1) // s).max()) if end.numel() else 0
        for k in range(n_chunks):
            pos = start[:, None] + k * s + lane  # [tb, S]
            a = sp_attr[pos.clamp(max=b - 1)][..., None]  # [tb, S, 9, 1]
            dx, dy = a[:, :, 0] - px, a[:, :, 1] - py
            power = -0.5 * (a[:, :, 2] * dx * dx + a[:, :, 4] * dy * dy) - a[:, :, 3] * dx * dy
            alpha = torch.clamp(a[:, :, 8] * torch.exp(power), max=0.99)
            pos = pos[..., None]
            need = (pos < end[:, None, None]) & (pos < last)
            past_cull = need & (power <= 0.0)
            contrib = past_cull & (alpha >= 1.0 / 255.0)
            counts += torch.stack([need.sum(), past_cull.sum(), contrib.sum()])
    evals, past_cull, contrib = (int(c) for c in counts.cpu())
    return dict(evals=evals, past_cull=past_cull, contributions=contrib,
                fp32_ops=BWD_OPS_EVAL * evals + BWD_OPS_PAST_CULL * past_cull
                + BWD_OPS_CONTRIB * contrib)


def compare_bwd(got, ref) -> tuple[float, float]:
    """Max abs error of d_attr, and the worst ratio of a column's error to
    its allowance (BWD_RTOL x |ref| + BWD_ATOL_SHARE x the column's max)."""
    err = (got - ref).abs()
    allowed = BWD_RTOL * ref.abs() + BWD_ATOL_SHARE * ref.abs().amax(dim=0, keepdim=True)
    ratio = err / allowed.clamp(min=1e-30)
    ratio = ratio.masked_fill(err == 0, 0.0)
    return (float(err.max()) if err.numel() else 0.0,
            float(ratio.max()) if ratio.numel() else 0.0)


def range_distribution(torch, starts, ends) -> dict:
    """Pairs a tile over the ranges [starts, ends): min, median, p99, max,
    mean, and the longest range's multiple of the mean."""
    lengths = (ends.long() - starts.long()).double()
    q = torch.quantile(lengths, torch.tensor([0.0, 0.5, 0.99, 1.0], dtype=torch.float64,
                                             device=lengths.device)).tolist()
    avg = float(lengths.mean())
    return dict(tiles=lengths.numel(), min=q[0], median=q[1], p99=q[2], max=q[3], mean=avg,
                max_over_mean=q[3] / avg if avg else 0.0)


def covered_rows(torch, b, starts, ends):
    """[B] bool: rows inside some tile's [start, end)."""
    delta = torch.zeros(b + 1, dtype=torch.int32, device=starts.device)
    delta.index_add_(0, starts.long(), torch.ones_like(starts))
    delta.index_add_(0, ends.long(), -torch.ones_like(ends))
    return torch.cumsum(delta, 0)[:b] > 0


def _bound(work, pairs_read, bytes_moved) -> dict:
    fp32_ms = work["fp32_ops"] / PEAK_FP32_OPS * 1e3
    sfu_ms = work["past_cull"] / PEAK_SFU * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    ops_ms = max(fp32_ms, sfu_ms)
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes", fp32_ms=fp32_ms,
                sfu_ms=sfu_ms, bytes_ms=bytes_ms, bytes=bytes_moved, pairs_read=pairs_read,
                **work)


def fwd_bound(torch, st, sp_attr, tile_ids, starts, ends, ncon) -> dict:
    """The least time of the forward on these inputs: the larger of its
    needed fp32 operations (or expf results) at the card's peak and its
    bytes (the pairs of the ranges read once, 12 B per tile, color, T and
    ncon written) at the memory rate. The same count holds B1 and B3."""
    work = needed_work(torch, st, sp_attr, tile_ids, starts, ends, ncon)
    pairs_read = int((ends.long() - starts.long()).sum())
    bytes_moved = pairs_read * 36 + 3 * 4 * tile_ids.numel() + ncon.numel() * (3 * 4 + 4 + 4)
    return _bound(work, pairs_read, bytes_moved)


def bwd_bound(torch, st, sp_attr, tile_ids, starts, ends, t_final, ncon) -> dict:
    """The least time of the backward on these inputs (B2 and B4): sp_attr
    over the trimmed ranges read, all of d_attr written, the per-pixel
    t_final, ncon, g_color and gt_term read, 12 B per tile."""
    work = needed_work_bwd(torch, st, sp_attr, tile_ids, starts, ends, ncon)
    pairs_read = int((ends.long() - starts.long()).sum())
    bytes_moved = (pairs_read * 36 + sp_attr.shape[0] * 36 + t_final.numel() * (4 + 4 + 12 + 4)
                   + 3 * 4 * tile_ids.numel())
    return _bound(work, pairs_read, bytes_moved)


def print_bound(label: str, b: dict) -> None:
    print(f"bound {label}: {b['bound_ms']:.4f} ms ({b['bound_by']}); fp32 {b['fp32_ms']:.4f} ms "
          f"({b['fp32_ops']} ops), expf {b['sfu_ms']:.4f} ms, bytes {b['bytes_ms']:.4f} ms "
          f"({b['bytes']} B); {b['evals']} pair x pixel evals needed, {b['past_cull']} past "
          f"the cull, {b['contributions']} contributions; {b['pairs_read']} pairs in the "
          f"ranges", flush=True)


@contextlib.contextmanager
def capture_calls(module, name: str, store: list):
    """Record the positional arguments (tensors detached) of every call of
    ``module.<name>`` made through the module attribute."""
    original = getattr(module, name)

    def recording(*args, **kwargs):
        store.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args))
        return original(*args, **kwargs)

    setattr(module, name, recording)
    try:
        yield store
    finally:
        setattr(module, name, original)


def capture_composite(store: list):
    """Record the arguments rasterize_tiled hands to composite_tiles."""
    from gs_tpu_torch.ops import rasterize_tiled

    return capture_calls(rasterize_tiled, "composite_tiles", store)


def capture_composite_bwd(store: list, wrapper: str = "composite_bwd_cuda"):
    """Record the arguments the compositing backward hands to the kernel's
    wrapper ``wrapper`` (ends already trimmed)."""
    from gs_tpu_torch.ops import rasterize_tiled

    return capture_calls(rasterize_tiled, wrapper, store)


@contextlib.contextmanager
def switches(grad_reduce: str = "scatter", expand_impl: str = "scatter"):
    """The port's GRAD_REDUCE and EXPAND_IMPL set for the block, then back
    to the defaults."""
    from gs_tpu_torch.ops import binning, rasterize_tiled

    rasterize_tiled.GRAD_REDUCE, binning.EXPAND_IMPL = grad_reduce, expand_impl
    try:
        yield
    finally:
        rasterize_tiled.GRAD_REDUCE, binning.EXPAND_IMPL = "scatter", "scatter"


def profile(torch, what: str, run_once, reps: int) -> None:
    """Device time by kernel over ``reps`` runs of ``run_once``
    (torch.profiler), and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile: {reps} x {what}, wall {wall_us / reps / 1e3:.3f} ms each, device busy "
          f"{busy_us / reps / 1e3:.3f} ms each ({100 * busy_us / wall_us:.1f}% of wall), "
          f"{sum(e.count for e in kernels) // reps} device ops each", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / reps / 1e3:8.3f} ms  x{e.count // reps:<4d} "
              f"{e.key[:90]}", flush=True)


def golden_phase(torch, dev):
    """Both kernels vs their plain versions on the golden splats binned by
    the port, at the bench tile sizes and at one tile size per pixel layout
    of the backward kernel (``LAYOUT_TILES``), the backward twice for the
    same bits; the card's tiled render and its gradients vs the bundle's
    float64 image and gradients."""
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.ops import rasterize_cuda
    from gs_tpu_torch.ops.rasterize_tiled import rasterize_tiled

    g = np.load(GOLDEN)
    h, w = int(g["height"]), int(g["width"])
    bg = torch.from_numpy(g["bg"]).to(dev)
    for tw, th in TILES + LAYOUT_TILES:
        leaves = [torch.from_numpy(g[k]).to(dev).requires_grad_()
                  for k in ("means2d", "conics", "colors", "opacities")]
        rest = [torch.from_numpy(g[k]).to(dev) for k in ("depths", "radii")]
        cfg = RasterizeConfig(tile_w=tw, tile_h=th, min_pair_budget=1 << 13)
        calls, bwd_calls = [], []
        with capture_composite(calls), capture_composite_bwd(bwd_calls):
            out = rasterize_tiled(*leaves, *rest, h, w, bg, cfg)
            loss = (out.image * torch.from_numpy(g["g_img"]).to(dev)).sum() \
                + (out.final_t * torch.from_numpy(g["g_t"]).to(dev)).sum()
            loss.backward()
        st, sp_attr, tile_ids, starts, ends = calls[0]
        got = rasterize_cuda.composite_fwd_cuda(st, sp_attr.detach(), tile_ids, starts, ends)
        ref = rasterize_cuda.composite_fwd_torch(st, sp_attr.detach(), tile_ids, starts, ends)
        d_got = rasterize_cuda.composite_bwd_cuda(*bwd_calls[0])
        d_again = rasterize_cuda.composite_bwd_cuda(*bwd_calls[0])
        d_ref = rasterize_cuda.composite_bwd_torch(*bwd_calls[0])
        torch.cuda.synchronize()
        c_err, t_err, mism = compare(got, ref)
        d_err, d_ratio = compare_bwd(d_got, d_ref)
        same = torch.equal(d_got, d_again)
        img_err = float(np.abs(out.image.detach().cpu().numpy() - g["image"]).max())
        t_gold = float(np.abs(out.final_t.detach().cpu().numpy() - g["t_final"]).max())
        print(f"golden {tw}x{th}: fwd kernel vs plain max|d color|={c_err:.3g} "
              f"max|d T|={t_err:.3g} ncon mismatches={mism}; bwd kernel vs plain "
              f"max|d d_attr|={d_err:.3g} (worst {d_ratio:.3g} of the allowance), same bits "
              f"twice {same}; card render vs fp64 golden max|d image|={img_err:.3g} "
              f"max|d T|={t_gold:.3g}", flush=True)
        check(c_err <= TOL_COLOR and t_err <= TOL_T and mism == 0, "golden fwd kernel vs plain")
        check(d_ratio <= 1.0 and same, f"golden bwd kernel vs plain at {tw}x{th}")
        if (tw, th) != (16, 16):  # the bundle's tile size
            continue
        check(np.allclose(out.image.detach().cpu().numpy(), g["image"], rtol=2e-5, atol=2e-5)
              and np.allclose(out.final_t.detach().cpu().numpy(), g["t_final"], rtol=2e-5,
                              atol=2e-6), "card render vs the golden bundle")
        for leaf, key in zip(leaves, ("d_means2d", "d_conics", "d_colors", "d_opacities")):
            got_g, want = leaf.grad.double().cpu().numpy(), g[key]
            atol = GOLD_GRAD_ATOL_SHARE * max(float(np.abs(want).max()), 1.0)
            err = float(np.abs(got_g - want).max())
            print(f"golden gradient {key}: max|d|={err:.3g} (atol {atol:.3g}, "
                  f"rtol {GOLD_GRAD_RTOL})", flush=True)
            check(np.allclose(got_g, want, rtol=GOLD_GRAD_RTOL, atol=atol),
                  f"card gradient {key} vs the golden bundle")


def make_bench_state(dev, seed: int):
    """bench.py's scene (bench.py:64-92) made from ``default_rng(seed)``."""
    from gs_tpu_torch.models import gaussians

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(N_GAUSS, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(N_GAUSS, 3)).astype(np.float32)
    state = gaussians.create_from_pcd(pts, cols, max_sh_degree=3, capacity=N_GAUSS, device=dev)
    state.log_scale.clamp_(-6.0, -3.5)
    state.logit_opacity.zero_()
    return state


def bench_camera(dev):
    """bench.py's camera (bench.py:64-92): at z=5, fov 70x46 deg, 1920x1080."""
    from gs_tpu_torch import cameras

    return cameras.make_camera(np.eye(3), np.array([0.0, 0.0, 5.0]), fovx=math.radians(70),
                               fovy=math.radians(46), width=WIDTH, height=HEIGHT, device=dev)


def bench_scene(torch, dev, workdir):
    """bench.py's 1080p scene, through a PLY written and read by the port."""
    from gs_tpu_torch.data import ply

    t0 = time.perf_counter()
    made = make_bench_state(dev, 0)
    path = os.path.join(workdir, "point_cloud.ply")
    ply.save_state_ply(path, made)
    state = ply.load_gaussian_ply(path, device=dev)
    check(state.capacity == N_GAUSS and int(state.num_alive) == N_GAUSS
          and state.max_sh_degree == 3, "PLY round trip size")
    for name in ("xyz", "features_dc", "features_rest", "log_scale", "quat", "logit_opacity"):
        check(torch.equal(getattr(state, name), getattr(made, name)), f"PLY round trip {name}")
    cam = bench_camera(dev)
    print(f"scene: {N_GAUSS} Gaussians, SH degree 3, {WIDTH}x{HEIGHT}; built, written "
          f"({os.path.getsize(path)} B PLY) and reloaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return state, cam


def reset_launches() -> None:
    from gs_tpu_torch.ops import cuda_build

    for key in cuda_build.LAUNCHES:
        cuda_build.LAUNCHES[key] = 0


def launches_of(**counts) -> dict:
    """The full launch-count dict with ``counts`` set and every other kernel 0."""
    from gs_tpu_torch.ops import cuda_build

    return {key: counts.get(key, 0) for key in cuda_build.LAUNCHES}


def timed_in_turns(torch, kernel, other, kernel_reps: int = 20, other_reps: int = 1):
    """A kernel and another version of it (the plain version, or the other
    kernel form) timed with CUDA events in turns (other, kernel, kernel,
    other); returns the kernel's and the other's runs (ms)."""
    kernel()
    other()
    torch.cuda.synchronize()
    k_ms, o_ms = [], []
    for fn, times, reps in ((other, o_ms, other_reps), (kernel, k_ms, kernel_reps),
                            (kernel, k_ms, kernel_reps), (other, o_ms, other_reps)):
        times.append(cuda_ms(fn, reps))
    return k_ms, o_ms


def mean(xs) -> float:
    return sum(xs) / len(xs)


def render_phase(torch, state, cam, bg, cfgs) -> tuple[dict, dict, dict]:
    """The render path at both tile sizes (counts reset just before, read
    just after), then the forward kernel vs its plain version on the inputs
    that run gave it, with times and bounds. Returns the launches, the
    results and the captured inputs by tile size."""
    from gs_tpu_torch.ops import rasterize_cuda
    from gs_tpu_torch.training import eval_render

    captured, images, per_tile = {}, {}, {}
    reset_launches()
    for tw, th in TILES:
        before = rasterize_cuda.LAUNCHES["composite_fwd"]
        calls = []
        with capture_composite(calls):
            images[(tw, th)] = eval_render(state, cam, bg, active_sh_degree=3,
                                           raster_cfg=cfgs[(tw, th)][0])
        torch.cuda.synchronize()
        captured[(tw, th)] = calls[0]
        per_tile[(tw, th)] = rasterize_cuda.LAUNCHES["composite_fwd"] - before
    launches = dict(rasterize_cuda.LAUNCHES)
    print(f"render path launches: {launches} "
          f"(per render: {[per_tile[t] for t in TILES]})", flush=True)
    check(launches == launches_of(composite_fwd=len(TILES)),
          "the bench render path launches composite_fwd once a render and nothing else")
    for tw, th in TILES:
        check(captured[(tw, th)][0].kernel_mode == "chunk", f"chunk-grid form at {tw}x{th}")
        img = images[(tw, th)]
        check(img.shape == (3, HEIGHT, WIDTH) and bool(torch.isfinite(img).all()),
              f"finite {HEIGHT}x{WIDTH} image at {tw}x{th}")
        print(f"image {tw}x{th}: mean {float(img.mean()):.6f}, "
              f"covered share {float((img.sum(0) > 0).float().mean()):.4f}", flush=True)
    diff = float((images[(16, 16)] - images[(48, 32)]).abs().max())
    print(f"16x16 vs 48x32 image max abs diff {diff:.3g}", flush=True)

    results = {}
    for tw, th in TILES:
        args = captured[(tw, th)]
        got = rasterize_cuda.composite_fwd_cuda(*args)
        ref = rasterize_cuda.composite_fwd_torch(*args)
        torch.cuda.synchronize()
        c_err, t_err, mism = compare(got, ref)
        pixels = ref[1].numel()
        print(f"full {tw}x{th}: fwd kernel vs plain max|d color|={c_err:.3g} "
              f"max|d T|={t_err:.3g} ncon mismatches={mism} of {pixels} pixels", flush=True)
        check(c_err <= TOL_COLOR and t_err <= TOL_T and mism <= TOL_NCON_SHARE * pixels,
              f"fwd kernel vs plain at {tw}x{th}")
        k_ms, p_ms = timed_in_turns(torch, lambda: rasterize_cuda.composite_fwd_cuda(*args),
                                    lambda: rasterize_cuda.composite_fwd_torch(*args))
        render_ms = cuda_ms(lambda: eval_render(state, cam, bg, active_sh_degree=3,
                                                raster_cfg=cfgs[(tw, th)][0]), 5)
        bound = fwd_bound(torch, *args, ref[2])
        results[(tw, th)] = r = dict(
            shape=f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, {tw}x{th} tiles",
            launches=per_tile[(tw, th)], max_abs_err=c_err, t_max_abs_err=t_err,
            ncon_mismatches=mism, ms=mean(k_ms), ms_runs=k_ms, plain_ms=mean(p_ms),
            plain_ms_runs=p_ms, **bound, num_pairs=cfgs[(tw, th)][1],
            pair_budget=cfgs[(tw, th)][2], tiles=args[2].numel(), render_ms=render_ms)
        print(f"time {tw}x{th}: composite_fwd kernel {r['ms']:.3f} ms (runs {k_ms}), plain "
              f"{r['plain_ms']:.1f} ms (runs {p_ms}), eval_render {render_ms:.3f} ms", flush=True)
        print_bound(f"composite_fwd {tw}x{th}", bound)
    for tw, th in TILES:
        print(f"where eval_render's time goes at {tw}x{th}:", flush=True)
        profile(torch, "eval_render", lambda: eval_render(state, cam, bg, active_sh_degree=3,
                                                          raster_cfg=cfgs[(tw, th)][0]), 3)
    return launches, results, captured


def train_phase(torch, dev, state, cam, bg, cfgs) -> tuple[dict, dict, dict, object]:
    """The training path at both tile sizes: TRAIN_STEPS train_steps each,
    counts reset just before and read just after; then the backward kernel
    vs its plain version on the last step's inputs, with times and bounds.
    Returns the launches, the results, the captured inputs and the training
    camera (the view with its target image)."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.ops import rasterize_cuda

    target = training.eval_render(make_bench_state(dev, 1), cam, bg, active_sh_degree=3,
                                   raster_cfg=cfgs[TILES[0]][0])
    cam = dataclasses.replace(cam, image=target)
    opt = OptimizationParams()
    ts0 = training.init_train_state(state, 1.0, 3)

    def step(ts, iteration, cfg):
        return training.train_step(ts.state, ts.adam, ts.stats, cam, bg, iteration, 1.0,
                                   active_sh_degree=3, opt_cfg=opt, raster_cfg=cfg,
                                   accumulate_stats=True)

    captured, per_tile = {}, {}
    reset_launches()
    for tw, th in TILES:
        cfg = cfgs[(tw, th)][0]
        before = dict(rasterize_cuda.LAUNCHES)
        ts = training.init_train_state(state, 1.0, 3)
        losses, calls = [], []
        with capture_composite_bwd(calls):
            for i in range(TRAIN_STEPS):
                calls.clear()  # keep the last step's inputs only
                ts.state, ts.adam, ts.stats, m = step(ts, i, cfg)
                losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        captured[(tw, th)] = calls[0]
        per_tile[(tw, th)] = {k: rasterize_cuda.LAUNCHES[k] - before[k] for k in before}
        print(f"train {tw}x{th}: losses {losses}; launches {per_tile[(tw, th)]}", flush=True)
        check_training(torch, ts, ts0, losses, TRAIN_STEPS, f"{tw}x{th}")
        check(per_tile[(tw, th)] == launches_of(composite_fwd=TRAIN_STEPS,
                                                composite_bwd=TRAIN_STEPS),
              f"one fwd and one bwd launch per train_step at {tw}x{th}, no tile-walk kernel")
    launches = dict(rasterize_cuda.LAUNCHES)
    print(f"train path launches: {launches}", flush=True)

    results = {}
    for tw, th in TILES:
        args = captured[(tw, th)]
        st, sp_attr, tile_ids, starts, ends, t_final, ncon = args[:7]
        got = rasterize_cuda.composite_bwd_cuda(*args)
        again = rasterize_cuda.composite_bwd_cuda(*args)
        ref = rasterize_cuda.composite_bwd_torch(*args)
        torch.cuda.synchronize()
        err, ratio = compare_bwd(got, ref)
        same_bits = torch.equal(got, again)
        inside = covered_rows(torch, sp_attr.shape[0], starts, ends)
        outside_zero = bool((got[~inside] == 0).all()) and bool((ref[~inside] == 0).all())
        print(f"full {tw}x{th}: bwd kernel vs plain max|d d_attr|={err:.3g} (worst "
              f"{ratio:.3g} of the allowance); same bits twice {same_bits}; "
              f"{int((~inside).sum())} rows outside every trimmed range, all exactly 0: "
              f"{outside_zero}", flush=True)
        check(ratio <= 1.0, f"bwd kernel vs plain at {tw}x{th}")
        check(same_bits, f"bwd kernel gives the same bits twice at {tw}x{th}")
        check(outside_zero, f"bwd rows outside the trimmed ranges are 0 at {tw}x{th}")
        del again
        k_ms, p_ms = timed_in_turns(torch, lambda: rasterize_cuda.composite_bwd_cuda(*args),
                                    lambda: rasterize_cuda.composite_bwd_torch(*args))
        cfg = cfgs[(tw, th)][0]
        step(ts0, 0, cfg)  # warm-up
        step_ms = cuda_ms(lambda: step(ts0, 0, cfg), TRAIN_STEPS)
        bound = bwd_bound(torch, st, sp_attr, tile_ids, starts, ends, t_final, ncon)
        results[(tw, th)] = r = dict(
            shape=f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, {tw}x{th} tiles",
            launches=per_tile[(tw, th)]["composite_bwd"], max_abs_err=err,
            worst_share_of_tolerance=ratio, same_bits=same_bits, ms=mean(k_ms), ms_runs=k_ms, plain_ms=mean(p_ms),
            plain_ms_runs=p_ms, **bound, tiles=tile_ids.numel(), train_step_ms=step_ms)
        print(f"time {tw}x{th}: composite_bwd kernel {r['ms']:.3f} ms (runs {k_ms}), plain "
              f"{r['plain_ms']:.1f} ms (runs {p_ms}), train_step {step_ms:.3f} ms", flush=True)
        print_bound(f"composite_bwd {tw}x{th}", bound)
    for tw, th in TILES:
        print(f"where train_step's time goes at {tw}x{th}:", flush=True)
        profile(torch, "train_step", lambda: step(ts0, 0, cfgs[(tw, th)][0]), 1)
    return launches, results, captured, cam


def check_training(torch, ts, ts0, losses, steps, where) -> None:
    """The loss falls, every group moves, the densify stats count every step."""
    check(all(math.isfinite(v) for v in losses), f"finite losses at {where}")
    check(losses[-1] < losses[0], f"the loss falls over {steps} steps at {where}")
    for name, p in ts.state.params().items():
        check(not torch.equal(p, ts0.state.params()[name]), f"group {name} moved at {where}")
    check(float(ts.stats.denom.max()) == steps
          and bool(torch.isfinite(ts.stats.xyz_grad_accum).all())
          and float(ts.stats.xyz_grad_accum.max()) > 0, f"densify stats at {where}")


def tile_forms_on_bench(torch, fwd_captured, bwd_captured) -> tuple[dict, dict]:
    """B3 / B4 on the bench path's captured inputs, held against B1 / B2
    (both bitwise, B4 also at B2's tolerance) and timed with them in turns.
    Returns the B3 and B4 results by tile size."""
    from gs_tpu_torch.ops import rasterize_cuda as rc

    fwd_res, bwd_res = {}, {}
    for tw, th in TILES:
        shape = f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, {tw}x{th} tiles"
        args = fwd_captured[(tw, th)]
        same = all(torch.equal(a, b) for a, b in zip(rc.composite_fwd_tile_cuda(*args),
                                                        rc.composite_fwd_cuda(*args)))
        check(same, f"B3 equals B1 bitwise on the bench inputs at {tw}x{th}")
        k_ms, o_ms = timed_in_turns(torch, lambda: rc.composite_fwd_tile_cuda(*args),
                                    lambda: rc.composite_fwd_cuda(*args), other_reps=20)
        fwd_res[(tw, th)] = dict(shape=shape, launches=0, equal_to_composite_fwd=same,
                                 ms=mean(k_ms), ms_runs=k_ms, composite_fwd_ms=mean(o_ms),
                                 composite_fwd_ms_runs=o_ms)
        bargs = bwd_captured[(tw, th)]
        d4, d2 = rc.composite_bwd_tile_cuda(*bargs), rc.composite_bwd_cuda(*bargs)
        torch.cuda.synchronize()
        err, ratio = compare_bwd(d4, d2)
        bwd_same = torch.equal(d4, d2)
        check(ratio <= 1.0, f"B4 vs B2 on the bench inputs at {tw}x{th}")
        check(bwd_same, f"B4 equals B2 bitwise on the bench inputs at {tw}x{th}")
        del d4, d2
        k_ms, o_ms = timed_in_turns(torch, lambda: rc.composite_bwd_tile_cuda(*bargs),
                                    lambda: rc.composite_bwd_cuda(*bargs), other_reps=20)
        bwd_res[(tw, th)] = dict(shape=shape, launches=0, max_abs_err_vs_composite_bwd=err,
                                 worst_share_of_tolerance_vs_composite_bwd=ratio,
                                 equal_to_composite_bwd=bwd_same,
                                 ms=mean(k_ms), ms_runs=k_ms, composite_bwd_ms=mean(o_ms),
                                 composite_bwd_ms_runs=o_ms)
        print(f"bench {tw}x{th}: B3 {fwd_res[(tw, th)]['ms']:.3f} ms "
              f"vs B1 {fwd_res[(tw, th)]['composite_fwd_ms']:.3f} ms (bitwise equal {same}); "
              f"B4 {bwd_res[(tw, th)]['ms']:.3f} ms vs B2 {mean(o_ms):.3f} ms (bitwise equal "
              f"{bwd_same}; max|d|={err:.3g}, worst {ratio:.3g} of the allowance)", flush=True)
    return fwd_res, bwd_res


def segment_sums_bound(rows_read: int, n: int, k: int) -> dict:
    """B5's least time on these inputs: the rows it reads (those of the
    segments), seg_cum and the [n, k] sums written, at the memory rate."""
    bytes_moved = rows_read * k * 4 + n * 4 + n * k * 4
    return dict(bound_ms=bytes_moved / PEAK_BYTES * 1e3, bound_by="bytes", bytes=bytes_moved,
                rows_read=rows_read)


def expand_bound(n: int, k: int, total: int) -> dict:
    """B6's least time: offsets, ends and the [k, n] columns read, the
    [k, total] words written, at the memory rate."""
    bytes_moved = n * 8 + k * n * 4 + k * total * 4
    return dict(bound_ms=bytes_moved / PEAK_BYTES * 1e3, bound_by="bytes", bytes=bytes_moved)


def reduce_path(torch, label, shape, state, cam_t, bg, cfg, steps, form) -> dict:
    """B5's path: ``steps`` train_steps with GRAD_REDUCE="cuda" (counts
    reset just before, read just after: one B5 launch a step beside the
    compositing kernels of ``form``), the loss falling; one step's first
    Adam moments (0.1 x the gradients) against the default "scatter"
    step's from the same state; B5 against its plain version on the last
    step's sorted rows, twice for determinism; then B5, its plain version,
    the sort and permutation that feed it, the library call, the default
    reduction (autograd's backward of the gather) and train_step under both
    modes, timed in turns."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.ops import cuda_build, pairmove, rasterize_tiled

    opt = OptimizationParams()

    def step(ts, iteration, mode):
        with switches(grad_reduce=mode):
            return training.train_step(ts.state, ts.adam, ts.stats, cam_t, bg, iteration, 1.0,
                                       active_sh_degree=3, opt_cfg=opt, raster_cfg=cfg,
                                       accumulate_stats=True)

    ts0 = training.init_train_state(state, 1.0, 3)
    ts = training.init_train_state(state, 1.0, 3)
    losses, seg_calls, red_calls = [], [], []
    reset_launches()
    with capture_calls(pairmove, "segment_reduce_sorted", seg_calls), \
            capture_calls(rasterize_tiled, "reduce_pair_grads", red_calls):
        for i in range(steps):
            seg_calls.clear()  # keep the last step's inputs only
            red_calls.clear()
            ts.state, ts.adam, ts.stats, m = step(ts, i, "cuda")
            losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    print(f"{label} GRAD_REDUCE=cuda: losses {losses}; launches {launches}", flush=True)
    check_training(torch, ts, ts0, losses, steps, f"{label} GRAD_REDUCE=cuda")
    check(launches == launches_of(segment_reduce=steps, **{k: steps for k in form}),
          f"one B5 launch per train_step with {form} at {label}")
    del ts

    # one step's gradients under both reductions, from the same state
    mu_s = step(ts0, 0, "scatter")[1].mu
    mu_c = step(ts0, 0, "cuda")[1].mu
    grad_share = 0.0
    for name, b in mu_s.items():
        allowed = GRAD_RTOL * b.abs() + GRAD_ATOL_SHARE * b.abs().max()
        err = (mu_c[name] - b).abs()
        share = float((err / allowed.clamp(min=1e-30)).masked_fill(err == 0, 0.0).max())
        print(f"{label} gradient {name}: max|d mu|={float(err.max()):.3g} (worst {share:.3g} "
              f"of rtol {GRAD_RTOL} + {GRAD_ATOL_SHARE} x max)", flush=True)
        check(share <= 1.0, f"{label} {name} gradients, cuda vs scatter reduction")
        grad_share = max(grad_share, share)
    del mu_s, mu_c

    # B5 against its plain version on the last step's sorted rows
    rows, seg_cum, n = seg_calls[0]
    g, pair_gauss = red_calls[0][0], red_calls[0][1]
    counts = torch.diff(seg_cum.long(), prepend=seg_cum.new_zeros(1, dtype=torch.int64))
    got = pairmove.segment_reduce_sorted(rows, seg_cum, n)
    again = pairmove.segment_reduce_sorted(rows, seg_cum, n)
    ref = pairmove.segment_reduce_torch(rows, seg_cum, n)
    sabs = pairmove.segment_reduce_torch(rows.abs(), seg_cum, n)
    # bitwise against the CPU's plain version, whose index_add_ adds in row
    # order (the card's adds with atomics in no fixed order)
    ref_cpu = pairmove.segment_reduce_torch(rows.cpu(), seg_cum.cpu(), n)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    share = float((err / (SEGRED_TOL * sabs).clamp(min=1e-30)).masked_fill(err == 0, 0.0).max())
    same_bits = torch.equal(got, again)
    vs_cpu = segred_against_cpu(torch, got, ref_cpu, counts.cpu())
    bitwise = vs_cpu["equal_to_plain"]
    empty_zero = bool((got[counts == 0] == 0).all())
    rows_read = int(seg_cum[-1])
    longest = int(counts.max())
    print(f"{label}: B5 vs plain max|d|={float(err.max()):.3g} (worst {share:.3g} of "
          f"{SEGRED_TOL} x the segment's sum |rows|), bitwise equal {bitwise}; same bits "
          f"twice {same_bits}; "
          f"{int((counts == 0).sum())} zero-count Gaussians all 0: {empty_zero}; {rows_read} rows "
          f"of {rows.shape[0]} read; longest segment {longest} rows", flush=True)
    check(share <= 1.0, f"B5 vs plain at {label}")
    check(vs_cpu["row_order_equal"] and vs_cpu["long_within_one_rounding"],
          f"B5 matches its plain version on the CPU at {label} (bitwise on row-order "
          f"segments, one rounding on block-summed ones)")
    check(same_bits, f"B5 gives the same bits twice at {label}")
    check(empty_zero, f"B5 zero-count Gaussians are 0 at {label}")
    del got, again, ref, sabs, ref_cpu

    # times in turns
    k_ms, p_ms = timed_in_turns(torch, lambda: pairmove.segment_reduce_sorted(rows, seg_cum, n),
                                lambda: pairmove.segment_reduce_torch(rows, seg_cum, n),
                                other_reps=3)
    ids_sorted = torch.sort(pair_gauss, stable=True).values[:rows_read].long()
    zeros = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    lib_ms, _ = timed_in_turns(
        torch, lambda: torch.zeros_like(zeros).index_add_(0, ids_sorted, rows[:rows_read]),
        lambda: pairmove.segment_reduce_sorted(rows, seg_cum, n))
    sort_ms, _ = timed_in_turns(
        torch, lambda: g[torch.sort(pair_gauss, stable=True).indices],
        lambda: pairmove.segment_reduce_sorted(rows, seg_cum, n))
    attr_pad = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32, device=g.device,
                           requires_grad=True)
    gather_ms, _ = timed_in_turns(
        torch, lambda: torch.autograd.grad(attr_pad[pair_gauss], attr_pad, g),
        lambda: pairmove.segment_reduce_sorted(rows, seg_cum, n), kernel_reps=2)
    step_c, step_s = timed_in_turns(torch, lambda: step(ts0, 0, "cuda"),
                                    lambda: step(ts0, 0, "scatter"), kernel_reps=2,
                                    other_reps=2)
    bound = segment_sums_bound(rows_read, n, rows.shape[1])
    r = dict(shape=shape, launches=launches["segment_reduce"], losses=losses,
             max_abs_err=float(err.max()), worst_share_of_tolerance=share, same_bits=same_bits,
             equal_to_plain=bitwise,
             grad_worst_share_vs_scatter=grad_share, longest_segment=longest,
             zero_count_gaussians=int((counts == 0).sum()), pair_rows=rows.shape[0],
             ms=mean(k_ms), ms_runs=k_ms, plain_ms=mean(p_ms), plain_ms_runs=p_ms,
             library_ms=mean(lib_ms), library_ms_runs=lib_ms, sort_permute_ms=mean(sort_ms),
             gather_backward_ms=mean(gather_ms), gather_backward_ms_runs=gather_ms,
             train_step_cuda_ms=mean(step_c), train_step_cuda_ms_runs=step_c,
             train_step_scatter_ms=mean(step_s), train_step_scatter_ms_runs=step_s, **bound)
    print(f"time {label}: B5 {r['ms']:.4f} ms (runs {k_ms}, bound {bound['bound_ms']:.4f} ms, "
          f"bytes), plain {r['plain_ms']:.3f} ms, index_add_ {r['library_ms']:.4f} ms; sort + "
          f"permutation {r['sort_permute_ms']:.4f} ms; autograd gather backward "
          f"{r['gather_backward_ms']:.3f} ms (runs {gather_ms}); train_step cuda "
          f"{r['train_step_cuda_ms']:.3f} ms (runs {step_c}) vs scatter "
          f"{r['train_step_scatter_ms']:.3f} ms (runs {step_s})", flush=True)
    print(f"where the GRAD_REDUCE=cuda train_step's time goes at {label}:", flush=True)
    profile(torch, "train_step", lambda: step(ts0, 0, "cuda"), 1)
    return r


def segment_edge_layouts(rng) -> dict:
    """B5's block-window edge layouts (256 Gaussians a block, windows staged
    in pieces of 512 rows, segments over 512 rows summed by the block):
    name -> (per-Gaussian row counts, rows cut off the end by num_rows)."""
    def counts(n, top):
        return rng.integers(0, top, size=n)

    edges = counts(1000, 12)  # n not a multiple of 256
    edges[[0, 255, 256, 511, 512, 767, 768, 999]] = 0  # empty at every block boundary
    empty_block = counts(800, 12)
    empty_block[256:512] = 0  # a block whose whole window is empty
    long_one = counts(5000, 20)
    long_one[2600] = 100_000  # one segment far longer than a staged piece
    every_16th = counts(20_000, 20)
    every_16th[::16] = rng.integers(500, 1500, size=every_16th[::16].size)  # ~1,000 rows
    cut = counts(777, 20)
    cut[-1] = 40
    return {"block_edge_empties": (edges, 0), "empty_block": (empty_block, 0),
            "segment_of_100000": (long_one, 0), "every_16th_of_1000": (every_16th, 0),
            "num_rows_cuts_last": (cut, 17)}


def segred_against_cpu(torch, got, ref_cpu, counts) -> dict:
    """B5's sums against the plain version's on the CPU (float64 in row
    order, rounded once): bitwise on the segments B5 sums in row order, at
    most one float rounding apart on the longer ones, which it sums in a
    fixed block order."""
    got = got.cpu()
    long_rows = torch.as_tensor(counts, device="cpu") > SEGRED_ROW_ORDER_MAX
    near = (got == ref_cpu) | (got == torch.nextafter(ref_cpu, got))
    return dict(equal_to_plain=torch.equal(got, ref_cpu),
                row_order_equal=torch.equal(got[~long_rows], ref_cpu[~long_rows]),
                long_within_one_rounding=bool(near[long_rows].all()),
                long_sums_one_rounding_apart=int((got != ref_cpu)[long_rows].sum()))


def segment_reduce_edges(torch, dev) -> dict:
    """B5 against its plain version on its edge layouts: the plain version
    on the CPU (bitwise on row-order segments, one rounding on the block's
    long ones; see ``segred_against_cpu``), the same bits twice, finite
    although every row past what it may read (past the last segment, or
    past num_rows) is NaN; the cut layout against the plain version of the
    rows that exist. Each layout is timed beside ``index_add_``."""
    from gs_tpu_torch.ops import pairmove

    rng = np.random.default_rng(5)
    results = {}
    for name, (counts, cut) in segment_edge_layouts(rng).items():
        seg_cum_np = np.cumsum(counts).astype(np.int32)
        seg_cum = torch.from_numpy(seg_cum_np).to(dev)
        num_rows = int(counts.sum()) - cut
        vals = rng.normal(size=(num_rows, 9)) * 10.0 ** rng.integers(-3, 3, size=(num_rows, 1))
        vals = torch.from_numpy(vals.astype(np.float32))
        full = torch.full((num_rows + cut + 64, 9), float("nan"), device=dev)
        full[:num_rows] = vals.to(dev)
        rows, n = full[:num_rows], counts.size
        got = pairmove.segment_reduce_sorted(rows, seg_cum, n)
        again = pairmove.segment_reduce_sorted(rows, seg_cum, n)
        ref_cpu = pairmove.segment_reduce_torch(
            vals, torch.from_numpy(np.minimum(seg_cum_np, num_rows)), n)
        sabs = pairmove.segment_reduce_torch(
            vals.abs(), torch.from_numpy(np.minimum(seg_cum_np, num_rows)), n)
        torch.cuda.synchronize()
        err = (got.cpu() - ref_cpu).abs()
        share = float((err / (SEGRED_TOL * sabs).clamp(min=1e-30))
                      .masked_fill(err == 0, 0.0).max())
        r = dict(n=n, rows=num_rows, longest_segment=int(counts.max()),
                 block_summed_segments=int((counts > SEGRED_ROW_ORDER_MAX).sum()),
                 empty_segments=int((counts == 0).sum()),
                 **segred_against_cpu(torch, got, ref_cpu, counts),
                 worst_share_of_tolerance=share, same_bits=torch.equal(got, again),
                 finite=bool(torch.isfinite(got).all()))
        ids = torch.repeat_interleave(torch.arange(n, device=dev),
                                      torch.from_numpy(counts).to(dev))[:num_rows]
        k_ms, lib_ms = timed_in_turns(
            torch, lambda: pairmove.segment_reduce_sorted(rows, seg_cum, n),
            lambda: torch.zeros((n, 9), device=dev).index_add_(0, ids, rows), other_reps=20)
        r.update(ms=mean(k_ms), ms_runs=k_ms, library_ms=mean(lib_ms),
                 **segment_sums_bound(num_rows, n, 9))
        print(f"B5 edge layout {name}: {r}", flush=True)
        check(r["row_order_equal"] and r["long_within_one_rounding"] and share <= 1.0
              and r["same_bits"] and r["finite"],
              f"B5 matches its plain version, twice, on the edge layout {name}")
        results[name] = r
    return results


def expand_path(torch, label, shape, state, cam, cam_t, bg, cfg, form) -> dict:
    """B6's path: one eval_render and one train_step with EXPAND_IMPL="cuda"
    (counts reset just before and read just after each: one B6 launch
    beside the compositing kernels of ``form``); the render equal to the
    default render bitwise; every binning integer of the render's call
    equal to the default path's; B6 equal to its plain version bitwise;
    B6, its plain version, the library call and binning's step 2 on both
    paths timed in turns."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.ops import binning, cuda_build, pairmove

    bin_calls, exp_calls, step2_calls = [], [], []
    reset_launches()
    with switches(expand_impl="cuda"), capture_calls(binning, "bin_gaussians_aligned", bin_calls), \
            capture_calls(pairmove, "expand_intervals", exp_calls), \
            capture_calls(binning, "expand_owner_fields", step2_calls):
        img = training.eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=cfg)
        torch.cuda.synchronize()
        render_launches = dict(cuda_build.LAUNCHES)
        reset_launches()
        ts = training.init_train_state(state, 1.0, 3)
        m = training.train_step(ts.state, ts.adam, ts.stats, cam_t, bg, 0, 1.0,
                                active_sh_degree=3, opt_cfg=OptimizationParams(),
                                raster_cfg=cfg, accumulate_stats=True)[3]
        torch.cuda.synchronize()
        train_launches = dict(cuda_build.LAUNCHES)
    del ts
    print(f"{label} EXPAND_IMPL=cuda: render launches {render_launches}; train_step launches "
          f"{train_launches}, loss {float(m['loss']):.6f}", flush=True)
    check(render_launches == launches_of(expand_intervals=1, **{form[0]: 1}),
          f"one B6 launch per render at {label}")
    check(train_launches == launches_of(expand_intervals=1, **{k: 1 for k in form}),
          f"one B6 launch per train_step at {label}")
    check(math.isfinite(float(m["loss"])), f"finite loss through B6 at {label}")
    default_img = training.eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=cfg)
    same_img = torch.equal(img, default_img)
    del img, default_img

    # every binning integer of the render's call, both paths
    args = bin_calls[0]
    got = binning.bin_gaussians_aligned(*args, count_by_gauss=True, expand_impl="cuda")
    want = binning.bin_gaussians_aligned(*args, count_by_gauss=True, expand_impl="scatter")
    fields = [f for f in got._fields if not torch.equal(getattr(got, f), getattr(want, f))]
    del got, want
    # B6 against its plain version
    offsets, ends, cols, total = exp_calls[0]
    b6 = pairmove.expand_intervals(offsets, ends, cols, total)
    plain = pairmove.expand_intervals_torch(offsets, ends, cols, total)
    same_b6 = torch.equal(b6, plain)
    b6_err = float((b6.double() - plain.double()).abs().max())
    torch.cuda.synchronize()
    covered = int((ends.long() - offsets.long()).sum())
    print(f"{label}: render through B6 equal to the default bitwise {same_img}; binning "
          f"fields that differ {fields}; B6 equal to plain bitwise {same_b6}; {offsets.shape[0]} "
          f"intervals, {covered} of {total} slots owned", flush=True)
    check(same_img, f"the render through B6 equals the default render at {label}")
    check(not fields, f"binning integers through B6 equal the default path's at {label}")
    check(same_b6, f"B6 equals its plain version bitwise at {label}")
    del b6, plain

    k_ms, p_ms = timed_in_turns(torch, lambda: pairmove.expand_intervals(offsets, ends, cols, total),
                                lambda: pairmove.expand_intervals_torch(offsets, ends, cols, total),
                                other_reps=20)
    lengths = (ends - offsets).long()
    lib_ms, _ = timed_in_turns(
        torch, lambda: torch.repeat_interleave(cols, lengths, dim=1, output_size=covered),
        lambda: pairmove.expand_intervals(offsets, ends, cols, total))
    step2 = step2_calls[0]
    s2_cuda, s2_default = timed_in_turns(torch, lambda: binning.expand_owner_fields(*step2),
                                         lambda: binning.repeat_owner_fields(*step2),
                                         kernel_reps=10, other_reps=10)
    bound = expand_bound(offsets.shape[0], cols.shape[0], total)
    r = dict(shape=shape, launches=render_launches["expand_intervals"]
             + train_launches["expand_intervals"], max_abs_err=b6_err, equal_to_plain=same_b6,
             render_equal_to_default=same_img, intervals=offsets.shape[0], slots=total,
             slots_owned=covered, ms=mean(k_ms), ms_runs=k_ms, plain_ms=mean(p_ms),
             plain_ms_runs=p_ms, library_ms=mean(lib_ms), library_ms_runs=lib_ms,
             step2_cuda_ms=mean(s2_cuda), step2_cuda_ms_runs=s2_cuda,
             step2_default_ms=mean(s2_default), step2_default_ms_runs=s2_default, **bound)
    print(f"time {label}: B6 {r['ms']:.4f} ms (runs {k_ms}, bound {bound['bound_ms']:.4f} ms, "
          f"bytes), plain {r['plain_ms']:.3f} ms, repeat_interleave {r['library_ms']:.4f} ms; "
          f"binning step 2 through B6 {r['step2_cuda_ms']:.3f} ms vs repeat_interleave + "
          f"gathers {r['step2_default_ms']:.3f} ms", flush=True)
    return r


def make_heavy_state(dev, seed: int):
    """bench.py's heavy scene (bench.py:64-81, heavy=True) made from
    ``default_rng(seed)``, draw for draw."""
    import torch

    from gs_tpu_torch.models import gaussians

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(N_HEAVY, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(N_HEAVY, 3)).astype(np.float32)
    state = gaussians.create_from_pcd(pts, cols, max_sh_degree=3, capacity=N_HEAVY, device=dev)
    log_scale = rng.uniform(-5.5, -2.0, size=(N_HEAVY, 3)).astype(np.float32)
    logit_opacity = rng.uniform(-1.5, 2.5, size=(N_HEAVY, 1)).astype(np.float32)
    return state.replace(log_scale=torch.from_numpy(log_scale).to(dev),
                         logit_opacity=torch.from_numpy(logit_opacity).to(dev))


def heavy_phase(torch, dev, cam, bg) -> dict:
    """The heavy scene at 48x32 tiles through the tile-walk kernels: render
    and train paths with counts reset just before and read just after, B3 /
    B4 against B1 / B2 and their plain versions on the inputs those runs
    gave them, times, bounds and a profile."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams, RasterizeConfig
    from gs_tpu_torch.ops import rasterize_cuda as rc
    from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget, pick_kernel_mode
    from gs_tpu_torch.renderer import render

    torch.cuda.reset_peak_memory_stats()
    tw, th = HEAVY_TILE
    label = f"heavy {tw}x{th}"
    shape = f"{WIDTH}x{HEIGHT}, {N_HEAVY} Gaussians (bench.py heavy scene), {tw}x{th} tiles"
    t0 = time.perf_counter()
    state = make_heavy_state(dev, 0)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    cfg = RasterizeConfig(tile_w=tw, tile_h=th)
    num_pairs = int(render(cam, state, active_sh_degree=3, bg_color=bg, cfg=cfg).num_pairs)
    grown = dataclasses.replace(cfg, pair_budget_factor=1.05 * num_pairs / N_HEAVY)
    budget = current_pair_budget(grown, N_HEAVY)
    num_tiles = -(-WIDTH // tw) * -(-HEIGHT // th)
    check(num_pairs <= budget, "grown budget holds every heavy pair")
    print(f"heavy scene: {N_HEAVY} Gaussians made in {made_s:.2f} s; pairs {tw}x{th}: "
          f"num_pairs={num_pairs} default budget={current_pair_budget(cfg, N_HEAVY)} grown "
          f"budget={budget}; {num_tiles} tiles; kernel form "
          f"{pick_kernel_mode(grown.backend, budget, grown.chunk, num_tiles)}", flush=True)

    # the render path
    calls = []
    reset_launches()
    with capture_composite(calls):
        img = training.eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=grown)
    torch.cuda.synchronize()
    render_launches = dict(rc.LAUNCHES)
    print(f"heavy render path launches: {render_launches}", flush=True)
    st = calls[0][0]
    check(st.kernel_mode == "tile", "the heavy scene takes the tile-walk form")
    check(render_launches == launches_of(composite_fwd_tile=1),
          "the heavy render launches composite_fwd_tile once and nothing else")
    check(img.shape == (3, HEIGHT, WIDTH) and bool(torch.isfinite(img).all()),
          "finite heavy image")
    print(f"heavy image: mean {float(img.mean()):.6f}, covered share "
          f"{float((img.sum(0) > 0).float().mean()):.4f}", flush=True)
    fwd_args = calls[0]

    # the training path
    target = training.eval_render(make_heavy_state(dev, 1), cam, bg, active_sh_degree=3,
                                   raster_cfg=grown)
    cam_t = dataclasses.replace(cam, image=target)
    opt = OptimizationParams()
    ts0 = training.init_train_state(state, 1.0, 3)

    def step(ts, iteration):
        return training.train_step(ts.state, ts.adam, ts.stats, cam_t, bg, iteration, 1.0,
                                   active_sh_degree=3, opt_cfg=opt, raster_cfg=grown,
                                   accumulate_stats=True)

    ts = training.init_train_state(state, 1.0, 3)
    losses, bwd_calls, step_s = [], [], []
    reset_launches()
    with capture_composite_bwd(bwd_calls, "composite_bwd_tile_cuda"):
        for i in range(HEAVY_TRAIN_STEPS):
            bwd_calls.clear()  # keep the last step's inputs only
            t1 = time.perf_counter()
            ts.state, ts.adam, ts.stats, m = step(ts, i)
            losses.append(float(m["loss"]))
            step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    train_launches = dict(rc.LAUNCHES)
    print(f"heavy train: losses {losses}; step wall {step_s} s; launches {train_launches}",
          flush=True)
    check_training(torch, ts, ts0, losses, HEAVY_TRAIN_STEPS, label)
    check(train_launches == launches_of(composite_fwd_tile=HEAVY_TRAIN_STEPS,
                                        composite_bwd_tile=HEAVY_TRAIN_STEPS),
          "one fwd-tile and one bwd-tile launch per heavy train_step, no chunk-grid kernel")
    bwd_args = bwd_calls[0]
    del ts, target

    # B3 against B1 (bitwise) and against its plain version
    b3 = rc.composite_fwd_tile_cuda(*fwd_args)
    b1 = rc.composite_fwd_cuda(*fwd_args)
    ref = rc.composite_fwd_torch(*fwd_args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(b3, b1))
    c_err, t_err, mism = compare(b3, ref)
    pixels = ref[1].numel()
    st, sp_attr, tile_ids, starts, ends = fwd_args
    print(f"{label}: B3 vs B1 bitwise equal {same}; B3 vs plain max|d color|={c_err:.3g} "
          f"max|d T|={t_err:.3g} ncon mismatches={mism} of {pixels} pixels", flush=True)
    ranges = {"forward": range_distribution(torch, starts, ends),
              "trimmed": range_distribution(torch, bwd_args[3], bwd_args[4])}
    for kind, r in ranges.items():
        print(f"{label} {kind} ranges: {r['tiles']} tiles, pairs a tile min {r['min']} / "
              f"median {r['median']} / p99 {r['p99']} / max {r['max']}, mean {r['mean']:.1f}; "
              f"the longest {r['max_over_mean']:.3f}x the mean", flush=True)
    check(same, "B3 equals B1 bitwise on the heavy frame")
    check(c_err <= TOL_COLOR and t_err <= TOL_T and mism <= TOL_NCON_SHARE * pixels,
          "B3 vs plain on the heavy frame")
    k_ms, b1_ms = timed_in_turns(torch, lambda: rc.composite_fwd_tile_cuda(*fwd_args),
                                 lambda: rc.composite_fwd_cuda(*fwd_args), other_reps=20)
    k2_ms, p_ms = timed_in_turns(torch, lambda: rc.composite_fwd_tile_cuda(*fwd_args),
                                 lambda: rc.composite_fwd_torch(*fwd_args))
    fbound = fwd_bound(torch, *fwd_args, ref[2])
    render_ms = cuda_ms(lambda: training.eval_render(state, cam, bg, active_sh_degree=3,
                                                     raster_cfg=grown), 3)
    fwd = dict(shape=shape, launches=render_launches["composite_fwd_tile"],
               launches_train_path=train_launches["composite_fwd_tile"], max_abs_err=c_err,
               t_max_abs_err=t_err, ncon_mismatches=mism, equal_to_composite_fwd=same,
               ms=mean(k_ms + k2_ms), ms_runs=k_ms + k2_ms, composite_fwd_ms=mean(b1_ms),
               composite_fwd_ms_runs=b1_ms, plain_ms=mean(p_ms), plain_ms_runs=p_ms, **fbound,
               num_pairs=num_pairs, pair_budget=budget, tiles=tile_ids.numel(),
               render_ms=render_ms, ranges=ranges)
    print(f"time {label}: composite_fwd_tile {fwd['ms']:.3f} ms (runs {fwd['ms_runs']}), "
          f"composite_fwd {fwd['composite_fwd_ms']:.3f} ms (runs {b1_ms}), plain "
          f"{fwd['plain_ms']:.1f} ms (runs {p_ms}); eval_render {render_ms:.3f} ms", flush=True)
    print_bound(f"composite_fwd_tile {label}", fbound)
    del b3, b1, ref

    # B4 against B2 and against its plain version
    st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term = bwd_args
    d4 = rc.composite_bwd_tile_cuda(*bwd_args)
    d4_again = rc.composite_bwd_tile_cuda(*bwd_args)
    d2 = rc.composite_bwd_cuda(*bwd_args)
    ref = rc.composite_bwd_torch(*bwd_args)
    torch.cuda.synchronize()
    same42 = torch.equal(d4, d2)
    same_bits = torch.equal(d4, d4_again)
    del d4_again
    err42, ratio42 = compare_bwd(d4, d2)
    err, ratio = compare_bwd(d4, ref)
    inside = covered_rows(torch, sp_attr.shape[0], starts, ends)
    outside_zero = bool((d4[~inside] == 0).all()) and bool((ref[~inside] == 0).all())
    lengths = ends.long() - starts.long()
    print(f"{label}: B4 vs B2 bitwise equal {same42}, max|d d_attr|={err42:.3g} (worst "
          f"{ratio42:.3g} of the allowance); same bits twice {same_bits}; B4 vs plain max|d d_attr|={err:.3g} (worst {ratio:.3g} of the "
          f"allowance); {int((~inside).sum())} rows outside every trimmed range, all exactly "
          f"0: {outside_zero}; trimmed ranges {int(lengths.min())}-{int(lengths.max())} "
          f"pairs", flush=True)
    check(ratio42 <= 1.0, "B4 vs B2 on the heavy frame")
    check(same42, "B4 equals B2 bitwise on the heavy frame")
    check(same_bits, "B4 gives the same bits twice on the heavy frame")
    check(ratio <= 1.0, "B4 vs plain on the heavy frame")
    check(outside_zero, "B4 rows outside the heavy trimmed ranges are 0")
    del d4, d2, ref
    k_ms, b2_ms = timed_in_turns(torch, lambda: rc.composite_bwd_tile_cuda(*bwd_args),
                                 lambda: rc.composite_bwd_cuda(*bwd_args), other_reps=20)
    k2_ms, p_ms = timed_in_turns(torch, lambda: rc.composite_bwd_tile_cuda(*bwd_args),
                                 lambda: rc.composite_bwd_torch(*bwd_args))
    bbound = bwd_bound(torch, st, sp_attr, tile_ids, starts, ends, t_final, ncon)
    step(ts0, 0)  # warm-up
    step_ms = cuda_ms(lambda: step(ts0, 0), 2)
    bwd = dict(shape=shape, launches=train_launches["composite_bwd_tile"], max_abs_err=err,
               worst_share_of_tolerance=ratio, max_abs_err_vs_composite_bwd=err42,
               worst_share_of_tolerance_vs_composite_bwd=ratio42,
               equal_to_composite_bwd=same42, same_bits=same_bits, ms=mean(k_ms + k2_ms),
               ms_runs=k_ms + k2_ms, composite_bwd_ms=mean(b2_ms), composite_bwd_ms_runs=b2_ms,
               plain_ms=mean(p_ms), plain_ms_runs=p_ms, **bbound, tiles=tile_ids.numel(),
               train_step_ms=step_ms, losses=losses, train_step_wall_s=step_s)
    print(f"time {label}: composite_bwd_tile {bwd['ms']:.3f} ms (runs {bwd['ms_runs']}), "
          f"composite_bwd {bwd['composite_bwd_ms']:.3f} ms (runs {b2_ms}), plain "
          f"{bwd['plain_ms']:.1f} ms (runs {p_ms}); train_step {step_ms:.3f} ms", flush=True)
    print_bound(f"composite_bwd_tile {label}", bbound)
    print(f"where the heavy train_step's time goes:", flush=True)
    profile(torch, "heavy train_step", lambda: step(ts0, 0), 1)

    # B5 and B6 on the heavy scene, then one step with both switches on
    tile_form = ("composite_fwd_tile", "composite_bwd_tile")
    reduce = reduce_path(torch, label, shape, state, cam_t, bg, grown, HEAVY_REDUCE_STEPS,
                         tile_form)
    expand = expand_path(torch, label, shape, state, cam, cam_t, bg, grown, tile_form)
    reset_launches()
    with switches(grad_reduce="cuda", expand_impl="cuda"):
        m = step(ts0, 0)[3]
    torch.cuda.synchronize()
    both = dict(rc.LAUNCHES)
    print(f"{label} with both switches on: loss {float(m['loss']):.6f}, launches {both}",
          flush=True)
    check(both == launches_of(segment_reduce=1, expand_intervals=1, **{k: 1 for k in tile_form}),
          "one heavy train_step with both switches launches B3, B4, B5 and B6 once each")
    check(math.isfinite(float(m["loss"])), "finite heavy loss with both switches on")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"heavy phase peak device memory {peak:.2f} GiB", flush=True)
    return dict(fwd=fwd, bwd=bwd, peak_gib=peak, reduce=reduce, expand=expand,
                both_switches_launches=both)


def recovery_phase(torch, dev) -> dict:
    """run_training through synthetic.recover at benchmarks/synthetic_e2e.py's
    defaults, counts reset just before and read just after."""
    from gs_tpu_torch import synthetic
    from gs_tpu_torch.ops import rasterize_cuda

    reset_launches()
    info = {}
    t0 = time.perf_counter()
    iters = 2000
    psnr, state = synthetic.recover(iters=iters, res=256, gt_gaussians=4096, init_points=2048,
                                    views=64, device=dev, verbose=True, info=info)
    wall = time.perf_counter() - t0
    launches = dict(rasterize_cuda.LAUNCHES)
    print(f"recovery: test PSNR {psnr:.3f} dB (min {RECOVERY_PSNR_MIN}), per view "
          f"{info['psnrs']}; alive {info['alive']} of capacity {state.capacity}; training "
          f"{info['train_s']:.2f} s ({iters / info['train_s']:.1f} it/s), phase wall "
          f"{wall:.2f} s; launches {launches}", flush=True)
    check(math.isfinite(psnr) and psnr > RECOVERY_PSNR_MIN, "recovery PSNR")
    check(launches["composite_fwd"] > 0 and launches["composite_bwd"] > 0,
          "both chunk-grid kernels launched by run_training")
    check(launches["composite_fwd_tile"] == 0 and launches["composite_bwd_tile"] == 0,
          "no tile-walk kernel launched by run_training")
    check(launches["segment_reduce"] == 0 and launches["expand_intervals"] == 0,
          "no pair-movement kernel launched by run_training at the default switches")
    return dict(psnr=psnr, train_s=info["train_s"], it_per_s=iters / info["train_s"],
                alive=info["alive"], capacity=state.capacity, launches=launches)


def kernel_entry(name, source, replaces, launches, main_path, paths, extra,
                 library_ms=None) -> dict:
    """One kernel of the kernels line: ``paths`` holds its results by path,
    ``main_path`` names the one whose ms, plain ms and bound lead the line;
    max_abs_err is the worst error against the plain version on any path;
    ``library_ms`` the time of one PyTorch call computing the same function
    on the main path's inputs (None where there is none)."""
    main_r = paths[main_path]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in paths.values() if "max_abs_err" in r),
        "ms": main_r["ms"],
        "plain_ms": main_r["plain_ms"],
        "bound_ms": main_r["bound_ms"],
        "bound_by": main_r["bound_by"],
        "library_ms": library_ms,
        "main_path": main_path,
        "shape": main_r["shape"],
        "per_path": paths,
        **extra,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget
    from gs_tpu_torch.renderer import render

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. the card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"device: {name}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    libs = cuda_build.build()
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for kname, so in libs.items():
        info = cuda_build.BUILD_INFO[kname]
        print(f"  {os.path.relpath(so, ROOT)} from "
              f"{os.path.relpath(cuda_build.SOURCES[kname], ROOT)}"
              + (f", nvcc {info['seconds']:.1f} s" if "seconds" in info else ""), flush=True)
        for line in info["ptxas"].splitlines():
            if "Used" in line or "Compiling entry" in line or "spill" in line:
                print("    ptxas:", line.strip(), flush=True)
    for kname in NO_STACK_FRAME:
        frames = [line.strip() for line in cuda_build.BUILD_INFO[kname]["ptxas"].splitlines()
                  if "bytes stack frame" in line]
        check(bool(frames) and all(f.startswith("0 bytes stack frame") for f in frames),
              f"ptxas reports no stack frame for {kname}")

    # 3. the chunk-grid kernels, the render and its gradients on the golden bundle
    golden_phase(torch, dev)

    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as workdir:
        state, cam = bench_scene(torch, dev, workdir)
    bg = torch.zeros(3, device=dev)

    # pair budgets: the default truncates this scene, so grow it
    cfgs = {}
    for tw, th in TILES:
        cfg = RasterizeConfig(tile_w=tw, tile_h=th)
        probe = render(cam, state, active_sh_degree=3, bg_color=bg, cfg=cfg)
        num_pairs = int(probe.num_pairs)
        grown = dataclasses.replace(cfg, pair_budget_factor=1.05 * num_pairs / N_GAUSS)
        budget = current_pair_budget(grown, N_GAUSS)
        check(num_pairs <= budget, "grown budget holds every pair")
        print(f"pairs {tw}x{th}: num_pairs={num_pairs} default budget="
              f"{current_pair_budget(cfg, N_GAUSS)} grown budget={budget}", flush=True)
        cfgs[(tw, th)] = (grown, num_pairs, budget)
    torch.cuda.synchronize()

    # 4. the render path
    render_launches, fwd_results, fwd_captured = render_phase(torch, state, cam, bg, cfgs)
    # 5. the training path
    train_launches, bwd_results, bwd_captured, cam_t = train_phase(torch, dev, state, cam, bg,
                                                                   cfgs)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    # 6. the tile-walk kernels on the bench inputs, against the chunk-grid ones
    fwd_tile_bench, bwd_tile_bench = tile_forms_on_bench(torch, fwd_captured, bwd_captured)
    del fwd_captured, bwd_captured
    # 7. B5 (GRAD_REDUCE="cuda") and B6 (EXPAND_IMPL="cuda") on the bench scene
    reduce_paths, expand_paths = {}, {}
    for tw, th in TILES:
        label = f"bench {tw}x{th}"
        shape = f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, {tw}x{th} tiles"
        chunk_form = ("composite_fwd", "composite_bwd")
        reduce_paths[label] = reduce_path(torch, label, shape, state, cam_t, bg,
                                          cfgs[(tw, th)][0], REDUCE_STEPS, chunk_form)
        expand_paths[label] = expand_path(torch, label, shape, state, cam, cam_t, bg,
                                          cfgs[(tw, th)][0], chunk_form)
    segment_edges = segment_reduce_edges(torch, dev)
    del state, cam_t
    # 8. the heavy scene through the tile-walk kernels, and B5 / B6 on it
    heavy = heavy_phase(torch, dev, cam, bg)
    # 9. run_training on the synthetic recovery scene
    recovery = recovery_phase(torch, dev)

    def keyed(results):
        return {f"bench {tw}x{th}": r for (tw, th), r in results.items()}

    heavy_label = f"heavy {HEAVY_TILE[0]}x{HEAVY_TILE[1]}"

    b1_paths = keyed(fwd_results)
    b1_paths[heavy_label] = dict(shape=heavy["fwd"]["shape"], launches=0,
                                 ms=heavy["fwd"]["composite_fwd_ms"],
                                 ms_runs=heavy["fwd"]["composite_fwd_ms_runs"])
    b2_paths = keyed(bwd_results)
    b2_paths[heavy_label] = dict(shape=heavy["bwd"]["shape"], launches=0,
                                 ms=heavy["bwd"]["composite_bwd_ms"],
                                 ms_runs=heavy["bwd"]["composite_bwd_ms_runs"])
    main_label = f"bench {TILES[0][0]}x{TILES[0][1]}"
    kernels = [
        kernel_entry("composite_fwd", "gs_tpu_torch/csrc/composite_fwd.cu",
                     "gs_tpu/ops/rasterize_pallas.py:937", render_launches["composite_fwd"],
                     main_label, b1_paths,
                     {"launches_train_path": train_launches["composite_fwd"]}),
        kernel_entry("composite_bwd", "gs_tpu_torch/csrc/composite_bwd.cu",
                     "gs_tpu/ops/rasterize_pallas.py:1034", train_launches["composite_bwd"],
                     main_label, b2_paths,
                     {"recovery": recovery}),
        kernel_entry("composite_fwd_tile", "gs_tpu_torch/csrc/composite_fwd_tile.cu",
                     "gs_tpu/ops/rasterize_pallas.py:645", heavy["fwd"]["launches"],
                     heavy_label, {heavy_label: heavy["fwd"], **keyed(fwd_tile_bench)},
                     {"launches_train_path": heavy["fwd"]["launches_train_path"]}),
        kernel_entry("composite_bwd_tile", "gs_tpu_torch/csrc/composite_bwd_tile.cu",
                     "gs_tpu/ops/rasterize_pallas.py:777", heavy["bwd"]["launches"],
                     heavy_label, {heavy_label: heavy["bwd"], **keyed(bwd_tile_bench)},
                     {"heavy_peak_gib": heavy["peak_gib"]}),
        kernel_entry("segment_reduce", "gs_tpu_torch/csrc/segment_reduce.cu",
                     "gs_tpu/ops/pairmove.py:63",
                     sum(r["launches"] for r in reduce_paths.values()), main_label,
                     {**reduce_paths, heavy_label: heavy["reduce"]},
                     {"launches_heavy_path": heavy["reduce"]["launches"],
                      "both_switches_launches": heavy["both_switches_launches"],
                      "edge_layouts": segment_edges},
                     library_ms=reduce_paths[main_label]["library_ms"]),
        kernel_entry("expand_intervals", "gs_tpu_torch/csrc/expand_intervals.cu",
                     "gs_tpu/ops/pairmove.py:254",
                     sum(r["launches"] for r in expand_paths.values()), main_label,
                     {**expand_paths, heavy_label: heavy["expand"]},
                     {"launches_heavy_path": heavy["expand"]["launches"]},
                     library_ms=expand_paths[main_label]["library_ms"]),
    ]
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
