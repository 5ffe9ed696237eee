#!/usr/bin/env python3
"""On-card smoke run of the gs_tpu_torch port (one NVIDIA GPU).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc:

1. prints the card (name, count, ``nvidia-smi`` name and power limit);
2. builds the compositing kernels from ``gs_tpu_torch/csrc``, one nvcc per
   source, all at once (nvcc's register / shared-memory report is printed);
3. on the golden bundle (``tests/golden/raster_golden.npz``): holds the
   forward and backward kernels against their plain PyTorch versions, and
   the card's render and ``rasterize_tiled`` gradients against the
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
   kernel, plain version and train_step are timed and profiled;
6. runs ``synthetic.recover`` (``run_training`` with densify, prune,
   opacity reset and capacity / pair-budget growth) at
   benchmarks/synthetic_e2e.py's defaults and checks the test PSNR.

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
RECOVERY_PSNR_MIN = 30.0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def covered_rows(torch, b, starts, ends):
    """[B] bool: rows inside some tile's [start, end)."""
    delta = torch.zeros(b + 1, dtype=torch.int32, device=starts.device)
    delta.index_add_(0, starts.long(), torch.ones_like(starts))
    delta.index_add_(0, ends.long(), -torch.ones_like(ends))
    return torch.cumsum(delta, 0)[:b] > 0


@contextlib.contextmanager
def capture_composite(store: list):
    """Record the arguments rasterize_tiled hands to composite_tiles."""
    from gs_tpu_torch.ops import rasterize_tiled

    original = rasterize_tiled.composite_tiles

    def recording(st, sp_attr, tile_ids, starts, ends):
        store.append((st, sp_attr, tile_ids, starts, ends))
        return original(st, sp_attr, tile_ids, starts, ends)

    rasterize_tiled.composite_tiles = recording
    try:
        yield store
    finally:
        rasterize_tiled.composite_tiles = original


@contextlib.contextmanager
def capture_composite_bwd(store: list):
    """Record the arguments the compositing backward hands to the kernel's
    wrapper (ends already trimmed)."""
    from gs_tpu_torch.ops import rasterize_tiled

    original = rasterize_tiled.composite_bwd_cuda

    def recording(*args):
        store.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args))
        return original(*args)

    rasterize_tiled.composite_bwd_cuda = recording
    try:
        yield store
    finally:
        rasterize_tiled.composite_bwd_cuda = original


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
    the port; the card's tiled render and its gradients vs the bundle's
    float64 image and gradients."""
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.ops import rasterize_cuda
    from gs_tpu_torch.ops.rasterize_tiled import rasterize_tiled

    g = np.load(GOLDEN)
    h, w = int(g["height"]), int(g["width"])
    bg = torch.from_numpy(g["bg"]).to(dev)
    for tw, th in TILES:
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
        d_ref = rasterize_cuda.composite_bwd_torch(*bwd_calls[0])
        torch.cuda.synchronize()
        c_err, t_err, mism = compare(got, ref)
        d_err, d_ratio = compare_bwd(d_got, d_ref)
        img_err = float(np.abs(out.image.detach().cpu().numpy() - g["image"]).max())
        t_gold = float(np.abs(out.final_t.detach().cpu().numpy() - g["t_final"]).max())
        print(f"golden {tw}x{th}: fwd kernel vs plain max|d color|={c_err:.3g} "
              f"max|d T|={t_err:.3g} ncon mismatches={mism}; bwd kernel vs plain "
              f"max|d d_attr|={d_err:.3g} (worst {d_ratio:.3g} of the allowance); card "
              f"render vs fp64 golden max|d image|={img_err:.3g} max|d T|={t_gold:.3g}",
              flush=True)
        check(c_err <= TOL_COLOR and t_err <= TOL_T and mism == 0, "golden fwd kernel vs plain")
        check(d_ratio <= 1.0, "golden bwd kernel vs plain")
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


def bench_scene(torch, dev, workdir):
    """bench.py's 1080p scene, through a PLY written and read by the port."""
    from gs_tpu_torch import cameras
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
    cam = cameras.make_camera(np.eye(3), np.array([0.0, 0.0, 5.0]), fovx=math.radians(70),
                              fovy=math.radians(46), width=WIDTH, height=HEIGHT, device=dev)
    print(f"scene: {N_GAUSS} Gaussians, SH degree 3, {WIDTH}x{HEIGHT}; built, written "
          f"({os.path.getsize(path)} B PLY) and reloaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return state, cam


def reset_launches() -> None:
    from gs_tpu_torch.ops import rasterize_cuda

    for key in rasterize_cuda.LAUNCHES:
        rasterize_cuda.LAUNCHES[key] = 0


def timed_in_turns(torch, kernel, plain, kernel_reps: int = 20):
    """Kernel and plain version timed with CUDA events in turns (plain,
    kernel, kernel, plain); returns the kernel's and the plain's runs (ms)."""
    kernel()
    torch.cuda.synchronize()
    k_ms, p_ms = [], []
    for fn, times, reps in ((plain, p_ms, 1), (kernel, k_ms, kernel_reps),
                            (kernel, k_ms, kernel_reps), (plain, p_ms, 1)):
        times.append(cuda_ms(fn, reps))
    return k_ms, p_ms


def render_phase(torch, state, cam, bg, cfgs) -> tuple[dict, dict]:
    """The render path at both tile sizes (counts reset just before, read
    just after), then the forward kernel vs its plain version on the inputs
    that run gave it, with times and bounds."""
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
    check(launches["composite_fwd"] > 0, "composite_fwd launched on the render path")
    for tw, th in TILES:
        img = images[(tw, th)]
        check(img.shape == (3, HEIGHT, WIDTH) and bool(torch.isfinite(img).all()),
              f"finite {HEIGHT}x{WIDTH} image at {tw}x{th}")
        print(f"image {tw}x{th}: mean {float(img.mean()):.6f}, "
              f"covered share {float((img.sum(0) > 0).float().mean()):.4f}", flush=True)
    diff = float((images[(16, 16)] - images[(48, 32)]).abs().max())
    print(f"16x16 vs 48x32 image max abs diff {diff:.3g}", flush=True)

    results = {}
    for tw, th in TILES:
        st, sp_attr, tile_ids, starts, ends = captured[(tw, th)]
        args = (st, sp_attr, tile_ids, starts, ends)
        got = rasterize_cuda.composite_fwd_cuda(*args)
        ref = rasterize_cuda.composite_fwd_torch(*args)
        torch.cuda.synchronize()
        c_err, t_err, mism = compare(got, ref)
        pixels = ref[1].numel()
        work = needed_work(torch, *args, ref[2])
        print(f"full {tw}x{th}: fwd kernel vs plain max|d color|={c_err:.3g} "
              f"max|d T|={t_err:.3g} ncon mismatches={mism} of {pixels} pixels", flush=True)
        check(c_err <= TOL_COLOR and t_err <= TOL_T and mism <= TOL_NCON_SHARE * pixels,
              f"fwd kernel vs plain at {tw}x{th}")
        k_ms, p_ms = timed_in_turns(torch, lambda: rasterize_cuda.composite_fwd_cuda(*args),
                                    lambda: rasterize_cuda.composite_fwd_torch(*args))
        render_ms = cuda_ms(lambda: eval_render(state, cam, bg, active_sh_degree=3,
                                                raster_cfg=cfgs[(tw, th)][0]), 5)
        pairs_read = int((ends.long() - starts.long()).sum())
        out_bytes = pixels * (3 * 4 + 4 + 4)
        bytes_moved = pairs_read * 36 + 3 * 4 * tile_ids.numel() + out_bytes
        ops_ms = max(work["fp32_ops"] / PEAK_FP32_OPS, work["past_cull"] / PEAK_SFU) * 1e3
        bytes_ms = bytes_moved / PEAK_BYTES * 1e3
        results[(tw, th)] = r = dict(
            launches=per_tile[(tw, th)], max_abs_err=c_err, t_max_abs_err=t_err,
            ncon_mismatches=mism, ms=sum(k_ms) / len(k_ms), ms_runs=k_ms,
            plain_ms=sum(p_ms) / len(p_ms), plain_ms_runs=p_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            fp32_ms=work["fp32_ops"] / PEAK_FP32_OPS * 1e3,
            sfu_ms=work["past_cull"] / PEAK_SFU * 1e3, bytes_ms=bytes_ms,
            **work, pairs_read=pairs_read, bytes=bytes_moved,
            num_pairs=cfgs[(tw, th)][1], pair_budget=cfgs[(tw, th)][2], tiles=tile_ids.numel(),
            render_ms=render_ms)
        print(f"time {tw}x{th}: composite_fwd kernel {r['ms']:.3f} ms (runs {k_ms}), plain "
              f"{r['plain_ms']:.1f} ms (runs {p_ms}), eval_render {render_ms:.3f} ms", flush=True)
        print(f"bound {tw}x{th}: {r['bound_ms']:.4f} ms ({r['bound_by']}); fp32 "
              f"{r['fp32_ms']:.4f} ms ({work['fp32_ops']} ops), expf {r['sfu_ms']:.4f} ms, "
              f"bytes {bytes_ms:.4f} ms ({bytes_moved} B); {work['evals']} pair x pixel "
              f"evals needed, {work['past_cull']} past the cull, {work['past_skip']} past "
              f"the skip, {work['contributions']} contributions", flush=True)
    for tw, th in TILES:
        print(f"where eval_render's time goes at {tw}x{th}:", flush=True)
        profile(torch, "eval_render", lambda: eval_render(state, cam, bg, active_sh_degree=3,
                                                          raster_cfg=cfgs[(tw, th)][0]), 3)
    return launches, results


def train_phase(torch, dev, state, cam, bg, cfgs) -> tuple[dict, dict]:
    """The training path at both tile sizes: TRAIN_STEPS train_steps each,
    counts reset just before and read just after; then the backward kernel
    vs its plain version on the last step's inputs, with times and bounds."""
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
        check(all(math.isfinite(v) for v in losses), f"finite losses at {tw}x{th}")
        check(losses[-1] < losses[0], f"the loss falls over {TRAIN_STEPS} steps at {tw}x{th}")
        for name, p in ts.state.params().items():
            check(not torch.equal(p, ts0.state.params()[name]), f"group {name} moved at {tw}x{th}")
        check(float(ts.stats.denom.max()) == TRAIN_STEPS
              and bool(torch.isfinite(ts.stats.xyz_grad_accum).all())
              and float(ts.stats.xyz_grad_accum.max()) > 0, f"densify stats at {tw}x{th}")
        check(per_tile[(tw, th)] == {"composite_fwd": TRAIN_STEPS, "composite_bwd": TRAIN_STEPS},
              f"one fwd and one bwd launch per train_step at {tw}x{th}")
    launches = dict(rasterize_cuda.LAUNCHES)
    print(f"train path launches: {launches}", flush=True)
    check(launches["composite_fwd"] > 0 and launches["composite_bwd"] > 0,
          "both kernels launched on the training path")

    results = {}
    for tw, th in TILES:
        args = captured[(tw, th)]
        st, sp_attr, tile_ids, starts, ends, t_final, ncon = args[:7]
        got = rasterize_cuda.composite_bwd_cuda(*args)
        ref = rasterize_cuda.composite_bwd_torch(*args)
        torch.cuda.synchronize()
        err, ratio = compare_bwd(got, ref)
        inside = covered_rows(torch, sp_attr.shape[0], starts, ends)
        outside_zero = bool((got[~inside] == 0).all()) and bool((ref[~inside] == 0).all())
        print(f"full {tw}x{th}: bwd kernel vs plain max|d d_attr|={err:.3g} (worst "
              f"{ratio:.3g} of the allowance); {int((~inside).sum())} rows outside every "
              f"trimmed range, all exactly 0: {outside_zero}", flush=True)
        check(ratio <= 1.0, f"bwd kernel vs plain at {tw}x{th}")
        check(outside_zero, f"bwd rows outside the trimmed ranges are 0 at {tw}x{th}")
        k_ms, p_ms = timed_in_turns(torch, lambda: rasterize_cuda.composite_bwd_cuda(*args),
                                    lambda: rasterize_cuda.composite_bwd_torch(*args))
        cfg = cfgs[(tw, th)][0]
        step(ts0, 0, cfg)  # warm-up
        step_ms = cuda_ms(lambda: step(ts0, 0, cfg), TRAIN_STEPS)

        work = needed_work_bwd(torch, st, sp_attr, tile_ids, starts, ends, ncon)
        pixels = t_final.numel()
        pairs_read = int((ends.long() - starts.long()).sum())
        # sp_attr over the trimmed ranges read, all of d_attr written, the
        # per-pixel t_final, ncon, g_color and gt_term read, 12 B per tile
        bytes_moved = (pairs_read * 36 + sp_attr.shape[0] * 36 + pixels * (4 + 4 + 12 + 4)
                       + 3 * 4 * tile_ids.numel())
        ops_ms = max(work["fp32_ops"] / PEAK_FP32_OPS, work["past_cull"] / PEAK_SFU) * 1e3
        bytes_ms = bytes_moved / PEAK_BYTES * 1e3
        results[(tw, th)] = r = dict(
            launches=per_tile[(tw, th)]["composite_bwd"], max_abs_err=err,
            worst_share_of_tolerance=ratio, ms=sum(k_ms) / len(k_ms), ms_runs=k_ms,
            plain_ms=sum(p_ms) / len(p_ms), plain_ms_runs=p_ms,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            fp32_ms=work["fp32_ops"] / PEAK_FP32_OPS * 1e3,
            sfu_ms=work["past_cull"] / PEAK_SFU * 1e3, bytes_ms=bytes_ms,
            **work, pairs_read=pairs_read, bytes=bytes_moved, tiles=tile_ids.numel(),
            train_step_ms=step_ms)
        print(f"time {tw}x{th}: composite_bwd kernel {r['ms']:.3f} ms (runs {k_ms}), plain "
              f"{r['plain_ms']:.1f} ms (runs {p_ms}), train_step {step_ms:.3f} ms", flush=True)
        print(f"bound {tw}x{th}: {r['bound_ms']:.4f} ms ({r['bound_by']}); fp32 "
              f"{r['fp32_ms']:.4f} ms ({work['fp32_ops']} ops), expf {r['sfu_ms']:.4f} ms, "
              f"bytes {bytes_ms:.4f} ms ({bytes_moved} B); {work['evals']} pair x pixel "
              f"evals needed, {work['past_cull']} past the cull, {work['contributions']} "
              f"contributions; {pairs_read} pairs in the trimmed ranges", flush=True)
    for tw, th in TILES:
        print(f"where train_step's time goes at {tw}x{th}:", flush=True)
        profile(torch, "train_step", lambda: step(ts0, 0, cfgs[(tw, th)][0]), 1)
    return launches, results


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
          "both kernels launched by run_training")
    return dict(psnr=psnr, train_s=info["train_s"], it_per_s=iters / info["train_s"],
                alive=info["alive"], capacity=state.capacity, launches=launches)


def kernel_entry(name, source, replaces, launches, results, extra) -> dict:
    main_r = results[TILES[0]]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": main_r["ms"],
        "plain_ms": main_r["plain_ms"],
        "bound_ms": main_r["bound_ms"],
        "bound_by": main_r["bound_by"],
        "library_ms": None,
        "shape": f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, 16x16 tiles",
        "per_tile_size": {f"{tw}x{th}": r for (tw, th), r in results.items()},
        **extra,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.ops import rasterize_cuda
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
    libs = rasterize_cuda.build()
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for kname, so in libs.items():
        info = rasterize_cuda.BUILD_INFO[kname]
        print(f"  {os.path.relpath(so, ROOT)} from "
              f"{os.path.relpath(rasterize_cuda.SOURCES[kname], ROOT)}"
              + (f", nvcc {info['seconds']:.1f} s" if "seconds" in info else ""), flush=True)
        for line in info["ptxas"].splitlines():
            if "Used" in line or "Compiling entry" in line or "spill" in line:
                print("    ptxas:", line.strip(), flush=True)

    # 3. both kernels, the render and its gradients on the golden bundle
    golden_phase(torch, dev)

    with tempfile.TemporaryDirectory(dir=rasterize_cuda.BUILD_DIR) as workdir:
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
    render_launches, fwd_results = render_phase(torch, state, cam, bg, cfgs)
    # 5. the training path
    train_launches, bwd_results = train_phase(torch, dev, state, cam, bg, cfgs)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    # 6. run_training on the synthetic recovery scene
    recovery = recovery_phase(torch, dev)

    kernels = [
        kernel_entry("composite_fwd", "gs_tpu_torch/csrc/composite_fwd.cu",
                     "gs_tpu/ops/rasterize_pallas.py:937", render_launches["composite_fwd"],
                     fwd_results, {"launches_train_path": train_launches["composite_fwd"]}),
        kernel_entry("composite_bwd", "gs_tpu_torch/csrc/composite_bwd.cu",
                     "gs_tpu/ops/rasterize_pallas.py:1034", train_launches["composite_bwd"],
                     bwd_results, {"recovery": recovery}),
    ]
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
