#!/usr/bin/env python3
"""On-card smoke run of the gs_tpu_torch port (one NVIDIA GPU).

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4   # a machine with 4 cards: the mesh alone
    python3 chip_smoke.py --p1_reference <dir>/gs_tpu_torch/csrc   # P1 against another tree's

Run from the root of a checkout on a machine with a CUDA card and nvcc.
With ``--cards N`` it builds the kernels and runs only ``mesh_phase``: the
tile-sharded and the Gaussian-sharded steps across N processes with a card
each (NCCL), against the in-process meshes of the same shapes and the
unsharded step, every rank's memory under the Gaussian-sharded layout, and
on four cards the train CLI on a (2, 2) gauss world whose data rows load
only their own train images. Without it:

1. prints the card (name, count, ``nvidia-smi`` name and power limit);
2. builds the eight kernels (B1-B6, P1 and P2, the preprocess's VJP and
   forward) from ``gs_tpu_torch/csrc`` (``ops/cuda_build``), one nvcc per
   source, all at once (nvcc's register / shared-memory report
   is printed for each), and checks that ptxas gives the warp-layout
   kernels B1-B4 (``NO_STACK_FRAME``) no stack frame: an array fallen to
   local memory once tripled B2's time;
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
   on the inputs that run gave it (bitwise), and both are timed with CUDA
   events; the tiles' range lengths, the share of pixels still alive at the
   end of their tile's range, B1's warp layout and the warps an SM holds of
   B1 and B3 are printed;
5. drives the training path at the same width: 5 ``training.train_step``
   calls per tile size from that scene towards the image of the same
   construction made from ``default_rng(1)``, counts reset just before and
   read just after; the loss must fall and every group move; the backward
   kernel is held against its plain version on the last step's inputs, and
   kernel, plain version and train_step are timed and profiled, and the
   backward kernel runs twice on those inputs for the same bits; P2 is
   held on the last step's leaves against the plain forward
   (``preprocess_fwd_path``: the mask bit for bit, the radii but where
   3 sqrt(lambda_max) is within a step of an integer, every float output
   bit for bit where PyTorch's orders are the ones P2 takes, and counted,
   within ``P2_MAX_STEPS``, elsewhere), both timed; P1 is held on the last
   step's inputs against the exact VJP (autograd in float64;
   ``preprocess_path``), with its plain version and autograd's float32
   tape beside it, the three timed, and, given ``--p1_reference DIR``
   (another tree's ``gs_tpu_torch/csrc``), against that tree's P1 bit for
   bit;
5b. drives the same scene at SH degree 4 (``sh4_phase``: 24 rest
   coefficients a channel from ``default_rng(SH4_SEED)``) at 16x16: one
   ``eval_render`` and 3 ``train_step``s from iteration 4000 at active
   degree 4 (exact launches; B1 bitwise and B2 at its tolerance against
   their plain versions, the same bits twice; P1 as in step 5; the loss
   falls), a degree-4
   PLY round trip whose state renders the same bits, and the reference
   binning ``bin_gaussians`` against ``bin_gaussians_aligned`` on the
   frame (each tile the same Gaussians in the same order; both timed);
6. holds the tile-walk kernels B3 / B4 against B1 / B2 on the bench
   scene's captured inputs (both bitwise, B4 also at B2's tolerance) and
   times each pair in turns; then, at the chunk sizes the startup autotune
   can choose (32 and 128) and at both bench tile sizes, one render and
   one train_step under each ``KERNEL_MODE`` (exact launches), with B1-B4
   held against their plain versions on the inputs those runs gave them
   (forward bitwise, backward at its tolerance and the same bits twice)
   and timed (``chunk_sizes_phase``);
7. drives the pair-movement kernels on the bench scene at both tile sizes:
   3 ``train_step``s with ``GRAD_REDUCE="cuda"`` (B5: the loss falls, one
   step's gradients agree with the default reduction's, B5 agrees with its
   plain version (run on the CPU, where ``index_add_`` adds in row order)
   bitwise and gives the same bits twice, B5 / the sort feeding it /
   ``index_add_`` / autograd's gather backward / both train_steps timed in
   turns), then one ``eval_render`` and one ``train_step`` with
   ``EXPAND_IMPL="cuda"`` (B6: the render and every binning integer equal
   the default path's bitwise, B6 equals its plain version bitwise, B6 /
   ``repeat_interleave`` / binning's step 2 on both paths timed, the
   windows of B6's blocks printed), then one ``eval_render`` and one
   ``train_step`` with ``PAIR_SOURCE="carry"`` (``carry_path``: the
   attributes carried through binning's sorts and a 14-column B6 launch;
   the render bitwise equal to the gather path's, the gradients bitwise
   equal to the gather's under ``GRAD_REDUCE="cuda"`` and within tolerance
   of the default step's, exact launches, B6 bitwise equal to its plain
   version, the forward gather ``attr_pad[pair_gauss]``, both binnings and
   both train_steps timed in turns); and
   holds B5 against its plain version on the CPU, twice for the same bits,
   on the edge layouts of its block-window design (n not a multiple of
   256, empty segments at block boundaries, a block whose whole window is
   empty, one segment of 100,000 rows, every 16th segment ~1,000 rows,
   ``num_rows`` cutting the last segment), with NaN rows past what it may
   read: bitwise for segments B5 sums in row order, within one float
   rounding for the longer ones it sums as a block; and times B5 beside
   ``index_add_`` on each layout; and holds B6 against its plain version,
   bitwise as 32-bit words, on the edge layouts of its block-window design
   (``expand_edge_layouts``: n and total no multiple of its block, a
   zero-length interval on every block boundary, one interval over 50
   blocks, a run of 100,000 zero-length intervals at one offset, total % 4
   = 1, 2 and 3, total below one block, uncovered gaps, K = 1 and 16,
   float32 NaN payloads, infinities, -0.0 and denormals), timed beside
   ``repeat_interleave``; and holds P1 against its plain version at
   degrees 0-4 on the edge inputs of ``tests/torch_port_inputs.py``
   (``preprocess_edges``: culled, clamped, degenerate, dead; N = 1, 421, 0
   and 4096) and P2 against the plain forward on the same kinds
   (``preprocess_fwd_edges``), then both at the benchmark fit's size
   (``preprocess_fit_size``: 2,961,408 Gaussians drawn as that cell's
   scene, as in step 5);
8. drives the tile-sharded layout (``parallel/``, ``sharded_phase``) on the
   bench scene: the frame cut into 2 and 4 column strips rendered one after
   another on the card and reassembled, bitwise equal to ``eval_render``
   (one B1 launch a strip); one sharded train step on in-process meshes of
   (data, shard) = (1, 2), (1, 4), (2, 2) and (2, 1) (two views) under the
   default reduction, ``GRAD_REDUCE="cuda"`` and ``PAIR_SOURCE="carry"``,
   within tests/test_sharding.py's tolerances of the unsharded step over
   the same views, carry bitwise equal to the "cuda" gather strip by strip;
   two processes on the card (gloo) taking one (1, 2) and one (2, 1) step,
   the ranks bitwise equal to each other and, under "cuda", to the
   in-process steps, with the shares of a step's time in the collectives,
   the banded loss and the strips; and the train CLI with
   ``--shard_parallel 2`` as two processes (``GS_TPU_NUM_PROCESSES`` /
   ``GS_TPU_PROCESS_ID`` / ``GS_TPU_COORDINATOR``) for 12 iterations with
   densify rounds: no autotune, rank 0 alone writing, equal final states,
   the saved PLY rendered by ``cli.render`` bytewise equal to
   ``eval_render``;
8b. drives the Gaussian-sharded layout (``gauss_phase``) on the same
   scene and views: one gauss step on in-process meshes (1, 2), (1, 4) and
   (2, 2) under the default reduction, ``GRAD_REDUCE="cuda"`` and
   ``PAIR_SOURCE="carry"`` (and ``KERNEL_MODE="tile"`` on (1, 2)) with
   exact launches (B1 / B2 or B3 / B4 once a strip, B5 / B6 by mode), within
   tests/test_sharding.py's tolerances of the unsharded step and of the tile
   layout's step on the same mesh, carry bitwise equal to the "cuda"
   gather, B1 / B2 held against their plain versions on the strips' inputs,
   timed beside the tile layout's steps; ``visible_budget`` at the worst
   shard's visible count (the unbudgeted step's bits) and at half of it
   (the overflow reported, the result finite); densify on 4 shards against
   one-device ``densify_and_prune`` fed the same noise, and the rebalance
   loop from shards 0-1 full to a skew of at most 1.25, every row with its
   moments kept; two processes on the card (gloo) taking one (1, 2) step
   under "cuda" and the default, each rank's shard bitwise equal to the
   in-process step's under "cuda", with each rank's memory and the phase
   shares of a step; and the train CLI with ``--parallel_layout gauss`` as
   two processes for 12 iterations with densify, rank 0's PLY, evaluation
   and ``.npz`` from the shards put together (the PLY's renders bitwise
   equal to theirs), then a resume from that checkpoint as a directory;
9. drives the heavy scene (bench.py's second configuration: 1,048,576
   Gaussians, unclipped log-scales, varied opacities, from
   ``default_rng(0)``, built without the 3-NN whose scales its draws
   replace) at 48x32 tiles, which ``pick_kernel_mode`` routes to
   the tile-walk kernels: one ``eval_render`` and 3 ``train_step``s with
   the counts reset just before and read just after; the distribution of
   the tiles' range lengths; B3 / B4 against B1 / B2 (bitwise) and against
   their plain versions over the whole frame, B4 twice for the same bits,
   times, bounds and a profile of one ``train_step``; then step 7's B5
   path (2 steps) and B6 path on it, one ``train_step`` with both
   switches on, which launches B3, B4, B5 and B6 once each, step 7's
   carry path, and P1 on the last step's inputs as in step 5;
10. drives the CLIs (``cli_phase``): a COLMAP dataset of 10 PINHOLE
   1920x1080 views of the bench scene written under ``build/``,
   ``gs_tpu_torch.cli.train.main`` for 30 steps (SH degree 3, densify,
   opacity reset, a checkpoint at 15) with its defaults on: the viewer
   server on port 6009 and the startup kernel autotune, whose sweep
   (kernel form, chunk 32 / 128, gather / carry) is recorded apart, each
   candidate's launches checked against its own form and its ms and the
   winner printed; a run resumed from that checkpoint with the images on
   the CPU; ``gs_tpu_torch.cli.render.main``; ``cli.metrics.main`` (SSIM /
   PSNR against the port's functions on the same PNGs, LPIPS null without
   a weights file) and ``cli.full_eval.main`` (its metrics leg in a child
   process); checks the files, the restored state, the launches of every
   step in the winner's form and pair source and each rendered PNG against
   ``eval_render`` of the saved PLY; then serves the iteration-30 state
   through the viewer protocol to a client at 1080p (frames bitwise equal
   to ``eval_render``, one forward launch a frame) and trains 12
   iterations with ``profile_dir`` (a trace naming B1 and B2);
11. runs ``synthetic.recover`` (``run_training`` with its startup autotune,
   densify, prune, opacity reset and capacity / pair-budget growth) at
   benchmarks/synthetic_e2e.py's defaults and checks the test PSNR.

Every phase checks its exact launch counts (P1 once a step or strip
wherever a gradient is taken). The bench phases must launch
no tile-walk kernel (but the chunk-size phase, in the form it asks for),
the heavy phase no chunk-grid kernel, and the recovery and CLI steps only
the autotune winner's form; nothing but steps 7, 8 and 9's switched runs,
the sweeps' carry candidates and a carry winner's steps runs a
pair-movement kernel. The switches are put back after every run that may change them.

It prints each phase's wall seconds, a ``{"phase_s": ...}`` line, a
``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": ...}`` line. Any failed check raises: the exit
code is then non-zero and neither line is printed. Without a CUDA device,
or without the repository around it, it fails the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import json
import math
import os
import shutil
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
# the degree-4 leg: train_steps at active degree 4, and the seed of its
# fourth band's coefficients
SH4_STEPS, SH4_SEED = 3, 4
# the kernels on composite_warps.cuh's warp layout, whose ptxas report must
# show no stack frame (an array in local memory, or registers spilled)
NO_STACK_FRAME = ("composite_fwd", "composite_bwd", "composite_fwd_tile", "composite_bwd_tile")
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
# P1 at the benchmark fit's size (portbench/configs/mipnerf360.json: 2,959,677 Gaussians
# in 2,961,408 slots); its draw's seed
P1_FIT_N = 2_961_408
P1_FIT_SEED = 17
# P2 against the plain forward: a float output may differ from the plain route's
# by at most this many float32 steps where they differ at all, and a colour whose
# einsum cuBLAS adds in another order by this many steps of its sum's scale (each
# difference counted and reported)
P2_MAX_STEPS = 2
# --p1_reference DIR: another tree's gs_tpu_torch/csrc, whose P1 the phases hold
# this tree's P1 against bit for bit (the parent commit's, where only the shared
# header moved)
P1_REFERENCE = None


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
    deaths = torch.zeros(3, dtype=torch.int64, device=dev)
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
        busy = end > start
        deaths += torch.stack([busy.sum() * p, (stopped[:, 0, :] & busy[:, None]).sum(),
                               (stopped[:, 0, :].all(1) & busy).sum()])
    evals, past_cull, past_skip, contrib = (int(c) for c in counts.cpu())
    busy_pixels, died, tiles_died = (int(c) for c in deaths.cpu())
    return dict(evals=evals, past_cull=past_cull, past_skip=past_skip, contributions=contrib,
                alive_share=1.0 - died / busy_pixels if busy_pixels else 0.0,
                tiles_all_died_share=tiles_died * p / busy_pixels if busy_pixels else 0.0,
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


def print_ranges(label: str, r: dict) -> None:
    print(f"{label} ranges: {r['tiles']} tiles, pairs a tile min {r['min']} / median "
          f"{r['median']} / p99 {r['p99']} / max {r['max']}, mean {r['mean']:.1f}; the longest "
          f"{r['max_over_mean']:.3f}x the mean", flush=True)


def fwd_layout(tile_w: int, tile_h: int, chunk: int) -> dict:
    """B1's warp layout at this tile size (composite_warps.cuh's
    choose_layout with B1's first limit) and the warps an SM holds of B1
    and of B3 (the occupancy calculator, with each kernel's shared memory
    at this chunk)."""
    from gs_tpu_torch.ops import cuda_build

    fwd, tile = cuda_build.load("composite_fwd"), cuda_build.load("composite_fwd_tile")
    code = fwd.gs_composite_fwd_layout(tile_w, tile_h)
    return dict(warps=code // 10000, pixels_a_thread=code // 100 % 100, cells_a_warp=code % 100,
                resident_warps=fwd.gs_composite_fwd_resident_warps(tile_w, tile_h, chunk),
                composite_fwd_tile_resident_warps=tile.gs_composite_fwd_tile_resident_warps(
                    tile_w, tile_h, chunk))


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
def switches(grad_reduce: str = "scatter", expand_impl: str = "scatter",
             pair_source: str = "gather", kernel_mode: str = "chunk"):
    """The port's GRAD_REDUCE, EXPAND_IMPL, PAIR_SOURCE and KERNEL_MODE set
    for the block, then back to the defaults (the startup autotune leaves
    KERNEL_MODE and PAIR_SOURCE at its winner, process-wide)."""
    from gs_tpu_torch.ops import binning, rasterize_tiled

    rasterize_tiled.GRAD_REDUCE, binning.EXPAND_IMPL = grad_reduce, expand_impl
    rasterize_tiled.PAIR_SOURCE, rasterize_tiled.KERNEL_MODE = pair_source, kernel_mode
    try:
        yield
    finally:
        rasterize_tiled.GRAD_REDUCE, binning.EXPAND_IMPL = "scatter", "scatter"
        rasterize_tiled.PAIR_SOURCE, rasterize_tiled.KERNEL_MODE = "gather", "chunk"


@contextlib.contextmanager
def record_autotune(store: dict):
    """Record every startup sweep run_training starts (ops/autotune.py):
    each candidate's kernel form, chunk, pair source, the form
    pick_kernel_mode gave it, its launches and seconds, and each sweep's
    launches, the counts when it started, wall seconds, result and the
    globals it left. While a sweep
    runs, ``store["in_sweep"]`` is True (record_steps skips its calls)."""
    import torch

    from gs_tpu_torch.ops import autotune, cuda_build
    from gs_tpu_torch.ops import rasterize_tiled as rt

    real = autotune.autotune_formulation
    store.setdefault("sweeps", [])

    def timed(state, camera, cfg, steps):
        tiles = -(-camera.width // cfg.tile_w) * -(-camera.height // cfg.tile_h)
        cand = dict(mode=rt.KERNEL_MODE, chunk=cfg.chunk, source=rt.PAIR_SOURCE, steps=steps,
                    form=rt.pick_kernel_mode(cfg.backend, rt.current_pair_budget(
                        cfg, state.capacity), cfg.chunk, tiles))
        store["sweeps"][-1]["candidates"].append(cand)
        before = dict(cuda_build.LAUNCHES)
        try:
            cand["s"] = autotune.default_timer(state, camera, cfg, steps)
        finally:
            torch.cuda.synchronize()
            cand["launches"] = {k: cuda_build.LAUNCHES[k] - before[k] for k in before}
        return cand["s"]

    def sweep(state, camera, cfg, **kwargs):
        before = dict(cuda_build.LAUNCHES)
        store["sweeps"].append({"candidates": [], "launches_before": before})
        store["in_sweep"] = True
        t0 = time.perf_counter()
        try:
            res = real(state, camera, cfg, timer=timed, **kwargs)
        finally:
            store["in_sweep"] = False
        torch.cuda.synchronize()
        rec = store["sweeps"][-1]
        rec.update(wall_s=time.perf_counter() - t0, result=res, kernel_mode=rt.KERNEL_MODE,
                   pair_source=rt.PAIR_SOURCE,
                   launches={k: cuda_build.LAUNCHES[k] - before[k] for k in before})
        return res

    autotune.autotune_formulation = sweep
    try:
        yield store
    finally:
        autotune.autotune_formulation = real


def check_sweep(rec: dict, label: str) -> dict:
    """One sweep's checks: every phase's candidate ran, each launched its own
    form's kernels (chunk: B1 + B2, tile: B3 + B4, a warm-up and each timed
    pass, forward and backward) and, under carry, B5 + B6 as often, nothing
    else; the winner is the fastest and the globals were left at it. Prints
    each candidate's ms and the winner; returns a summary."""
    res = rec["result"]
    check(res is not None, f"the autotune ran on the card ({label})")
    cands = rec["candidates"]
    check(len(cands) == 5 and [c["mode"] for c in cands[:2]] == ["chunk", "tile"]
          and [c["chunk"] for c in cands[2:4]] == [32, 128]
          and [c["source"] for c in cands] == ["gather"] * 4 + ["carry"],
          f"the sweep's five candidates in gs_tpu's phase order ({label})")
    for c in cands:
        n = c["steps"] + 1
        fwd, bwd = (("composite_fwd", "composite_bwd") if c["form"] == "chunk"
                    else ("composite_fwd_tile", "composite_bwd_tile"))
        want = {fwd: n, bwd: n, "preprocess_fwd": n, "preprocess_bwd": n}
        if c["source"] == "carry":
            want.update(segment_reduce=n, expand_intervals=n)
        check(c["mode"] == "tile" and c["form"] == "tile" or c["mode"] == "chunk",
              f"KERNEL_MODE tile takes the tile form ({label})")
        check(c["launches"] == launches_of(**want) and math.isfinite(c["s"]),
              f"candidate {c['mode']} chunk {c['chunk']} {c['source']} launched its own "
              f"kernels {want} ({label}): {c['launches']}")
    times = {k: v for k, v in res.items() if k not in ("winner", "cfg")}
    check(res["winner"] in times and times[res["winner"]] == min(times.values()),
          f"the winner is the fastest candidate ({label})")
    check(rec["kernel_mode"] == res["winner"].split("-")[0].split("+")[0]
          and rec["pair_source"] == ("carry" if res["winner"].endswith("+carry") else "gather"),
          f"the sweep left the globals at its winner ({label})")
    summary = dict(candidates_ms={k: v * 1e3 for k, v in times.items()}, winner=res["winner"],
                   chunk=res["cfg"].chunk, kernel_mode=rec["kernel_mode"],
                   pair_source=rec["pair_source"], wall_s=rec["wall_s"],
                   launches=rec["launches"],
                   forms={f"{c['mode']}-c{c['chunk']}-{c['source']}": c["form"] for c in cands})
    print(f"autotune {label}: " + ", ".join(f"{k}={v:.2f}ms" for k, v in
                                             summary["candidates_ms"].items())
          + f" -> {res['winner']} (chunk {summary['chunk']}, KERNEL_MODE "
          f"{summary['kernel_mode']}, PAIR_SOURCE {summary['pair_source']}); sweep "
          f"{rec['wall_s']:.2f} s, launches {rec['launches']}; forms {summary['forms']}",
          flush=True)
    return summary


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


def bench_configs(torch, state, cam, bg) -> dict:
    """Per bench tile size, (config, num_pairs, pair budget): the default
    budget truncates the bench scene, so it is grown to 1.05 x num_pairs."""
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget
    from gs_tpu_torch.renderer import render

    cfgs = {}
    for tw, th in TILES:
        cfg = RasterizeConfig(tile_w=tw, tile_h=th)
        num_pairs = int(render(cam, state, active_sh_degree=3, bg_color=bg, cfg=cfg).num_pairs)
        grown = dataclasses.replace(cfg, pair_budget_factor=1.05 * num_pairs / N_GAUSS)
        budget = current_pair_budget(grown, N_GAUSS)
        check(num_pairs <= budget, "grown budget holds every pair")
        print(f"pairs {tw}x{th}: num_pairs={num_pairs} default budget="
              f"{current_pair_budget(cfg, N_GAUSS)} grown budget={budget}", flush=True)
        cfgs[(tw, th)] = (grown, num_pairs, budget)
    torch.cuda.synchronize()
    return cfgs


def reset_launches() -> None:
    from gs_tpu_torch.ops import cuda_build

    for key in cuda_build.LAUNCHES:
        cuda_build.LAUNCHES[key] = 0


def launches_of(**counts) -> dict:
    """The full launch-count dict with ``counts`` set and every other kernel 0."""
    from gs_tpu_torch.ops import cuda_build

    return {key: counts.get(key, 0) for key in cuda_build.LAUNCHES}


def timed_in_turns(torch, kernel, other, kernel_reps: int = 20, other_reps: int = 1,
                   warm: bool = True):
    """A kernel and another version of it (the plain version, or the other
    kernel form) timed with CUDA events in turns (other, kernel, kernel,
    other); returns the kernel's and the other's runs (ms). ``warm=False``
    skips the warm-up run of each where the caller has just run both on
    the same inputs (a comparison), so the plain versions' seconds-long
    runs at 1080p are not repeated for nothing."""
    if warm:
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
    check(launches == launches_of(composite_fwd=len(TILES), preprocess_fwd=len(TILES)),
          "the bench render path launches composite_fwd and P2 once a render and nothing else")
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
        bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"full {tw}x{th}: fwd kernel vs plain max|d color|={c_err:.3g} "
              f"max|d T|={t_err:.3g} ncon mismatches={mism} of {pixels} pixels; bitwise equal "
              f"{bitwise}", flush=True)
        check(c_err <= TOL_COLOR and t_err <= TOL_T and mism <= TOL_NCON_SHARE * pixels,
              f"fwd kernel vs plain at {tw}x{th}")
        check(bitwise, f"fwd kernel equals its plain version bitwise at {tw}x{th}")
        k_ms, p_ms = timed_in_turns(torch, lambda: rasterize_cuda.composite_fwd_cuda(*args),
                                    lambda: rasterize_cuda.composite_fwd_torch(*args),
                                    warm=False)
        render_ms = cuda_ms(lambda: eval_render(state, cam, bg, active_sh_degree=3,
                                                raster_cfg=cfgs[(tw, th)][0]), 5)
        bound = fwd_bound(torch, *args, ref[2])
        ranges = range_distribution(torch, args[3], args[4])
        layout = fwd_layout(tw, th, args[0].chunk)
        results[(tw, th)] = r = dict(
            shape=f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, {tw}x{th} tiles",
            launches=per_tile[(tw, th)], max_abs_err=c_err, t_max_abs_err=t_err,
            ncon_mismatches=mism, equal_to_plain=bitwise, ms=mean(k_ms), ms_runs=k_ms,
            plain_ms=mean(p_ms), plain_ms_runs=p_ms, **bound, num_pairs=cfgs[(tw, th)][1],
            pair_budget=cfgs[(tw, th)][2], tiles=args[2].numel(), render_ms=render_ms,
            ranges=ranges, layout=layout)
        print(f"time {tw}x{th}: composite_fwd kernel {r['ms']:.3f} ms (runs {k_ms}), plain "
              f"{r['plain_ms']:.1f} ms (runs {p_ms}), eval_render {render_ms:.3f} ms", flush=True)
        print_bound(f"composite_fwd {tw}x{th}", bound)
        print_ranges(f"bench {tw}x{th} forward", ranges)
        print(f"bench {tw}x{th}: {100 * bound['alive_share']:.2f}% of the busy tiles' pixels "
              f"alive at the end of their tile's range; all pixels die before the range ends in "
              f"{100 * bound['tiles_all_died_share']:.2f}% of the busy tiles; B1 layout "
              f"{layout['warps']} warps of {layout['cells_a_warp']} cells, "
              f"{layout['pixels_a_thread']} pixels a thread, {layout['resident_warps']} warps "
              f"an SM (B3: {layout['composite_fwd_tile_resident_warps']})", flush=True)
    for tw, th in TILES:
        print(f"where eval_render's time goes at {tw}x{th}:", flush=True)
        profile(torch, "eval_render", lambda: eval_render(state, cam, bg, active_sh_degree=3,
                                                          raster_cfg=cfgs[(tw, th)][0]), 3)
    return launches, results, captured


def train_phase(torch, dev, state, cam, bg,
                cfgs) -> tuple[dict, dict, dict, object, dict, dict]:
    """The training path at both tile sizes: TRAIN_STEPS train_steps each,
    counts reset just before and read just after; then the backward kernel
    vs its plain version on the last step's inputs, with times and bounds,
    and P2 and P1 on the last step's inputs (``preprocess_fwd_path``,
    ``preprocess_path``). Returns the launches, the results, the captured
    inputs, the training camera (the view with its target image) and P1's
    and P2's results by tile size."""
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

    captured, per_tile, pre_captured = {}, {}, {}
    reset_launches()
    for tw, th in TILES:
        cfg = cfgs[(tw, th)][0]
        before = dict(rasterize_cuda.LAUNCHES)
        ts = training.init_train_state(state, 1.0, 3)
        losses, calls, pcalls = [], [], []
        with capture_composite_bwd(calls), capture_preprocess_bwd(pcalls):
            for i in range(TRAIN_STEPS):
                calls.clear()  # keep the last step's inputs only
                pcalls.clear()
                ts.state, ts.adam, ts.stats, m = step(ts, i, cfg)
                losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        captured[(tw, th)] = calls[0]
        pre_captured[(tw, th)] = pcalls[0]
        per_tile[(tw, th)] = {k: rasterize_cuda.LAUNCHES[k] - before[k] for k in before}
        print(f"train {tw}x{th}: losses {losses}; launches {per_tile[(tw, th)]}", flush=True)
        check_training(torch, ts, ts0, losses, TRAIN_STEPS, f"{tw}x{th}")
        check(per_tile[(tw, th)] == launches_of(composite_fwd=TRAIN_STEPS,
                                                composite_bwd=TRAIN_STEPS,
                                                preprocess_fwd=TRAIN_STEPS,
                                                preprocess_bwd=TRAIN_STEPS),
              f"one fwd, one bwd and one preprocess VJP launch per train_step at {tw}x{th}, "
              f"no tile-walk kernel")
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
                                    lambda: rasterize_cuda.composite_bwd_torch(*args),
                                    warm=False)
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
    pre_results, fwd_pre_results = {}, {}
    for tw, th in TILES:
        args, shape = pre_captured.pop((tw, th)), f"{N_GAUSS} Gaussians, SH 3, {WIDTH}x{HEIGHT}"
        fwd_pre_results[(tw, th)] = preprocess_fwd_path(
            torch, f"bench {tw}x{th}", shape, args, per_tile[(tw, th)]["preprocess_fwd"])
        pre_results[(tw, th)] = preprocess_path(
            torch, f"bench {tw}x{th}", shape, args, per_tile[(tw, th)]["preprocess_bwd"])
    for tw, th in TILES:
        print(f"where train_step's time goes at {tw}x{th}:", flush=True)
        profile(torch, "train_step", lambda: step(ts0, 0, cfgs[(tw, th)][0]), 1)
    return launches, results, captured, cam, pre_results, fwd_pre_results


def check_training(torch, ts, ts0, losses, steps, where) -> None:
    """The loss falls, every group moves, the densify stats count every step."""
    check(all(math.isfinite(v) for v in losses), f"finite losses at {where}")
    check(losses[-1] < losses[0], f"the loss falls over {steps} steps at {where}")
    for name, p in ts.state.params().items():
        check(not torch.equal(p, ts0.state.params()[name]), f"group {name} moved at {where}")
    check(float(ts.stats.denom.max()) == steps
          and bool(torch.isfinite(ts.stats.xyz_grad_accum).all())
          and float(ts.stats.xyz_grad_accum.max()) > 0, f"densify stats at {where}")


def sh4_phase(torch, dev, bench, cam_t, bg, cfgs) -> dict:
    """The bench scene ``bench`` at SH degree 4 (its ``features_rest``
    replaced by [N_GAUSS, 24, 3] drawn from ``default_rng(SH4_SEED)``) at 16x16: one
    ``eval_render`` and SH4_STEPS ``train_step``s at active degree 4
    (counts reset just before each, read just after), B1 bitwise and B2
    within the train phase's tolerances against their plain versions on
    what those runs gave them, the loss falling; a degree-4 PLY round trip
    and the reloaded state's render, both bitwise; and the reference
    binning ``bin_gaussians`` against ``bin_gaussians_aligned`` on the
    frame: each tile the same Gaussians in the same order."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.data import ply
    from gs_tpu_torch.ops import binning, rasterize_cuda
    from gs_tpu_torch.ops.projection import bin_radii
    from gs_tpu_torch.renderer import project_splats

    t_phase = time.perf_counter()
    tw, th = TILES[0]
    cfg, num_pairs, budget = cfgs[(tw, th)]
    rest = np.random.default_rng(SH4_SEED).normal(0, 0.1, (N_GAUSS, 24, 3)).astype(np.float32)
    state = bench.replace(features_rest=torch.from_numpy(rest).to(dev))
    check(state.max_sh_degree == 4 and tuple(state.features_rest.shape) == (N_GAUSS, 24, 3),
          "a degree-4 state of 24 rest coefficients a channel")
    cam = dataclasses.replace(cam_t, image=None)
    out = dict(shape=f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, SH 4, {tw}x{th} tiles")

    # the render
    calls = []
    reset_launches()
    with capture_composite(calls):
        image = training.eval_render(state, cam, bg, active_sh_degree=4, raster_cfg=cfg)
    torch.cuda.synchronize()
    out["render_launches"] = launches = dict(rasterize_cuda.LAUNCHES)
    check(launches == launches_of(composite_fwd=1, preprocess_fwd=1),
          "the degree-4 render launches composite_fwd and P2 once and nothing else")
    check(calls[0][0].kernel_mode == "chunk", "chunk-grid form at SH 4")
    check(image.shape == (3, HEIGHT, WIDTH) and bool(torch.isfinite(image).all()),
          "finite degree-4 image")
    deg3 = training.eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=cfg)
    out["band4_max_abs"] = float((image - deg3).abs().max())
    check(out["band4_max_abs"] > 0, "the fourth band changes the image")
    got = rasterize_cuda.composite_fwd_cuda(*calls[0])
    ref = rasterize_cuda.composite_fwd_torch(*calls[0])
    torch.cuda.synchronize()
    c_err, t_err, mism = compare(got, ref)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
    out.update(fwd_max_abs_err=c_err, fwd_t_max_abs_err=t_err, fwd_ncon_mismatches=mism,
               fwd_equal_to_plain=bitwise, image_mean=float(image.mean()))
    check(bitwise, "fwd kernel equals its plain version bitwise at SH 4")
    del got, ref, calls, deg3

    # the steps, from iteration 4000, where the schedule reaches degree 4
    opt = OptimizationParams()
    ts0 = training.init_train_state(state, 1.0, 4)
    ts = training.init_train_state(state, 1.0, 4)
    ts.iteration = 4000
    check(ts.active_sh_degree == 4, "TrainState reaches degree 4 at iteration 4000")
    losses, calls, pcalls = [], [], []
    reset_launches()
    with capture_composite_bwd(calls), capture_preprocess_bwd(pcalls):
        for _ in range(SH4_STEPS):
            calls.clear()  # keep the last step's inputs only
            pcalls.clear()
            ts.state, ts.adam, ts.stats, m = training.train_step(
                ts.state, ts.adam, ts.stats, cam_t, bg, ts.iteration, 1.0,
                active_sh_degree=ts.active_sh_degree, opt_cfg=opt, raster_cfg=cfg,
                accumulate_stats=True)
            ts.iteration += 1
            losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    out["step_launches"] = launches = dict(rasterize_cuda.LAUNCHES)
    out["losses"] = losses
    print(f"SH 4 render: mean {out['image_mean']:.6f}, band 4 moves it by up to "
          f"{out['band4_max_abs']:.4g}; B1 bitwise {bitwise}; train losses {losses}; "
          f"launches {launches}", flush=True)
    check_training(torch, ts, ts0, losses, SH4_STEPS, "SH 4")
    check(launches == launches_of(composite_fwd=SH4_STEPS, composite_bwd=SH4_STEPS,
                                  preprocess_fwd=SH4_STEPS, preprocess_bwd=SH4_STEPS),
          "one fwd, one bwd, one P2 and one preprocess VJP launch per degree-4 train_step")
    check(float(ts.adam.mu["f_rest"][:, 15:].abs().max()) > 0,
          "the fourth band's coefficients get gradients")
    got = rasterize_cuda.composite_bwd_cuda(*calls[0])
    again = rasterize_cuda.composite_bwd_cuda(*calls[0])
    ref = rasterize_cuda.composite_bwd_torch(*calls[0])
    torch.cuda.synchronize()
    err, ratio = compare_bwd(got, ref)
    same_bits = torch.equal(got, again)
    out.update(bwd_max_abs_err=err, bwd_worst_share_of_tolerance=ratio, bwd_same_bits=same_bits)
    print(f"SH 4: bwd kernel vs plain max|d d_attr|={err:.3g} (worst {ratio:.3g} of the "
          f"allowance); same bits twice {same_bits}", flush=True)
    check(ratio <= 1.0, "bwd kernel vs plain at SH 4")
    check(same_bits, "bwd kernel gives the same bits twice at SH 4")
    del got, again, ref, calls
    args = pcalls.pop()
    out["preprocess_fwd"] = preprocess_fwd_path(torch, "SH 4", out["shape"], args,
                                                launches["preprocess_fwd"])
    out["preprocess_bwd"] = preprocess_path(torch, "SH 4", out["shape"], args,
                                            launches["preprocess_bwd"])

    # a degree-4 PLY round trip and the reloaded state's render
    trained = ts.state
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
        path = os.path.join(workdir, "point_cloud.ply")
        ply.save_state_ply(path, trained)
        out["ply_bytes"] = os.path.getsize(path)
        loaded = ply.load_gaussian_ply(path, device=dev)
    check(loaded.max_sh_degree == 4 and loaded.capacity == N_GAUSS
          and int(loaded.num_alive) == N_GAUSS, "degree-4 PLY round trip size")
    for name in ("xyz", "features_dc", "features_rest", "log_scale", "quat", "logit_opacity"):
        check(torch.equal(getattr(loaded, name), getattr(trained, name)),
              f"degree-4 PLY round trip {name}")
    again = training.eval_render(loaded, cam, bg, active_sh_degree=4, raster_cfg=cfg)
    before = training.eval_render(trained, cam, bg, active_sh_degree=4, raster_cfg=cfg)
    check(torch.equal(again, before), "the reloaded degree-4 state renders the same bits")
    del loaded, again, before

    # the reference binning against the aligned one on the frame
    with torch.no_grad():
        sp = project_splats(cam, state, active_sh_degree=4)
        radii_b = bin_radii(sp.radii, sp.opacities)
    tx, ty = -(-WIDTH // tw), -(-HEIGHT // th)
    bin_args = (sp.means2d, sp.depths, radii_b, tx, ty, tw, th, budget)
    ref_bin = binning.bin_gaussians(*bin_args)
    ab = binning.bin_gaussians_aligned(*bin_args, cfg.chunk)
    torch.cuda.synchronize()
    n_ref, n_ab = int(ref_bin.num_pairs), int(ab.num_pairs)
    valid_cum = torch.nn.functional.pad(torch.cumsum(ab.valid, 0), (1, 0))
    per_tile = valid_cum[ab.ends.long()] - valid_cum[ab.starts.long()]
    same_order = torch.equal(ab.pair_gauss[ab.valid], ref_bin.pair_gauss[:n_ref])
    same_counts = torch.equal(per_tile, torch.diff(ref_bin.tile_offsets).long())
    ref_ms = cuda_ms(lambda: binning.bin_gaussians(*bin_args), 3)
    aligned_ms = cuda_ms(lambda: binning.bin_gaussians_aligned(*bin_args, cfg.chunk), 3)
    out.update(num_pairs=n_ref, reference_binning_ms=ref_ms, aligned_binning_ms=aligned_ms,
               binnings_agree=same_order and same_counts)
    print(f"SH 4 binning: bin_gaussians {n_ref} pairs in {ref_ms:.3f} ms, "
          f"bin_gaussians_aligned {n_ab} in {aligned_ms:.3f} ms; every tile the same Gaussians "
          f"in the same order: {same_order and same_counts}", flush=True)
    check(n_ref == n_ab == num_pairs <= budget, "both binnings count the frame's pairs")
    check(same_order and same_counts,
          "bin_gaussians and bin_gaussians_aligned give each tile the same Gaussians in order")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"SH 4 phase: {out['wall_s']:.1f} s", flush=True)
    return out


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


# the chunk sizes the startup autotune can hand training besides the default 64
AUTOTUNE_CHUNKS = (32, 128)
FORM_KERNELS = {"chunk": ("composite_fwd", "composite_bwd"),
                "tile": ("composite_fwd_tile", "composite_bwd_tile")}


def chunk_sizes_phase(torch, state, cam_t, bg, cfgs) -> dict:
    """B1-B4 at the chunk sizes the autotune can choose: per bench tile size
    and chunk in AUTOTUNE_CHUNKS, one ``eval_render`` and one ``train_step``
    under KERNEL_MODE "chunk" and under "tile", counts reset just before and
    read just after each (one forward launch a render and a step, one
    backward a step, in the form pick_kernel_mode gives: gs_tpu's 700 KiB
    rule may turn "chunk" into the tile form). On each distinct set of
    inputs the paths gave, all four kernels are held against the plain
    versions (forward bitwise, backward at BWD_RTOL / BWD_ATOL_SHARE and the
    same bits twice) and timed with CUDA events. Returns the results by
    kernel and path."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.ops import rasterize_cuda as rc

    fwd_fn = {"composite_fwd": rc.composite_fwd_cuda, "composite_fwd_tile": rc.composite_fwd_tile_cuda}
    bwd_fn = {"composite_bwd": rc.composite_bwd_cuda, "composite_bwd_tile": rc.composite_bwd_tile_cuda}
    opt = OptimizationParams()
    results = {name: {} for name in (*fwd_fn, *bwd_fn)}
    for tw, th in TILES:
        for chunk in AUTOTUNE_CHUNKS:
            cfg = dataclasses.replace(cfgs[(tw, th)][0], chunk=chunk)
            label = f"bench {tw}x{th} chunk {chunk}"
            shape = f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, {tw}x{th} tiles, chunk {chunk}"
            inputs = {}
            for mode in ("chunk", "tile"):
                fcalls, bcalls = [], []
                with switches(kernel_mode=mode):
                    reset_launches()
                    with capture_composite(fcalls):
                        img = training.eval_render(state, cam_t, bg, active_sh_degree=3,
                                                   raster_cfg=cfg)
                        form = fcalls[0][0].kernel_mode
                        ts = training.init_train_state(state, 1.0, 3)
                        with capture_composite_bwd(bcalls, "composite_bwd_cuda" if form == "chunk"
                                                   else "composite_bwd_tile_cuda"):
                            *_, m = training.train_step(
                                ts.state, ts.adam, ts.stats, cam_t, bg, 0, 1.0,
                                active_sh_degree=3, opt_cfg=opt, raster_cfg=cfg,
                                accumulate_stats=True)
                    torch.cuda.synchronize()
                    launches = dict(rc.LAUNCHES)
                fwd, bwd = FORM_KERNELS[form]
                check(launches == launches_of(**{fwd: 2, bwd: 1}, preprocess_fwd=2,
                                              preprocess_bwd=1),
                      f"{label} KERNEL_MODE {mode}: one {fwd} and one P2 a render and a step, "
                      f"one {bwd} and one preprocess VJP a step ({launches})")
                check(mode == "chunk" or form == "tile", f"{label}: KERNEL_MODE tile is the tile form")
                check(all(c[0].chunk == chunk for c in fcalls + bcalls)
                      and bool(torch.isfinite(img).all()) and math.isfinite(float(m["loss"])),
                      f"{label} KERNEL_MODE {mode}: chunk {chunk}, a finite image and loss")
                for name in (fwd, bwd):
                    results[name][label] = dict(shape=shape, launches=launches[name])
                print(f"{label} KERNEL_MODE {mode}: the {form} form; launches {launches}; loss "
                      f"{float(m['loss']):.6f}", flush=True)
                inputs.setdefault(form, (fcalls[0], bcalls[0]))
                del img, ts, m
            for form, (fargs, bargs) in inputs.items():
                t0 = time.perf_counter()
                ref = rc.composite_fwd_torch(*fargs)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                bref = rc.composite_bwd_torch(*bargs)
                torch.cuda.synchronize()
                bplain_ms = (time.perf_counter() - t0) * 1e3
                for name, fn in fwd_fn.items():
                    got = fn(*fargs)
                    c_err, t_err, mism = compare(got, ref)
                    bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
                    check(bitwise, f"{name} equals its plain version bitwise, {label}, "
                                   f"{form}-form inputs (max|d color| {c_err:.3g})")
                    ms = cuda_ms(lambda: fn(*fargs), 20)
                    r = results[name].setdefault(label, dict(shape=shape, launches=0))
                    r.update({f"{form}_inputs": dict(ms=ms, plain_ms=plain_ms, bitwise=bitwise)})
                    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), c_err)
                    if FORM_KERNELS[form][0] == name or "ms" not in r:
                        r.update(ms=ms, plain_ms=plain_ms, inputs=form)
                for name, fn in bwd_fn.items():
                    got, again = fn(*bargs), fn(*bargs)
                    torch.cuda.synchronize()
                    err, ratio = compare_bwd(got, bref)
                    same = torch.equal(got, again)
                    check(ratio <= 1.0 and same, f"{name} vs its plain version ({ratio:.3g} of "
                                                 f"the allowance), same bits twice {same}, {label}, "
                                                 f"{form}-form inputs")
                    del got, again
                    ms = cuda_ms(lambda: fn(*bargs), 20)
                    r = results[name].setdefault(label, dict(shape=shape, launches=0))
                    r.update({f"{form}_inputs": dict(ms=ms, plain_ms=bplain_ms,
                                                      worst_share_of_tolerance=ratio)})
                    r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
                    if FORM_KERNELS[form][1] == name or "ms" not in r:
                        r.update(ms=ms, plain_ms=bplain_ms, inputs=form)
                del ref, bref
            print(f"time {label}: " + "; ".join(
                f"{name} {results[name][label]['ms']:.3f} ms on {results[name][label]['inputs']}-form "
                f"inputs (plain {results[name][label]['plain_ms']:.0f} ms)" for name in results),
                flush=True)
            del inputs
    return results


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
    check(launches == launches_of(segment_reduce=steps, preprocess_fwd=steps,
                                  preprocess_bwd=steps, **{k: steps for k in form}),
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
    check(render_launches == launches_of(expand_intervals=1, preprocess_fwd=1, **{form[0]: 1}),
          f"one B6 launch per render at {label}")
    check(train_launches == launches_of(expand_intervals=1, preprocess_fwd=1, preprocess_bwd=1,
                                        **{k: 1 for k in form}),
          f"one B6 launch per train_step at {label}")
    check(math.isfinite(float(m["loss"])), f"finite loss through B6 at {label}")
    default_img = training.eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=cfg)
    same_img = torch.equal(img, default_img)
    del img, default_img

    # every binning integer of the render's call, both paths
    args = bin_calls[0]
    got = binning.bin_gaussians_aligned(*args, count_by_gauss=True, expand_impl="cuda")
    want = binning.bin_gaussians_aligned(*args, count_by_gauss=True, expand_impl="scatter")
    fields = [f for f in got._fields
              if not (getattr(got, f) is None and getattr(want, f) is None)
              and not torch.equal(getattr(got, f), getattr(want, f))]
    del got, want
    # B6 against its plain version
    offsets, ends, cols, total = exp_calls[0]
    b6 = pairmove.expand_intervals(offsets, ends, cols, total)
    plain = pairmove.expand_intervals_torch(offsets, ends, cols, total)
    same_b6 = torch.equal(b6, plain)
    b6_err = float((b6.double() - plain.double()).abs().max())
    torch.cuda.synchronize()
    covered = int((ends.long() - offsets.long()).sum())
    windows = expand_windows(torch, offsets, total)
    print(f"{label}: render through B6 equal to the default bitwise {same_img}; binning "
          f"fields that differ {fields}; B6 equal to plain bitwise {same_b6}; {offsets.shape[0]} "
          f"intervals, {covered} of {total} slots owned; B6 windows {windows}", flush=True)
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
             step2_default_ms=mean(s2_default), step2_default_ms_runs=s2_default,
             windows=windows, **bound)
    print(f"time {label}: B6 {r['ms']:.4f} ms (runs {k_ms}, bound {bound['bound_ms']:.4f} ms, "
          f"bytes), plain {r['plain_ms']:.3f} ms, repeat_interleave {r['library_ms']:.4f} ms; "
          f"binning step 2 through B6 {r['step2_cuda_ms']:.3f} ms vs repeat_interleave + "
          f"gathers {r['step2_default_ms']:.3f} ms", flush=True)
    return r


def expand_windows(torch, offsets, total: int) -> dict:
    """The windows of B6's blocks over these intervals (csrc/expand_intervals.cu):
    block b's slots [b x block, ...) can be owned by the intervals from the
    last starting at or before its first slot to the last starting at or
    before its last slot. The largest, its block, and the blocks whose window
    exceeds the piece B6 stages in shared memory (those search device
    memory)."""
    from gs_tpu_torch.ops import cuda_build

    lib = cuda_build.load("expand_intervals")
    block, piece = lib.gs_expand_intervals_block_slots(), lib.gs_expand_intervals_window_piece()
    first = torch.arange(0, total, block, dtype=torch.int64, device=offsets.device)
    last = torch.clamp(first + block, max=total) - 1
    lo = torch.searchsorted(offsets.long(), first, right=True)
    hi = torch.searchsorted(offsets.long(), last, right=True)
    size = hi - torch.clamp(lo - 1, min=0)
    return dict(blocks=first.numel(), block_slots=block, piece=piece,
                largest=int(size.max()) if size.numel() else 0,
                largest_at_block=int(size.argmax()) if size.numel() else 0,
                mean=float(size.double().mean()) if size.numel() else 0.0,
                past_piece=int((size > piece).sum()))


# NaN payloads (quiet and signalling, both signs), infinities and -0.0 as float32 words
SPECIAL_WORDS = (0x7FC00001, 0xFFC12345, 0x7F800001, 0xFFBFFFFF, 0x7F800000, 0xFF800000,
                 0x80000000)
# float32 denormals of both signs: what int32 values below 2^23 look like as
# float32 words (the carry binning's owner fields beside float attributes)
DENORMAL_WORD_MAX = (1 << 23) - 1


def expand_edge_layouts(rng, block: int) -> dict:
    """B6's edge layouts for its block of ``block`` slots: name -> (interval
    lengths, the uncovered gap before each, total, columns, kind: "float",
    "int" or "special" float32 words)."""
    def lengths(n):
        return rng.integers(0, 12, size=n)

    layouts = {}
    a = lengths(30_001)  # n and total no multiple of the block
    layouts["n_not_block_multiple"] = (a, 0 * a, int(a.sum()), 5, "float")
    pieces = []  # each block's slots split among intervals inside it, a zero-length one first
    for _ in range(40):
        cuts = np.sort(rng.choice(np.arange(1, block), size=int(rng.integers(5, 60)),
                                  replace=False))
        pieces += [0, *np.diff(np.concatenate([[0], cuts, [block]]))]
    b = np.array(pieces)
    layouts["empty_on_block_boundaries"] = (b, 0 * b, int(b.sum()), 5, "float")
    c = lengths(4_000)
    c[2_000] = 50 * block + 123  # one interval over 50 blocks
    layouts["one_over_many_blocks"] = (c, 0 * c, int(c.sum()), 5, "float")
    d = np.concatenate([lengths(20_000), np.zeros(100_000, np.int64), lengths(20_000)])
    layouts["run_of_100000_empty"] = (d, 0 * d, int(d.sum()), 5, "int")
    for r in (1, 2, 3):  # rows 1.. start off 16-byte boundaries
        e = lengths(50_001)
        layouts[f"total_mod_4_is_{r}"] = (e, 0 * e, int(e.sum()) + (r - int(e.sum())) % 4, 5,
                                          "float")
    f = lengths(150)
    layouts["total_below_one_block"] = (f, 0 * f, int(f.sum()) + 3, 5, "float")
    g = lengths(30_000)
    gaps = (rng.random(g.size) < 0.3) * rng.integers(1, 40, size=g.size)
    layouts["uncovered_gaps"] = (g, gaps, int((g + gaps).sum()) + 1_000, 5, "float")
    h = lengths(30_000)
    layouts["k_1"] = (h, 0 * h, int(h.sum()), 1, "int")
    layouts["k_16"] = (h, 0 * h, int(h.sum()), 16, "float")
    layouts["special_float_words"] = (h, 0 * h, int(h.sum()), 5, "special")
    layouts["denormal_float_words"] = (h, 0 * h, int(h.sum()), 14, "denormal")
    return layouts


def expand_edge_case(rng, layout) -> tuple:
    """(offsets, ends, cols [k, n], total) as numpy arrays for one layout of
    expand_edge_layouts."""
    lengths, gaps, total, k, kind = layout
    n = lengths.size
    offsets = (np.cumsum(gaps + lengths) - lengths).astype(np.int32)
    ends = (offsets + lengths).astype(np.int32)
    if kind == "int":
        cols = rng.integers(-2**31, 2**31 - 1, size=(k, n), dtype=np.int64).astype(np.int32)
    else:
        cols = (rng.normal(size=(k, n)) * 10.0 ** rng.integers(-6, 6, size=(k, n))).astype(
            np.float32)
    if kind == "special":
        words = cols.view(np.int32)
        pick = rng.random((k, n)) < 0.3
        words[pick] = np.array(SPECIAL_WORDS, np.uint32).view(np.int32)[
            rng.integers(0, len(SPECIAL_WORDS), size=int(pick.sum()))]
    if kind == "denormal":
        words = cols.view(np.uint32)
        pick = rng.random((k, n)) < 0.5
        sign = rng.integers(0, 2, size=int(pick.sum())).astype(np.uint32) << 31
        words[pick] = sign | rng.integers(1, DENORMAL_WORD_MAX + 1, size=int(pick.sum()),
                                          dtype=np.uint32)
    return offsets, ends, cols, total


def expand_intervals_edges(torch, dev) -> dict:
    """B6 against its plain version, bitwise as 32-bit words, on its edge
    layouts (``expand_edge_layouts``), each timed beside
    ``repeat_interleave``; with the windows of its blocks."""
    from gs_tpu_torch.ops import cuda_build, pairmove

    block = cuda_build.load("expand_intervals").gs_expand_intervals_block_slots()
    rng = np.random.default_rng(8)
    results = {}
    for name, layout in expand_edge_layouts(rng, block).items():
        offsets, ends, cols, total = (torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray)
                                      else x for x in expand_edge_case(rng, layout))
        got = pairmove.expand_intervals(offsets, ends, cols, total)
        ref = pairmove.expand_intervals_torch(offsets, ends, cols, total)
        same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        lengths = (ends - offsets).long()
        covered = int(lengths.sum())
        k_ms, lib_ms = timed_in_turns(
            torch, lambda: pairmove.expand_intervals(offsets, ends, cols, total),
            lambda: torch.repeat_interleave(cols, lengths, dim=1, output_size=covered),
            other_reps=20)
        r = dict(n=offsets.shape[0], k=cols.shape[0], dtype=str(cols.dtype), total=total,
                 slots_owned=covered, equal_to_plain=same,
                 windows=expand_windows(torch, offsets, total), ms=mean(k_ms), ms_runs=k_ms,
                 library_ms=mean(lib_ms), **expand_bound(offsets.shape[0], cols.shape[0], total))
        print(f"B6 edge layout {name}: {r}", flush=True)
        check(same, f"B6 equals its plain version bitwise on the edge layout {name}")
        results[name] = r
    return results



# --- P1, the preprocess's VJP (csrc/preprocess_bwd.cu) --------------------------------------


@functools.lru_cache(maxsize=1)
def port_inputs():
    """``tests/torch_port_inputs.py`` loaded from its file (a ``tests``
    package installed on the card's machine shadows ``import tests``): P1's
    edge inputs, ``ROW_RTOL`` and ``row_errors``."""
    spec = importlib.util.spec_from_file_location(
        "torch_port_inputs", os.path.join(ROOT, "tests", "torch_port_inputs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture_preprocess_bwd(store: list):
    """Record the arguments ``PreprocessFn.backward`` hands to the wrapper
    ``preprocess_cuda.preprocess_bwd``."""
    from gs_tpu_torch.ops import preprocess_cuda

    return capture_calls(preprocess_cuda, "preprocess_bwd", store)


def preprocess_edges(torch, dev) -> dict:
    """P1 against its plain version at degrees 0-4, on the edge inputs
    (``torch_port_inputs.preprocess_edge_inputs``) at N = 1, N = 3 blocks +
    37, N = 0 and N = 4096, with and without a depth cotangent: every row
    to ROW_RTOL, exact zeros exactly, the same bits on a second launch, one
    launch a call (none at N = 0). Needles the forward kept (a det that is
    all rounding, which the kernel's own recomputation need not reproduce)
    are held to finiteness only. Returns the worst errors."""
    from gs_tpu_torch.ops import cuda_build, preprocess_cuda

    pi = port_inputs()
    block = cuda_build.load("preprocess_bwd").gs_preprocess_bwd_block()
    worst: dict = {}
    cam = pi.preprocess_edge_camera(dev)
    for deg in range(5):
        k1 = (deg + 1) ** 2 - 1
        for n, rest in ((1, k1), (3 * block + 37, 24), (0, k1), (4096, k1)):
            leaves, cots = pi.preprocess_edge_inputs(n, rest, seed=1000 * deg + n, device=dev)
            with torch.no_grad():
                sp, _ = preprocess_cuda.plain_forward(*leaves, cam, 1.0, deg)
            kinds = torch.arange(n, device=dev) % len(pi.PREPROCESS_EDGE_KINDS)
            needle = (kinds == pi.PREPROCESS_EDGE_KINDS.index("degenerate")) & sp.mask
            for g_depths in (None, cots[3]):
                args = (*leaves, cam, 1.0, deg, sp.mask, *cots[:3], g_depths)
                before = cuda_build.LAUNCHES["preprocess_bwd"]
                got = preprocess_cuda.preprocess_bwd(*args)
                again = preprocess_cuda.preprocess_bwd(*args)
                torch.cuda.synchronize()
                check(cuda_build.LAUNCHES["preprocess_bwd"] == before + (2 if n else 0),
                      f"P1 launches at degree {deg}, n {n}")
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"P1 gives the same bits twice at degree {deg}, n {n}")
                check(p1_matches_reference(torch, args, got) is not False,
                      f"P1 gives the reference P1's bits at degree {deg}, n {n}")
                want = preprocess_cuda.preprocess_bwd_torch(*args)
                for name, e in pi.row_errors(got, want, ~needle).items():
                    check(e["rel"] <= pi.ROW_RTOL and e["zero_mismatch"] == 0,
                          f"P1 {name} at degree {deg}, n {n}: {e}")
                    w = worst.setdefault(name, dict(rel=0.0, zero_mismatch=0))
                    w["rel"] = max(w["rel"], e["rel"])
                check(all(bool(torch.isfinite(g[needle]).all()) for g in got),
                      f"P1 finite on needles at degree {deg}, n {n}")
    print(f"P1 edge inputs at degrees 0-4, worst rows: {worst}", flush=True)
    return worst


def preprocess_decisions(torch, xyz, log_scale, quat, f_dc, f_rest, cam, mod, deg):
    """The plain route's discrete decisions a Gaussian: in front and of
    positive det, x/z and y/z inside their clamps (closed), each colour
    channel unclamped; [N, 6] bool."""
    from gs_tpu_torch.ops import projection

    with torch.no_grad():
        e = projection.ewa(xyz, projection.compute_cov3d(log_scale, quat, mod), cam)
        col = projection.sh_colors(xyz, f_dc, f_rest, cam.cam_pos, deg)
        inside_x = (e.t[:, 0] / e.tz).abs() <= 1.3 * cam.tan_fovx
        inside_y = (e.t[:, 1] / e.tz).abs() <= 1.3 * cam.tan_fovy
        culls = torch.stack([e.in_front & (e.det > 0), inside_x, inside_y], 1)
        return torch.cat([culls, col > 0], 1)


def preprocess_exact(torch, args):
    """The exact VJP of the plain route on P1's arguments: autograd in
    float64 on the same float32 leaves and camera. Returns the leaves'
    gradients, the cotangent of the packed 3D covariance (the size of the
    terms that log_scale's and quat's gradients are summed from) and the
    rows where the float64 forward decides every cull and clamp as the
    float32 one did (a value on a clamp's edge may fall either side: the
    two are then different functions there, with no common gradient)."""
    from gs_tpu_torch.ops import projection

    leaves, cam, mod, deg = args[:5], args[5], args[6], args[7]
    cots = args[9:12]
    g_depths = args[12] if len(args) > 12 else None
    fields = {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}
    cam64 = dataclasses.replace(cam, **{k: v.double() for k, v in fields.items()
                                        if isinstance(v, torch.Tensor) and v.is_floating_point()})
    req = [t.detach().double().requires_grad_() for t in leaves]
    mod64 = mod.double() if isinstance(mod, torch.Tensor) else mod
    with torch.enable_grad():
        cov3d = projection.compute_cov3d(req[1], req[2], mod64)
        sp = projection.project_gaussians(req[0], cov3d, cam64)
        col = projection.sh_colors(req[0], req[3], req[4], cam64.cam_pos, deg)
        outs, gouts = [sp.means2d, sp.conics, col], [c.double() for c in cots]
        if g_depths is not None:
            outs.append(sp.depths)
            gouts.append(g_depths.double())
        grads = torch.autograd.grad(outs, req + [cov3d], gouts)
    same = (preprocess_decisions(torch, *leaves, cam, mod, deg)
            == preprocess_decisions(torch, *(t.detach() for t in req), cam64, mod64, deg))
    return grads[:5], grads[5], same.all(1) & (args[8] == sp.mask)


def preprocess_autograd(torch, args):
    """autograd's tape of the plain route on P1's arguments, in float32 (the
    contract), returned with a replay of its backward for timing."""
    from gs_tpu_torch.ops import preprocess_cuda

    leaves, cam, mod, deg = args[:5], args[5], args[6], args[7]
    cots = list(args[9:12])
    req = [t.detach().clone().requires_grad_() for t in leaves]
    with torch.enable_grad():
        sp, col = preprocess_cuda.plain_forward(*req, cam, mod, deg)
    outs = [sp.means2d, sp.conics, col]
    if len(args) > 12 and args[12] is not None:
        outs.append(sp.depths)
        cots.append(args[12])

    def replay():
        return torch.autograd.grad(outs, req, cots, retain_graph=True)

    return replay(), replay


def preprocess_rows(torch, got, exact, auto, g_cov, scale, quat, keep) -> dict:
    """P1's rows against the exact VJP: per leaf, the worst of a Gaussian's
    max |got - exact| over ROW_RTOL times the larger of its row's max
    |exact| and, for log_scale and quat, the size of the terms the row is
    summed from (s^2 max |g_cov3d|, over |quat| for quat): a near-isotropic
    Gaussian's rotation gradient is a difference of such terms, whatever its
    own size, and every float32 order rounds them alike. Then the zeros:
    autograd's exact zeros (``auto``, the float32 tape: the contract) that
    the exact VJP shares are the structural ones (a cull, a clamp, a
    degree), and ``got`` must have each (``missing_zeros``); the entries
    where ``got`` is 0 and the exact VJP is not, each as a share of its
    row's allowance; and the exact VJP's zeros that autograd does not have
    (a float64 cancellation), with the first one's row. Rows where ``keep``
    is False (the float64 forward culls otherwise) are left out."""
    pi = port_inputs()
    n = exact[0].shape[0]
    s2 = torch.exp(scale.double()) ** 2
    terms = s2.amax(1) * g_cov.abs().amax(1)
    extra = {"log_scale": terms, "quat": terms / quat.double().norm(dim=1)}
    s2 = s2[keep]
    iso = (s2.amax(1) - s2.amin(1)) / s2.amax(1)  # 0 for a sphere, -> 1 for a needle
    index = torch.nonzero(keep).flatten()
    out = {}
    for name, g, x, a in zip(pi.PREPROCESS_LEAVES, got, exact, auto):
        g, x = g.double().reshape(n, -1)[keep], x.reshape(n, -1)[keep]
        a = a.reshape(n, -1)[keep]
        row = x.abs().amax(1)
        allow = pi.ROW_RTOL * torch.maximum(row, extra[name][keep] if name in extra else row)
        err = (g - x).abs().amax(1)
        share = torch.where(allow > 0, err / allow, torch.where(err > 0, torch.inf, 0.0))
        rel = torch.where(row > 0, err / row, torch.where(err > 0, torch.inf, 0.0))
        past = rel > pi.ROW_RTOL
        extra_zero = (g == 0) & (x != 0)
        exact_only = (x == 0) & (a != 0)
        worst = torch.argsort(rel, descending=True)[:3]
        first = torch.nonzero(exact_only.any(1)).flatten()[:1].tolist()
        out[name] = dict(
            worst_share=float(share.max()), rel=float(rel.max()),
            rows_past_rtol_of_row=int(past.sum()),
            isotropy_of_those=dict(max=float(iso[past].max()), median=float(iso[past].median()))
            if bool(past.any()) else None,
            worst_rows=[dict(i=int(index[i]), rel=float(rel[i]), share=float(share[i]),
                             isotropy=float(iso[i])) for i in worst.tolist()],
            missing_zeros=int(((g != 0) & (x == 0) & (a == 0)).sum()),
            extra_zeros=int(extra_zero.sum()),
            extra_zeros_worst_share=float((x.abs() / allow[:, None])[extra_zero].max())
            if bool(extra_zero.any()) else 0.0,
            exact_only_zeros=int(exact_only.sum()),
            exact_only_first=[dict(i=int(index[i]), isotropy=float(iso[i]),
                                   quat=quat[index[i]].tolist(), got=g[i].tolist(),
                                   autograd=a[i].tolist(), exact=x[i].tolist())
                              for i in first])
    out["isotropy_median"] = float(iso.median())
    return out


def preprocess_bound(n: int, rest_rows: int) -> dict:
    """P1's least time: the five leaves read (f_rest's stored rows, as the
    kernel stages them whole), the cotangents of means2d, conics and
    colours and the valid mask read, the five gradients written, at the
    memory rate (497 B a Gaussian at 15 rest rows)."""
    read = 4 * (3 + 3 + 4 + 3 + 3 * rest_rows) + 4 * (2 + 3 + 3) + 1
    written = 4 * (3 + 3 + 4 + 3 + 3 * rest_rows)
    bytes_moved = n * (read + written)
    return dict(bound_ms=bytes_moved / PEAK_BYTES * 1e3, bound_by="bytes", bytes=bytes_moved)


def preprocess_path(torch, label: str, shape: str, args, launches: int) -> dict:
    """P1 on the arguments a train_step gave it (``capture_preprocess_bwd``):
    the kernel against the exact VJP (``preprocess_rows``: held), the same
    bits twice, its zeros of f_dc and f_rest the plain version's; the plain
    version and autograd's float32 tape against the exact VJP and the kernel
    against the plain version (reported); the kernel, the plain version and
    the tape's backward (the library's way: ``torch.autograd.grad`` of the
    plain route on the same cotangents) timed; the bytes bound."""
    from gs_tpu_torch.ops import preprocess_cuda

    pi = port_inputs()
    got = preprocess_cuda.preprocess_bwd(*args)
    again = preprocess_cuda.preprocess_bwd(*args)
    want = preprocess_cuda.preprocess_bwd_torch(*args)
    auto, replay = preprocess_autograd(torch, args)
    exact, g_cov, keep = preprocess_exact(torch, args)
    reference_bits = p1_matches_reference(torch, args, got)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    kernel = preprocess_rows(torch, got, exact, auto, g_cov, args[1], args[2], keep)
    tape = preprocess_rows(torch, auto, exact, auto, g_cov, args[1], args[2], keep)
    plain = preprocess_rows(torch, want, exact, auto, g_cov, args[1], args[2], keep)
    vs_plain = pi.row_errors(got, want)
    max_abs_err = max(float((g - w).abs().max()) if g.numel() else 0.0
                      for g, w in zip(got, want))
    del exact, g_cov, auto, want
    k_ms, p_ms = timed_in_turns(torch, lambda: preprocess_cuda.preprocess_bwd(*args),
                                lambda: preprocess_cuda.preprocess_bwd_torch(*args),
                                other_reps=5)
    lib_ms = [cuda_ms(replay, 5) for _ in range(2)]
    n, rest = args[0].shape[0], args[4].shape[1]
    r = dict(shape=shape, launches=launches, n=n, degree=args[7],
             valid_share=float(args[8].float().mean()),
             float64_decides_otherwise=int((~keep).sum()),
             max_abs_err=max_abs_err,
             vs_plain=vs_plain, vs_exact=kernel, autograd_vs_exact=tape,
             plain_vs_exact=plain, same_bits=same_bits, reference_bits=reference_bits,
             ms=mean(k_ms), ms_runs=k_ms, plain_ms=mean(p_ms), plain_ms_runs=p_ms,
             library_ms=mean(lib_ms), library_ms_runs=lib_ms,
             **preprocess_bound(n, rest))
    print(f"P1 {label}: {r}", flush=True)
    for name in pi.PREPROCESS_LEAVES:
        k = kernel[name]
        check(k["worst_share"] <= 1.0, f"P1 {name} rows against the exact VJP at {label}: {k}")
        check(k["missing_zeros"] == 0,
              f"P1 {name}: each of autograd's zeros that the exact VJP shares is 0 at {label}")
        if name in ("f_dc", "f_rest"):  # the same products as the plain version's
            check(vs_plain[name]["zero_mismatch"] == 0,
                  f"P1 {name}: the same zeros as the plain version at {label}")
    check(same_bits, f"P1 gives the same bits twice at {label}")
    check(reference_bits is not False, f"P1 gives the reference P1's bits at {label}")
    return r



def preprocess_fit_size(torch, dev) -> tuple[dict, dict]:
    """P1 and P2 at the benchmark fit's size, held and timed as on the train
    path's inputs (``preprocess_path``, ``preprocess_fwd_path``): P1_FIT_N Gaussians drawn as that cell's
    scene is (a ball of radius 2; log-scales N(log(0.35 x the mean
    spacing), 0.35^2) an axis, so some are near spheres; normal
    quaternions; SH 3, rest coefficients N(0, 0.05^2)) from
    ``torch.Generator`` seed P1_FIT_SEED, seen from z = 5 at 1237x822 with
    a 1160-px focal length, with normal cotangents."""
    from gs_tpu_torch import cameras
    from gs_tpu_torch.ops import preprocess_cuda
    from gs_tpu_torch.ops.sh import C0

    n, width, height, focal = P1_FIT_N, 1237, 822, 1160.0
    gen = torch.Generator(device=dev).manual_seed(P1_FIT_SEED)
    f32 = dict(generator=gen, device=dev, dtype=torch.float32)
    direction = torch.randn(n, 3, **f32)
    xyz = direction / torch.linalg.norm(direction, dim=1, keepdim=True) * (
        2.0 * torch.rand(n, 1, **f32) ** (1.0 / 3.0))
    spacing = (4.0 / 3.0 * math.pi * 2.0 ** 3 / n) ** (1.0 / 3.0)
    log_scale = math.log(0.35 * spacing) + 0.35 * torch.randn(n, 3, **f32)
    quat = torch.randn(n, 4, **f32)
    f_dc = (torch.rand(n, 1, 3, **f32) - 0.5) / C0
    f_rest = 0.05 * torch.randn(n, 15, 3, **f32)
    cots = [torch.randn(n, c, **f32) for c in (2, 3, 3)]
    cam = cameras.make_camera(np.eye(3), np.array([0.0, 0.0, 5.0]),
                              fovx=2 * math.atan(width / (2 * focal)),
                              fovy=2 * math.atan(height / (2 * focal)), width=width,
                              height=height, device=dev)
    leaves = (xyz, log_scale, quat, f_dc, f_rest)
    with torch.no_grad():
        sp, _ = preprocess_cuda.plain_forward(*leaves, cam, 1.0, 3)
    shape = f"{n} Gaussians, SH 3, {width}x{height}"
    args = (*leaves, cam, 1.0, 3, sp.mask, *cots, None)
    p2 = preprocess_fwd_path(torch, "fit size", shape, args, launches=0)
    return preprocess_path(torch, "fit size", shape, args, launches=0), p2

@functools.lru_cache(maxsize=1)
def p1_reference():
    """P1 built from ``P1_REFERENCE``'s preprocess_bwd.cu (into build/, typed as
    this tree's), or None without one."""
    import ctypes

    from gs_tpu_torch.ops import cuda_build

    if P1_REFERENCE is None:
        return None
    so = os.path.join(cuda_build.BUILD_DIR, "p1_reference.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                    os.path.join(P1_REFERENCE, "preprocess_bwd.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.gs_preprocess_bwd.argtypes = cuda_build.LIBRARIES["preprocess_bwd"].argtypes
    lib.gs_preprocess_bwd.restype = ctypes.c_int
    return lib


def p1_matches_reference(torch, args, got):
    """Whether the reference P1 (``p1_reference``), run through this tree's
    wrapper on ``args``, gives ``got``'s bits; None without a reference."""
    from gs_tpu_torch.ops import cuda_build, preprocess_cuda

    ref = p1_reference()
    if ref is None:
        return None
    own, count = cuda_build.load("preprocess_bwd"), cuda_build.LAUNCHES["preprocess_bwd"]
    cuda_build._libs["preprocess_bwd"] = ref
    try:
        want = preprocess_cuda.preprocess_bwd(*args)
    finally:
        cuda_build._libs["preprocess_bwd"] = own
        cuda_build.LAUNCHES["preprocess_bwd"] = count
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, want))


# --- P2, the preprocess's forward (csrc/preprocess_fwd.cu) ----------------------------------


P2_FLOATS = ("means2d", "depths", "conics", "colors")


def float_steps(torch, got, want) -> tuple[int, float]:
    """The entries whose 32-bit words differ, and the largest distance among
    them in float32 steps (inf where one side is not finite)."""
    g, w = got.reshape(-1), want.reshape(-1)
    off = g.view(torch.int32) != w.view(torch.int32)
    if not bool(off.any()):
        return 0, 0.0
    g, w = g[off], w[off]
    if not bool((torch.isfinite(g) & torch.isfinite(w)).all()):
        return int(off.sum()), math.inf

    def ordered(t):
        i = t.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(off.sum()), float((ordered(g) - ordered(w)).abs().max())


def einsum_order(torch, xyz, f_dc, f_rest, cam, deg):
    """Per Gaussian, whether the plain route's colour einsum adds in the
    order P2 takes (csrc/preprocess_forward.cuh's sh_rgb: each half of k
    with fused multiply-adds from 0, then the halves; emulated in float64,
    whose double rounding may flag a few Gaussians more), and the scale of
    its sum, max(|rgb + 0.5|, sum_k |basis_k f_k|) a channel. cuBLAS takes
    that order in its gemv2N kernel and another in the kernels it runs
    beside it at some N (262,144 and 1,048,576 Gaussians at SH 3)."""
    from gs_tpu_torch.ops import sh as sh_ops

    k = (deg + 1) ** 2
    with torch.no_grad():
        dirs = xyz - cam.cam_pos
        d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp(min=1e-12)
        basis = torch.cat(sh_ops.eval_sh_basis(deg, d), dim=-1)[:, :, None].double()
        feats = torch.cat([f_dc, f_rest], dim=1)[:, :k].double()
        rgb = torch.einsum("nk,nkc->nc", basis[:, :, 0].float(), feats.float())
        halves = []
        for lo, hi in ((0, (k + 1) // 2), ((k + 1) // 2, k)):
            acc = torch.zeros_like(rgb)
            for i in range(lo, hi):
                acc = (basis[:, i] * feats[:, i] + acc.double()).float()
            halves.append(acc)
        scale = torch.maximum((basis * feats).abs().sum(1).float(), (rgb + 0.5).abs())
        return (halves[0] + halves[1] == rgb).all(-1), scale


def near_integer_radii(torch, leaves, cam, mod):
    """Per Gaussian, whether the plain route's 3 sqrt(lambda_max) lies within
    one float32 step of an integer (where its ceiling may fall either way)."""
    from gs_tpu_torch.ops import projection

    with torch.no_grad():
        e = projection.ewa(leaves[0], projection.compute_cov3d(leaves[1], leaves[2], mod), cam)
        mid = 0.5 * (e.c_xx + e.c_yy)
        x = 3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp(mid * mid - e.det, min=0.1)))
        step = torch.nextafter(x, torch.full_like(x, math.inf)) - x
        return (x - torch.round(x)).abs() <= step


def preprocess_fwd_compare(torch, args) -> dict:
    """P2 (``preprocess_fwd``) against the plain forward on the card, on the
    forward's arguments ``args`` (leaves, camera, modifier, degree): the
    mask's mismatches, the radii's (and those not where 3 sqrt(lambda_max)
    is within a step of an integer), each float output's differing entries
    and their largest distance in float32 steps; for the colours, those
    over the Gaussians whose einsum adds in P2's order (``einsum_order``),
    and over the others the largest difference in steps of the sum's
    scale; the same bits on a second launch; the launches (two)."""
    from gs_tpu_torch.ops import cuda_build, preprocess_cuda

    before = cuda_build.LAUNCHES["preprocess_fwd"]
    with torch.no_grad():
        got = preprocess_cuda.preprocess_fwd(*args)
        again = preprocess_cuda.preprocess_fwd(*args)
        want = preprocess_cuda.plain_forward(*args)
    torch.cuda.synchronize()
    launches = cuda_build.LAUNCHES["preprocess_fwd"] - before
    (sp, col), (sp2, col2), (wsp, wcol) = got, again, want
    words = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t  # noqa: E731
    n = args[0].shape[0]
    radii_off = sp.radii != wsp.radii
    near = near_integer_radii(torch, args[:5], args[5], args[6])
    r = dict(n=n, degree=args[7], launches=launches,
             same_bits=all(torch.equal(words(a), words(b))
                           for a, b in zip((*sp, col), (*sp2, col2))),
             valid_share=float(wsp.mask.float().mean()) if n else 0.0,
             mask_off=int((sp.mask != wsp.mask).sum()), radii_off=int(radii_off.sum()),
             radii_near_integer=int(near.sum()),
             radii_off_elsewhere=int((radii_off & ~near).sum()))
    same_order, scale = einsum_order(torch, args[0], args[3], args[4], args[5], args[7])
    err = 0.0
    for name, g, w in zip(P2_FLOATS, (sp.means2d, sp.depths, sp.conics, col),
                          (wsp.means2d, wsp.depths, wsp.conics, wcol)):
        if name == "colors":
            g, w = g[same_order], w[same_order]
        r[f"{name}_off"], r[f"{name}_max_steps"] = float_steps(torch, g, w)
        fin = torch.isfinite(w) & torch.isfinite(g)
        if bool(fin.any()):
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    other = ~same_order
    gap = (col[other] - wcol[other]).abs()
    step = torch.nextafter(scale[other], torch.full_like(scale[other], math.inf)) - scale[other]
    r.update(colors_other_order=int(other.sum()),
             colors_other_order_off=int((gap > 0).any(-1).sum()),
             colors_other_order_max_steps=float_steps(torch, col[other], wcol[other])[1],
             colors_other_order_max_scale_steps=float((gap / step).max()) if gap.numel()
             else 0.0)
    r["max_abs_err"] = max(err, float(gap.max()) if gap.numel() else 0.0)
    return r


def check_fwd(r: dict, where: str) -> None:
    """P2's correctness rules on a ``preprocess_fwd_compare`` record."""
    check(r["launches"] == (2 if r["n"] else 0), f"P2 launches once a call at {where}: {r}")
    check(r["same_bits"], f"P2 gives the same bits twice at {where}")
    check(r["mask_off"] == 0, f"P2's mask is the plain forward's bit for bit at {where}: {r}")
    check(r["radii_off_elsewhere"] == 0,
          f"P2's radii are the plain forward's but within a step of an integer at {where}: {r}")
    for name in P2_FLOATS:
        check(r[f"{name}_max_steps"] <= P2_MAX_STEPS,
              f"P2's {name} within {P2_MAX_STEPS} float32 steps of the plain forward at "
              f"{where}: {r}")
    check(r["colors_other_order_max_scale_steps"] <= P2_MAX_STEPS,
          f"P2's colours within {P2_MAX_STEPS} float32 steps of their sum's scale where "
          f"cuBLAS adds in another order, at {where}: {r}")


def preprocess_fwd_bound(n: int, rest_rows: int) -> dict:
    """P2's least time: the five leaves read (f_rest's stored rows, as the
    kernel stages them whole), means2d, depths, conics, radii, the mask and
    the colours written, at the memory rate (273 B a Gaussian at 15 rest
    rows)."""
    read = 4 * (3 + 3 + 4 + 3 + 3 * rest_rows)
    written = 4 * (2 + 1 + 3 + 1 + 3) + 1
    bytes_moved = n * (read + written)
    return dict(bound_ms=bytes_moved / PEAK_BYTES * 1e3, bound_by="bytes", bytes=bytes_moved)


def preprocess_fwd_edges(torch, dev) -> dict:
    """P2 against the plain forward at degrees 0-4 on the edge inputs
    (``torch_port_inputs.preprocess_edge_inputs``: culled, clamped,
    degenerate, dead, a centre on the camera) at N = 1, 3 blocks + 37, 0
    and 4096, with the active degree's rest rows and with 24, the scaling
    modifier 1 and (3 blocks + 37) a 0-d tensor of 0.9: held by
    ``check_fwd``. Returns the differences summed over the cases."""
    from gs_tpu_torch.ops import cuda_build

    pi = port_inputs()
    block = cuda_build.load("preprocess_fwd").gs_preprocess_fwd_block()
    cam = pi.preprocess_edge_camera(dev)
    total = dict(cases=0, radii_off=0, **{f"{k}_off": 0 for k in P2_FLOATS},
                 **{f"{k}_max_steps": 0.0 for k in P2_FLOATS})
    for deg in range(5):
        for n in (1, 3 * block + 37, 0, 4096):
            mod = torch.tensor(0.9, device=dev) if n == 3 * block + 37 else 1.0
            for rest in sorted({(deg + 1) ** 2 - 1, 24}):
                leaves, _ = pi.preprocess_edge_inputs(n, rest, seed=1000 * deg + n + rest,
                                                      device=dev)
                r = preprocess_fwd_compare(torch, (*leaves, cam, mod, deg))
                check_fwd(r, f"edge inputs, degree {deg}, n {n}, {rest} rest rows")
                total["cases"] += 1
                for key in total:
                    if key.endswith("_off"):
                        total[key] += r[key]
                    elif key.endswith("_max_steps"):
                        total[key] = max(total[key], r[key])
    print(f"P2 edge inputs at degrees 0-4: {total}", flush=True)
    return total


def preprocess_fwd_path(torch, label: str, shape: str, args, launches: int) -> dict:
    """P2 on the leaves, camera, modifier and degree a train_step gave P1
    (``capture_preprocess_bwd``'s record ``args``): held against the plain
    forward by ``check_fwd``, the two timed in turns, the bytes bound."""
    from gs_tpu_torch.ops import preprocess_cuda

    fwd_args = tuple(args[:8])
    r = preprocess_fwd_compare(torch, fwd_args)
    check_fwd(r, label)

    def plain():
        with torch.no_grad():
            preprocess_cuda.plain_forward(*fwd_args)

    k_ms, p_ms = timed_in_turns(torch, lambda: preprocess_cuda.preprocess_fwd(*fwd_args), plain,
                                other_reps=5)
    r.update(shape=shape, launches=launches, ms=mean(k_ms), ms_runs=k_ms, plain_ms=mean(p_ms),
             plain_ms_runs=p_ms, **preprocess_fwd_bound(r["n"], args[4].shape[1]))
    r["bound_share"] = r["bound_ms"] / r["ms"]
    print(f"P2 {label}: {r}", flush=True)
    return r


def carry_path(torch, label, shape, state, cam, cam_t, bg, cfg, form) -> dict:
    """The carry pair source (PAIR_SOURCE="carry"): one eval_render and one
    train_step, counts reset just before and read just after each (the render:
    B6 beside the forward kernel of ``form``; the step: B6, B5 and both
    compositing kernels); the render bitwise equal to the gather path's; the
    step's first Adam moments (0.1 x the gradients) bitwise equal to the
    gather's under GRAD_REDUCE="cuda" (the same cotangent through the same
    B5) and within GRAD_RTOL + GRAD_ATOL_SHARE x max of the "scatter" step's;
    the carried table bitwise equal to attr_pad[pair_gauss]; carry's B6 (14
    columns) bitwise equal to its plain version and its B5 to the CPU's;
    then the forward gather, both binnings and both train_steps timed in
    turns, and B5 / B6 beside their plain versions and library calls."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.ops import binning, cuda_build, pairmove, rasterize_tiled

    opt = OptimizationParams()
    ts0 = training.init_train_state(state, 1.0, 3)

    def step(source, reduce):
        with switches(grad_reduce=reduce, pair_source=source):
            return training.train_step(ts0.state, ts0.adam, ts0.stats, cam_t, bg, 0, 1.0,
                                       active_sh_degree=3, opt_cfg=opt, raster_cfg=cfg,
                                       accumulate_stats=True)

    carry_calls, exp_calls, seg_calls = [], [], []
    reset_launches()
    with switches(pair_source="carry"), \
            capture_calls(rasterize_tiled, "bin_carry_pairs", carry_calls), \
            capture_calls(pairmove, "expand_intervals", exp_calls):
        img = training.eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=cfg)
    torch.cuda.synchronize()
    render_launches = dict(cuda_build.LAUNCHES)
    reset_launches()
    with capture_calls(pairmove, "segment_reduce_sorted", seg_calls):
        adam_c, m = step("carry", "scatter")[1::2]
    torch.cuda.synchronize()
    train_launches = dict(cuda_build.LAUNCHES)
    print(f"{label} PAIR_SOURCE=carry: render launches {render_launches}; train_step launches "
          f"{train_launches}, loss {float(m['loss']):.6f}", flush=True)
    check(render_launches == launches_of(expand_intervals=1, preprocess_fwd=1, **{form[0]: 1}),
          f"one B6 launch beside the forward kernel per carry render at {label}")
    check(train_launches == launches_of(expand_intervals=1, segment_reduce=1, preprocess_fwd=1,
                                        preprocess_bwd=1, **{k: 1 for k in form}),
          f"one B6, one B5 and one launch of each compositing kernel per carry train_step at "
          f"{label}")
    check(math.isfinite(float(m["loss"])), f"finite carry loss at {label}")
    default_img = training.eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=cfg)
    same_img = torch.equal(img, default_img)
    del img, default_img

    # gradients: gather with B5 (bitwise), gather with autograd's scatter (tolerance)
    mu_g = step("gather", "cuda")[1].mu
    same_grads = all(torch.equal(adam_c.mu[k], mu_g[k]) for k in mu_g)
    del mu_g
    mu_s = step("gather", "scatter")[1].mu
    grad_share = 0.0
    for name, b in mu_s.items():
        allowed = GRAD_RTOL * b.abs() + GRAD_ATOL_SHARE * b.abs().max()
        err = (adam_c.mu[name] - b).abs()
        grad_share = max(grad_share, float((err / allowed.clamp(min=1e-30))
                                           .masked_fill(err == 0, 0.0).max()))
    del mu_s, adam_c

    # the carried table, and B6 / B5 on carry's inputs
    cs, attr, means2d, depths, radii_b, col_offset = carry_calls[0]
    check(col_offset == 0 and cs.col_stride == 1, "the whole frame bins every tile column")

    def carry_binning():
        return binning.bin_gaussians_aligned(
            means2d, depths, radii_b, cs.tiles_x, cs.tiles_y, cs.tile_w, cs.tile_h,
            cs.pair_budget, cs.align, count_by_gauss=True, expand_impl="cuda", carry_attr=attr)

    def gather_binning():
        return binning.bin_gaussians_aligned(
            means2d, depths, radii_b, cs.tiles_x, cs.tiles_y, cs.tile_w, cs.tile_h,
            cs.pair_budget, cs.align, count_by_gauss=True)

    carried, gathered = carry_binning(), gather_binning()
    attr_pad = torch.cat([attr, attr.new_zeros(1, attr.shape[1])])
    same_table = torch.equal(carried.pair_attr.view(torch.int32),
                             attr_pad[gathered.pair_gauss].view(torch.int32))
    del carried
    offsets, ends, cols, total = exp_calls[0]
    b6 = pairmove.expand_intervals(offsets, ends, cols, total)
    plain = pairmove.expand_intervals_torch(offsets, ends, cols, total)
    same_b6 = torch.equal(b6, plain)
    b6_err = float((b6.double() - plain.double()).abs().max())
    del b6, plain
    rows, seg_cum, n = seg_calls[0]
    counts = torch.diff(seg_cum.long(), prepend=seg_cum.new_zeros(1, dtype=torch.int64))
    vs_cpu = segred_against_cpu(torch, pairmove.segment_reduce_sorted(rows, seg_cum, n),
                                pairmove.segment_reduce_torch(rows.cpu(), seg_cum.cpu(), n),
                                counts.cpu())
    torch.cuda.synchronize()
    print(f"{label} carry: render equal to the gather's bitwise {same_img}; gradients equal to "
          f"gather + GRAD_REDUCE=cuda bitwise {same_grads}, worst {grad_share:.3g} of rtol "
          f"{GRAD_RTOL} + {GRAD_ATOL_SHARE} x max against the scatter step; carried table equal "
          f"to attr_pad[pair_gauss] bitwise {same_table}; B6 ({cols.shape[0]} {cols.dtype} "
          f"columns) equal to plain bitwise {same_b6}; B5 vs the CPU plain version {vs_cpu}",
          flush=True)
    check(same_img, f"the carry render equals the gather render bitwise at {label}")
    check(same_grads, f"carry gradients equal gather + GRAD_REDUCE=cuda bitwise at {label}")
    check(grad_share <= 1.0, f"carry gradients vs the scatter step at {label}")
    check(same_table, f"the carried table equals attr_pad[pair_gauss] bitwise at {label}")
    check(same_b6, f"carry's B6 equals its plain version bitwise at {label}")
    check(vs_cpu["row_order_equal"] and vs_cpu["long_within_one_rounding"],
          f"carry's B5 matches its plain version on the CPU at {label}")

    # times in turns
    pair_gauss = gathered.pair_gauss
    del gathered
    gather_ms, _ = timed_in_turns(torch, lambda: attr_pad[pair_gauss],
                                  lambda: pairmove.expand_intervals(offsets, ends, cols, total))
    carry_bin_ms, gather_bin_ms = timed_in_turns(
        torch, carry_binning, lambda: attr_pad[gather_binning().pair_gauss], kernel_reps=10,
        other_reps=10)
    step_carry, step_gather = timed_in_turns(torch, lambda: step("carry", "scatter"),
                                             lambda: step("gather", "cuda"), kernel_reps=2,
                                             other_reps=2)
    b6_ms, b6_plain = timed_in_turns(torch, lambda: pairmove.expand_intervals(offsets, ends, cols,
                                                                              total),
                                     lambda: pairmove.expand_intervals_torch(offsets, ends, cols,
                                                                             total), other_reps=20)
    lengths = (ends - offsets).long()
    covered = int(lengths.sum())
    b6_lib, _ = timed_in_turns(
        torch, lambda: torch.repeat_interleave(cols, lengths, dim=1, output_size=covered),
        lambda: pairmove.expand_intervals(offsets, ends, cols, total))
    b5_ms, b5_plain = timed_in_turns(torch, lambda: pairmove.segment_reduce_sorted(rows, seg_cum, n),
                                     lambda: pairmove.segment_reduce_torch(rows, seg_cum, n),
                                     other_reps=3)
    rows_read = int(seg_cum[-1])
    ids_sorted = torch.repeat_interleave(torch.arange(n, device=rows.device), counts)
    zeros = torch.zeros((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    b5_lib, _ = timed_in_turns(
        torch, lambda: torch.zeros_like(zeros).index_add_(0, ids_sorted, rows[:rows_read]),
        lambda: pairmove.segment_reduce_sorted(rows, seg_cum, n))
    common = dict(shape=shape, render_equal_to_gather=same_img,
                  grads_equal_to_gather_cuda=same_grads, grad_worst_share_vs_scatter=grad_share,
                  table_equal_to_gather=same_table, render_launches=render_launches,
                  train_launches=train_launches, forward_gather_ms=mean(gather_ms),
                  forward_gather_ms_runs=gather_ms, carry_binning_ms=mean(carry_bin_ms),
                  carry_binning_ms_runs=carry_bin_ms, gather_binning_and_gather_ms=mean(
                      gather_bin_ms), gather_binning_and_gather_ms_runs=gather_bin_ms,
                  train_step_carry_ms=mean(step_carry), train_step_carry_ms_runs=step_carry,
                  train_step_gather_cuda_ms=mean(step_gather),
                  train_step_gather_cuda_ms_runs=step_gather)
    expand = dict(common, launches=render_launches["expand_intervals"]
                  + train_launches["expand_intervals"], max_abs_err=b6_err,
                  equal_to_plain=same_b6, columns=cols.shape[0], intervals=offsets.shape[0],
                  slots=total, slots_owned=covered, ms=mean(b6_ms), ms_runs=b6_ms,
                  plain_ms=mean(b6_plain), plain_ms_runs=b6_plain, library_ms=mean(b6_lib),
                  **expand_bound(offsets.shape[0], cols.shape[0], total))
    reduce = dict(common, launches=train_launches["segment_reduce"],
                  max_abs_err=float((pairmove.segment_reduce_sorted(rows, seg_cum, n).cpu()
                                     - pairmove.segment_reduce_torch(rows.cpu(), seg_cum.cpu(),
                                                                     n)).abs().max()),
                  equal_to_plain=vs_cpu["equal_to_plain"], ms=mean(b5_ms), ms_runs=b5_ms,
                  plain_ms=mean(b5_plain), plain_ms_runs=b5_plain, library_ms=mean(b5_lib),
                  **segment_sums_bound(rows_read, n, rows.shape[1]))
    print(f"time {label} carry: forward gather attr_pad[pair_gauss] {common['forward_gather_ms']:.4f}"
          f" ms (runs {gather_ms}); carry binning {common['carry_binning_ms']:.3f} ms vs gather "
          f"binning + gather {common['gather_binning_and_gather_ms']:.3f} ms; train_step carry "
          f"{common['train_step_carry_ms']:.3f} ms (runs {step_carry}) vs gather + cuda "
          f"{common['train_step_gather_cuda_ms']:.3f} ms (runs {step_gather}); B6 "
          f"{expand['ms']:.4f} ms ({cols.shape[0]} columns, bound {expand['bound_ms']:.4f} ms), "
          f"plain {expand['plain_ms']:.3f} ms, repeat_interleave {expand['library_ms']:.4f} ms; "
          f"B5 {reduce['ms']:.4f} ms (bound {reduce['bound_ms']:.4f} ms), plain "
          f"{reduce['plain_ms']:.3f} ms, index_add_ {reduce['library_ms']:.4f} ms", flush=True)
    return dict(expand=expand, reduce=reduce)


# the CLI phase's dataset: COLMAP views of the bench scene on an arc about the
# bench camera (at z = 5, looking at the origin), every view 1920x1080
CLI_VIEWS = 10
CLI_ARC_DEG = 30.0
CLI_TRAIN_ARGS = ("-r", "1", "--eval", "--sh_degree", "3", "--iterations", "30",
                  "--densify_from_iter", "10", "--densification_interval", "10",
                  "--opacity_reset_interval", "25", "--test_iterations", "30",
                  "--save_iterations", "15", "30", "--quiet")
# run 3 of PR 9 (NVIDIA H100 80GB HBM3, 700 W): the CLI without the autotune, the
# default gather + "scatter" path: median-free step ranges by form and it/s
PR9_CLI = ("steps 163-184 ms in the chunk form, 790-847 ms in the tile form, 2,096-2,243 ms "
           "after the opacity reset; 1.23 / 1.14 it/s (train / resumed)")


def cli_dataset(torch, dev, root) -> None:
    """Write a COLMAP dataset (binary) under ``root``: CLI_VIEWS PINHOLE
    1920x1080 views on an arc about the bench camera, their ground truth
    rendered by the port from the ``default_rng(1)`` bench draw (budget grown
    to 1.05 x each view's pairs) and written as PNG, and ``points3D.bin``
    holding the ``default_rng(0)`` draw's means with their colours."""
    from gs_tpu_torch import cameras
    from gs_tpu_torch.cli.render import save_png
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.data import colmap
    from gs_tpu_torch.renderer import render
    from gs_tpu_torch.training import eval_render

    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    fx = cameras.fov_to_focal(math.radians(70), WIDTH)
    fy = cameras.fov_to_focal(math.radians(46), HEIGHT)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", WIDTH, HEIGHT,
                                   np.array([fx, fy, WIDTH / 2, HEIGHT / 2]))}
    gt_state = make_bench_state(dev, 1)
    bg = torch.zeros(3, device=dev)
    imgs = {}
    for i in range(CLI_VIEWS):
        ang = math.radians(CLI_ARC_DEG) * (i / (CLI_VIEWS - 1) - 0.5)
        qvec = np.array([math.cos(ang / 2), 0.0, math.sin(ang / 2), 0.0])
        tvec = np.array([0.0, 0.0, 5.0])
        name = f"view_{i:03d}.png"
        imgs[i + 1] = colmap.ColmapImage(i + 1, qvec, tvec, 1, name)
        cam = cameras.make_camera(colmap.qvec_to_rotmat(qvec).T, tvec,
                                  cameras.focal_to_fov(fx, WIDTH), cameras.focal_to_fov(fy, HEIGHT),
                                  WIDTH, HEIGHT, device=dev)
        cfg = RasterizeConfig()
        pairs = int(render(cam, gt_state, active_sh_degree=3, bg_color=bg, cfg=cfg).num_pairs)
        cfg = dataclasses.replace(cfg, pair_budget_factor=1.05 * pairs / N_GAUSS)
        save_png(os.path.join(root, "images", name),
                 eval_render(gt_state, cam, bg, active_sh_degree=3, raster_cfg=cfg))
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(imgs, os.path.join(sparse, "images.bin"))
    rng = np.random.default_rng(0)  # make_bench_state's draw, in its order
    pts = rng.uniform(-2, 2, size=(N_GAUSS, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(N_GAUSS, 3)).astype(np.float32)
    colmap.write_points3d_binary(pts.astype(np.float64), np.round(cols * 255).astype(np.uint8),
                                 os.path.join(sparse, "points3D.bin"))


@contextlib.contextmanager
def record_steps(store: dict):
    """Record, for every training.train_step (its loss, not read until the
    block ends, and its wall time between two synchronizations) and every
    compositing call outside the startup autotune (its kernel form and pair
    buffer rows), what the CLI drove, without keeping their tensors."""
    import torch

    from gs_tpu_torch import training
    from gs_tpu_torch.ops import rasterize_tiled

    step, composite = training.train_step, rasterize_tiled.composite_tiles

    def recording_step(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        store["step_ms"].append((time.perf_counter() - t0) * 1e3)
        store["losses"].append(out[3]["loss"])
        return out

    def recording_composite(st, sp_attr, *args):
        if not store.get("in_sweep"):  # the startup autotune's calls are counted apart
            store["forms"].append((st.kernel_mode, sp_attr.shape[0]))
        return composite(st, sp_attr, *args)

    training.train_step, rasterize_tiled.composite_tiles = recording_step, recording_composite
    try:
        yield store
    finally:
        training.train_step, rasterize_tiled.composite_tiles = step, composite


@contextlib.contextmanager
def record_viewers(store: list):
    """Record every GuiServer the train CLI starts."""
    from gs_tpu_torch.viewer import network_gui

    real = network_gui.GuiServer

    def server(*args, **kwargs):
        store.append(real(*args, **kwargs))
        return store[-1]

    network_gui.GuiServer = server
    try:
        yield store
    finally:
        network_gui.GuiServer = real


def cli_phase(torch, dev) -> dict:
    """The train, render, metrics and full-eval CLIs at full width: a COLMAP
    dataset (``cli_dataset``), ``cli.train.main`` with CLI_TRAIN_ARGS (30
    steps, a checkpoint at 15; the default viewer and kernel autotune on), a
    second run resumed from ``chkpnt15.npz`` to 30 with the images kept on
    the CPU (``--data_device cpu``), ``cli.render.main`` at iteration 30,
    ``cli.metrics.main`` and ``cli.full_eval.main`` on its renders; then the
    viewer (``viewer_phase``) and the profiler (``profiler_phase``) on the
    same dataset. Counts reset just before each CLI and read just after;
    each run's startup sweep is recorded and counted apart
    (``record_autotune``, ``check_sweep``) and the globals it leaves are put
    back after the run (``switches``). Checks the files, the viewer started
    and closed, the restored state against the checkpoint (bitwise), finite
    losses, 2 test and 8 train renders, each PNG under renders/ against
    save_png of eval_render on the saved PLY (bitwise), a forward and a
    backward compositing launch for every step in the winner's form and,
    under the winner's carry pair source, B5 a step and B6 a render, the
    metrics (``metrics_phase``), and that stdout is the process's own
    afterwards."""
    from gs_tpu_torch.cli import render as render_cli
    from gs_tpu_torch.cli import train as train_cli
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.utils import ckpt

    t_phase = time.perf_counter()
    stdout = sys.stdout
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as work:
        data, model, resumed = (os.path.join(work, d) for d in ("colmap", "model", "resumed"))
        t0 = time.perf_counter()
        cli_dataset(torch, dev, data)
        data_s = time.perf_counter() - t0

        runs = {}
        restored = []
        load = ckpt.load_train_state

        def load_and_record(*args, **kwargs):
            ts = load(*args, **kwargs)
            restored.append(ckpt.to_flat_dict(ts))
            return ts

        for name, extra in (("train", ("-m", model, "--checkpoint_iterations", "15")),
                            ("resume", ("-m", resumed, "--data_device", "cpu",
                                        "--start_checkpoint",
                                        os.path.join(model, "chkpnt15.npz")))):
            store = {"losses": [], "forms": [], "step_ms": []}
            viewers = []
            reset_launches()
            ckpt.load_train_state = load_and_record
            t0 = time.perf_counter()
            try:
                with switches(), record_autotune(store), record_steps(store), \
                        record_viewers(viewers):
                    ts = train_cli.main(["-s", data, *CLI_TRAIN_ARGS, *extra], device=dev)
                torch.cuda.synchronize()
            finally:
                ckpt.load_train_state = load
            wall = time.perf_counter() - t0
            check(len(store["sweeps"]) == 1, f"one startup sweep ({name})")
            sweep = check_sweep(store["sweeps"][0], f"cli {name}")
            losses = [float(v) for v in store["losses"]]
            # each step's kernel form: the compositing calls less the evaluation's renders,
            # which come after the last step
            step_forms = [f for f, _ in store["forms"][:len(losses)]]
            by_form = {form: sorted(ms for ms, f in zip(store["step_ms"], step_forms) if f == form)
                       for form in ("chunk", "tile")}
            median_ms = {form: v[len(v) // 2] for form, v in by_form.items() if v}
            launches = {k: v - sweep["launches"][k] for k, v in cuda_build.LAUNCHES.items()}
            train_s = wall - sweep["wall_s"]
            runs[name] = r = dict(wall_s=wall, train_wall_s=train_s, steps=len(losses),
                                  it_per_s=len(losses) / train_s, losses=losses,
                                  launches=launches, autotune=sweep,
                                  iteration=ts.iteration, alive=int(ts.state.num_alive),
                                  capacity=ts.state.capacity, forms=store["forms"],
                                  step_ms=store["step_ms"], median_step_ms=median_ms,
                                  viewer=[(v.host, v.port) for v in viewers])
            check(sys.stdout is stdout, f"stdout is the process's own after cli.train ({name})")
            check(len(viewers) == 1 and (viewers[0].host, viewers[0].port) == ("127.0.0.1", 6009)
                  and viewers[0].listener.fileno() == -1 and viewers[0].conn is None,
                  f"the default viewer listened on 127.0.0.1:6009 and was closed ({name})")
            print(f"cli {name}: {r['steps']} steps in {train_s:.2f} s after the "
                  f"{sweep['wall_s']:.2f} s sweep ({r['it_per_s']:.2f} it/s under "
                  f"{sweep['winner']}, the Scene's loading and the evaluation included; PR 9 "
                  f"run 3 without the sweep: {PR9_CLI}); median step {median_ms} ms by "
                  f"kernel form (each step between two synchronizations: {store['step_ms']}); "
                  f"losses {losses}; launches less the sweep's {launches}; alive {r['alive']} of "
                  f"{r['capacity']}; compositing calls (form, pair rows) {store['forms']}",
                  flush=True)
            del ts
        check(runs["train"]["steps"] == 30 and runs["resume"]["steps"] == 15,
              "30 steps, then 15 resumed from the iteration-15 checkpoint")
        for name, r in runs.items():
            check(all(math.isfinite(v) for v in r["losses"]), f"finite CLI losses ({name})")
            la = r["launches"]
            renders = len(r["forms"]) - r["steps"]  # the evaluation's renders at iteration 30
            carry = r["autotune"]["pair_source"] == "carry"
            check(la["composite_bwd"] + la["composite_bwd_tile"] == r["steps"]
                  and la["composite_fwd"] + la["composite_fwd_tile"] == r["steps"] + renders
                  and renders == 7
                  and la["segment_reduce"] == (r["steps"] if carry else 0)
                  and la["expand_intervals"] == (r["steps"] + renders if carry else 0)
                  and la["preprocess_bwd"] == r["steps"]
                  and la["preprocess_fwd"] == r["steps"] + renders,
                  f"one forward and one backward compositing launch a step, one forward a "
                  f"render, one P2 a step and a render, one preprocess VJP a step, and B5 a "
                  f"step and B6 a forward exactly when the winner carries ({name}: {la})")
            if r["autotune"]["kernel_mode"] == "tile":
                check(la["composite_fwd"] == la["composite_bwd"] == 0,
                      f"no chunk-grid launch under the tile-form winner ({name})")
        for f in ("cfg_args", "input.ply", "cameras.json", "chkpnt15.npz",
                  "point_cloud/iteration_15/point_cloud.ply",
                  "point_cloud/iteration_30/point_cloud.ply"):
            check(os.path.exists(os.path.join(model, f)), f"cli.train wrote {f}")
        check(os.path.exists(os.path.join(resumed, "point_cloud/iteration_30/point_cloud.ply")),
              "the resumed run wrote its iteration-30 snapshot")
        with np.load(os.path.join(model, "chkpnt15.npz")) as z:
            same = (len(restored) == 1 and restored[0].keys() == set(z.files)
                    and all(np.array_equal(v, z[k]) and v.dtype == z[k].dtype
                            for k, v in restored[0].items()))
        check(same, "the resumed run's restored state equals chkpnt15.npz bitwise")

        reset_launches()
        t0 = time.perf_counter()
        render_cli.main(["-m", model, "--iteration", "30", "--quiet"], device=dev)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        render_launches = dict(cuda_build.LAUNCHES)
        check(sys.stdout is stdout, "stdout is the process's own after cli.render")
        shown, state, written = check_cli_renders(torch, dev, data, model, 30, work)
        check(written == {"train": 8, "test": 2}, "8 train and 2 test renders")
        check(render_launches["composite_fwd"] + render_launches["composite_fwd_tile"] == 10
              and render_launches["composite_bwd"] + render_launches["composite_bwd_tile"] == 0,
              "one forward compositing launch per rendered view")
        scores = metrics_phase(torch, dev, model, work)
        viewer = viewer_phase(torch, dev, state, shown.get_test_cameras(), model)
        del state
        profiled = profiler_phase(torch, dev, data, work)
    wall = time.perf_counter() - t_phase
    print(f"cli phase: wall {wall:.2f} s (dataset {data_s:.2f} s, render CLI {render_s:.2f} s); "
          f"train {runs['train']['it_per_s']:.2f} it/s, resumed {runs['resume']['it_per_s']:.2f} "
          f"it/s (each after its sweep), median step by kernel form "
          f"{runs['train']['median_step_ms']} / {runs['resume']['median_step_ms']} ms; winners "
          f"{runs['train']['autotune']['winner']} / {runs['resume']['autotune']['winner']}; "
          f"launches less the sweeps': train {runs['train']['launches']}, resumed "
          f"{runs['resume']['launches']}, render {render_launches}; renders {written}",
          flush=True)
    print("cli phase: stdout intact", file=stdout, flush=True)
    return dict(wall_s=wall, dataset_s=data_s, render_s=render_s, runs=runs,
                render_launches=render_launches, renders=written, metrics=scores,
                viewer=viewer, profiler=profiled)


def check_cli_renders(torch, dev, data, model, iteration, work):
    """Each PNG ``cli.render`` wrote for ``iteration`` under ``model`` against
    save_png of eval_render on the saved PLY, bytewise. Returns the Scene
    shown, the saved state and the renders by split."""
    from gs_tpu_torch.cli import render as render_cli
    from gs_tpu_torch.config import ModelParams, RasterizeConfig
    from gs_tpu_torch.data import ply
    from gs_tpu_torch.scene import Scene
    from gs_tpu_torch.training import eval_render

    shown = Scene(ModelParams(source_path=data, model_path=model, eval=True, resolution=1),
                  load_iteration=iteration, shuffle=False, load_images=False, device=dev)
    state = ply.load_gaussian_ply(os.path.join(model, f"point_cloud/iteration_{iteration}/"
                                               "point_cloud.ply"), device=dev)
    bg = torch.zeros(3, device=dev)
    written = {}
    for split, cams in (("train", shown.get_train_cameras()),
                        ("test", shown.get_test_cameras())):
        folder = os.path.join(model, split, f"ours_{iteration}")
        renders = sorted(os.listdir(os.path.join(folder, "renders")))
        written[split] = len(renders)
        check(len(os.listdir(os.path.join(folder, "gt"))) == len(renders) == len(cams),
              f"one render and one ground truth a {split} camera")
        for name, cam in zip(renders, cams):
            again = os.path.join(work, "again.png")
            render_cli.save_png(again, eval_render(state, cam, bg, active_sh_degree=3,
                                                   raster_cfg=RasterizeConfig()))
            with open(again, "rb") as a, open(os.path.join(folder, "renders", name), "rb") as b:
                check(a.read() == b.read(), f"{split}/renders/{name} equals save_png of "
                                            f"eval_render on the saved PLY")
    return shown, state, written


def metrics_phase(torch, dev, model, work) -> dict:
    """``cli.metrics.main`` on the render CLI's output: results.json and
    per_view.json hold ours_30's 2 test views, SSIM and PSNR within 1e-6 of
    the port's ``ssim`` / ``psnr`` on the same PNGs, LPIPS null unless a
    weights file is present. Then ``cli.full_eval.main`` with
    ``--skip_training --skip_rendering`` on ``<work>/eval/truck`` (a copy of
    the model's test renders; Tanks&Temples' other scene, ``train``, is
    absent and is reported as such) runs ``python -m gs_tpu_torch.cli.metrics``
    in a child process, which must write the same results.json."""
    from gs_tpu_torch.cli import full_eval as full_eval_cli
    from gs_tpu_torch.cli import metrics as metrics_cli
    from gs_tpu_torch.utils import losses
    from gs_tpu_torch.utils import lpips as lpips_mod
    from gs_tpu_torch.utils import metrics as metrics_mod

    stdout = sys.stdout
    t0 = time.perf_counter()
    full = metrics_cli.main(["-m", model], device=dev)
    metrics_s = time.perf_counter() - t0
    check(sys.stdout is stdout, "stdout is the process's own after cli.metrics")
    with open(os.path.join(model, "results.json")) as f, \
            open(os.path.join(model, "per_view.json")) as g:
        results, per_view = json.load(f), json.load(g)
    check(full == {model: results} and set(results) == {"ours_30"}
          and set(per_view) == {"ours_30"}, "results.json holds ours_30")
    folder = os.path.join(model, "test", "ours_30")
    names = sorted(os.listdir(os.path.join(folder, "renders")))
    direct = {"SSIM": {}, "PSNR": {}}
    for n in names:
        r = torch.from_numpy(metrics_cli.read_image(os.path.join(folder, "renders", n))).to(dev)
        g = torch.from_numpy(metrics_cli.read_image(os.path.join(folder, "gt", n))).to(dev)
        direct["SSIM"][n] = float(losses.ssim(r, g))
        direct["PSNR"][n] = float(metrics_mod.psnr(r, g)[0, 0])
    weights = lpips_mod._weights_path() is not None
    got = per_view["ours_30"]
    check(len(names) == 2 and set(got["SSIM"]) == set(got["PSNR"]) == set(names),
          "per_view.json holds the 2 test views")
    worst = max(abs(got[k][n] - direct[k][n]) for k in direct for n in names)
    check(worst <= 1e-6, f"metrics CLI's SSIM / PSNR within 1e-6 of ssim / psnr ({worst:.3g})")
    for k in direct:
        check(abs(results["ours_30"][k] - float(np.mean(list(direct[k].values())))) <= 1e-6,
              f"results.json {k} is the views' mean")
    check((results["ours_30"]["LPIPS"] is None) == (not weights)
          and (got["LPIPS"] == {}) == (not weights),
          f"LPIPS null exactly when no weights file is present (weights {weights})")
    print(f"metrics CLI: {results} in {metrics_s:.2f} s (LPIPS weights present: {weights}); "
          f"per view {per_view}; direct ssim / psnr max |d| {worst:.3g}", flush=True)

    out = os.path.join(work, "eval")
    shutil.copytree(os.path.join(model, "test"), os.path.join(out, "truck", "test"))
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = ROOT + (os.pathsep + env_path if env_path else "")
    t0 = time.perf_counter()
    try:
        full_eval_cli.main(["-tat", os.path.join(work, "tat"), "--skip_training",
                            "--skip_rendering", "--output_path", out])
    finally:
        if env_path is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = env_path
    full_eval_s = time.perf_counter() - t0
    child_path = os.path.join(out, "truck", "results.json")
    check(os.path.exists(child_path), "full_eval's metrics child wrote truck/results.json")
    with open(child_path) as f:
        child = json.load(f)
    same_keys = child.keys() == results.keys() and all(
        child[m].keys() == results[m].keys() for m in results)
    worst_child = max(abs(child["ours_30"][k] - results["ours_30"][k]) for k in ("SSIM", "PSNR"))
    check(same_keys and worst_child <= 1e-6
          and child["ours_30"]["LPIPS"] == results["ours_30"]["LPIPS"],
          f"full_eval's metrics child wrote the same results.json ({child} vs {results})")
    check(not os.path.exists(os.path.join(out, "train", "results.json")),
          "no results for the absent scene")
    print(f"full_eval (--skip_training --skip_rendering, child process): {child} in "
          f"{full_eval_s:.2f} s; max |d| against the in-process results {worst_child:.3g} "
          f"(bitwise equal {child == results})", flush=True)
    return dict(results=results, per_view=per_view, metrics_s=metrics_s,
                full_eval_s=full_eval_s, lpips_weights=weights)


def wire_matrices(cam) -> tuple[list, list]:
    """The SIBR viewer's matrices for a camera: its view and full projection
    transposed (row-vector storage), the view's Y and Z columns and the
    projection's Y column negated, as the viewer sends them
    (gs_tpu/viewer/network_gui.py:79-82 undoes both)."""
    view = cam.view.cpu().numpy().T.copy()
    view[:, 1:3] *= -1
    proj = cam.full_proj.cpu().numpy().T.copy()
    proj[:, 1] *= -1
    return view.reshape(-1).tolist(), proj.reshape(-1).tolist()


VIEWER_FRAMES = 2


def viewer_phase(torch, dev, state, cams, source_path) -> dict:
    """The iteration-30 state served through ``GuiServer("127.0.0.1", 0, ...)``
    to a client thread that sends VIEWER_FRAMES 1920x1080 requests with
    gs_tpu's message keys (the test cameras' matrices), a zero-resolution
    ping, and closes. Counts reset just before the poll and read just after:
    one forward compositing launch a frame, none for the ping. Each frame
    equals save-free ``eval_render`` at ``camera_from_matrices`` of the
    decoded matrices after the same uint8 conversion, bitwise; the verify
    string is the source path; ms per frame served and rendered."""
    import socket
    import threading
    from types import SimpleNamespace

    from gs_tpu_torch import cameras
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.training import eval_render
    from gs_tpu_torch.viewer.network_gui import GuiServer

    cfg = RasterizeConfig()
    msgs = []
    for cam in cams[:VIEWER_FRAMES]:
        view, proj = wire_matrices(cam)
        fovx = 2 * math.atan(float(cam.tan_fovx))
        fovy = 2 * math.atan(float(cam.tan_fovy))
        msgs.append({"resolution_x": cam.width, "resolution_y": cam.height, "train": False,
                     "fov_y": fovy, "fov_x": fovx, "z_near": float(cam.znear),
                     "z_far": float(cam.zfar), "shs_python": False, "rot_scale_python": False,
                     "keep_alive": True, "scaling_modifier": 1.0, "view_matrix": view,
                     "view_projection_matrix": proj})
    ping = dict(msgs[0], resolution_x=0, resolution_y=0)
    server = GuiServer("127.0.0.1", 0, source_path)
    port = server.listener.getsockname()[1]
    got = {"frames": [], "verify": [], "served_ms": [], "error": None}

    def recv_exact(conn, n):
        buf = bytearray()
        while len(buf) < n:
            part = conn.recv(min(n - len(buf), 1 << 22))
            if not part:
                raise ConnectionError("the server closed early")
            buf += part
        return bytes(buf)

    def client():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=120) as conn:
                for msg in [*msgs, ping]:
                    data = json.dumps(msg).encode()
                    t0 = time.perf_counter()
                    conn.sendall(len(data).to_bytes(4, "little") + data)
                    if msg["resolution_x"]:
                        got["frames"].append(recv_exact(conn, msg["resolution_x"]
                                                        * msg["resolution_y"] * 3))
                    n = int.from_bytes(recv_exact(conn, 4), "little")
                    got["verify"].append(recv_exact(conn, n).decode("ascii"))
                    got["served_ms"].append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 - reported by the main thread's check
            got["error"] = repr(e)

    ts = SimpleNamespace(state=state, active_sh_degree=3, iteration=30)
    thread = threading.Thread(target=client)
    thread.start()
    try:
        deadline = time.time() + 60
        while server.conn is None and time.time() < deadline:
            server.try_connect()
            time.sleep(0.01)
        check(server.conn is not None, "the viewer client connected")
        reset_launches()
        server.poll(ts, cfg, iterations=30)  # returns when the client closes
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        thread.join(timeout=120)
        check(not thread.is_alive() and got["error"] is None,
              f"the viewer client finished ({got['error']})")
    finally:
        server.close()
        thread.join(timeout=120)
    check(launches == launches_of(composite_fwd=VIEWER_FRAMES, preprocess_fwd=VIEWER_FRAMES),
          f"one forward compositing and one P2 launch a frame and none for the ping "
          f"({launches})")
    check(got["verify"] == [source_path] * (VIEWER_FRAMES + 1), "the verify string each reply")
    same, rendered_ms = [], []
    for msg, frame in zip(msgs, got["frames"]):
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1:3] *= -1
        vp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        vp[:, 1] *= -1
        cam = cameras.camera_from_matrices(wv.T, vp.T, msg["fov_x"], msg["fov_y"],
                                           msg["resolution_x"], msg["resolution_y"],
                                           msg["z_near"], msg["z_far"], device=dev)
        img = eval_render(state, cam, torch.zeros(3, device=dev), active_sh_degree=3,
                          raster_cfg=cfg)
        want = (img * 255.0).cpu().numpy().astype(np.uint8).transpose(1, 2, 0).tobytes()
        same.append(frame == want)
        rendered_ms.append(cuda_ms(lambda: eval_render(state, cam, torch.zeros(3, device=dev),
                                                       active_sh_degree=3, raster_cfg=cfg), 3))
    check(len(got["frames"]) == VIEWER_FRAMES and all(same),
          f"every viewer frame equals eval_render at camera_from_matrices bitwise ({same})")
    r = dict(frames=VIEWER_FRAMES, bitwise=same, launches=launches, served_ms=got["served_ms"],
             rendered_ms=rendered_ms, shape=f"{msgs[0]['resolution_x']}x"
                                            f"{msgs[0]['resolution_y']}, {state.capacity} rows")
    print(f"viewer: {VIEWER_FRAMES} frames of {r['shape']} served in "
          f"{got['served_ms'][:VIEWER_FRAMES]} ms (request to last byte), the ping in "
          f"{got['served_ms'][-1]:.2f} ms; eval_render {rendered_ms} ms; bitwise {same}; "
          f"launches {launches}", flush=True)
    return r


PROFILE_ITERS = (5, 10)


def profiler_phase(torch, dev, data, work) -> dict:
    """The CLI dataset's Scene (its load timed, with whether the native
    COLMAP reader loaded) trained 12 iterations by ``run_training`` with
    ``profile_dir`` under ``build/`` and PROFILE_ITERS, the default switches
    and no sweep: a Chrome trace must be written and name the chunk-grid
    compositing kernels the steps ran."""
    from gs_tpu_torch.config import ModelParams, OptimizationParams, PipelineParams
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.data import native
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.scene import Scene
    from gs_tpu_torch.training import run_training

    t0 = time.perf_counter()
    scene = Scene(ModelParams(source_path=data, model_path=os.path.join(work, "profiled"),
                              eval=True, resolution=1, sh_degree=3), device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    folder = os.path.join(work, "profile")
    seen = []
    reset_launches()
    with switches():
        run_training(scene, OptimizationParams(iterations=12), PipelineParams(),
                     raster_cfg=RasterizeConfig(autotune=False), test_iterations=(),
                     save_iterations=(), log_every=4,
                     progress=lambda it, m: seen.append((it, m["step_s"], m["pix_per_s"])),
                     profile_dir=folder, profile_iters=PROFILE_ITERS)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    files = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
    # the Chrome trace and, beside it, the span table the tracer writes
    traces = [f for f in files if f.startswith("trace_") and f.endswith(".json")]
    check(len(traces) == 1 and files == sorted([traces[0], "spans_" + traces[0][6:]]),
          f"one profiler trace and its span table written ({files})")
    path = os.path.join(folder, traces[0])
    with open(path) as f:
        text = f.read()
    events = json.loads(text)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                      and "composite_" in e.get("name", "")})
    named = {k: sum(k in e.get("name", "") for e in events if e.get("cat") == "kernel")
             for k in ("composite_fwd_kernel", "composite_bwd_kernel")}
    steps = PROFILE_ITERS[1] - PROFILE_ITERS[0] + 1
    check(named["composite_fwd_kernel"] == named["composite_bwd_kernel"] == steps,
          f"the trace names the compositing kernels of its {steps} steps ({named})")
    check(launches == launches_of(composite_fwd=12, composite_bwd=12, preprocess_fwd=12,
                                  preprocess_bwd=12),
          f"12 chunk-grid steps ({launches})")
    check([it for it, _, _ in seen] == [4, 8, 12] and all(v > 0 for _, v, _ in seen),
          "progress got step_s / pix_per_s")
    print(f"native COLMAP reader loaded: {native.available()}; the CLI dataset's Scene loaded "
          f"in {load_s:.2f} s; profiler trace {os.path.getsize(path)} B, {len(events)} events, "
          f"kernels {kernels}, counts {named}; progress (iteration, step_s, pix/s) {seen}",
          flush=True)
    return dict(native_available=native.available(), scene_load_s=load_s,
                trace_bytes=os.path.getsize(path), trace_kernels=kernels, kernel_events=named,
                progress=seen)


# --- the tile-sharded layout (parallel/): strips, steps, rank worlds, the CLI ------------------

# strips a frame is cut into for the render leg; (data, shard) meshes of the in-process
# steps (the last one is leg 3's second mesh) and of the two-process world
SHARD_STRIPS = (2, 4)
SHARD_STEP_MESHES = ((1, 2), (1, 4), (2, 2), (2, 1))
SHARD_RANK_MESHES = ((1, 2), (2, 1))
# tests/test_sharding.py:73-80: loss rtol; xyz, stats and Adam nu (rtol, atol)
SHARD_LOSS_RTOL = 1e-5
SHARD_XYZ_TOL, SHARD_STATS_TOL, SHARD_NU_TOL = (1e-4, 1e-6), (1e-3, 1e-7), (1e-3, 1e-10)
# Adam's first step moves a coordinate by the lr times its gradient's sign, so a
# gradient the two summation orders put on either side of 0 moves it 2 lr apart:
# such flips are allowed only where |g| is below this share of the group's max
SHARD_FLIP_SHARE = 1e-3
# (data, shard) meshes of ``--cards N``, one card a rank
MESH_CARD_MESHES = ((2, 2), (1, 4))
SHARD_CLI_ITERS = 12
SHARD_CLI_ARGS = ("-r", "1", "--eval", "--sh_degree", "3", "--iterations",
                  str(SHARD_CLI_ITERS), "--densify_from_iter", "4",
                  "--densification_interval", "5", "--opacity_reset_interval", "100",
                  "--test_iterations", str(SHARD_CLI_ITERS), "--save_iterations",
                  str(SHARD_CLI_ITERS), "--shard_parallel", "2")


def sharded_cameras(torch, dev):
    """Two training views of the bench scene: the bench camera and one turned
    6 degrees about y, each with the default_rng(1) draw rendered from it as
    its target (budget grown to 1.05 x its pairs)."""
    from gs_tpu_torch import cameras
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.renderer import render
    from gs_tpu_torch.training import eval_render

    gt = make_bench_state(dev, 1)
    bg = torch.zeros(3, device=dev)
    cams, pairs = [], []
    for deg in (0.0, 6.0):
        a = math.radians(deg)
        rot = np.array([[math.cos(a), 0.0, -math.sin(a)], [0.0, 1.0, 0.0],
                        [math.sin(a), 0.0, math.cos(a)]])
        cam = cameras.make_camera(rot, np.array([0.0, 0.0, 5.0]), fovx=math.radians(70),
                                  fovy=math.radians(46), width=WIDTH, height=HEIGHT, device=dev)
        n = int(render(cam, gt, active_sh_degree=3, bg_color=bg,
                       cfg=RasterizeConfig()).num_pairs)
        cfg = RasterizeConfig(pair_budget_factor=1.05 * n / N_GAUSS)
        cams.append(dataclasses.replace(cam, image=eval_render(gt, cam, bg, active_sh_degree=3,
                                                               raster_cfg=cfg)))
    del gt
    return cams


def step_budget(torch, state, cams, bg):
    """The unsharded reference's config (its budget 1.05 x the larger pair
    count of the two views, so neither truncates) and the sharded steps'
    pair budget: S of those, so that every strip holds all of its pairs."""
    from gs_tpu_torch.config import RasterizeConfig
    from gs_tpu_torch.ops.rasterize_tiled import current_pair_budget
    from gs_tpu_torch.renderer import render

    n = max(int(render(c, state, active_sh_degree=3, bg_color=bg,
                       cfg=RasterizeConfig()).num_pairs) for c in cams)
    cfg = RasterizeConfig(pair_budget_factor=1.05 * n / N_GAUSS)
    return cfg, current_pair_budget(cfg, N_GAUSS)


def batch_reference(torch, state, cams, bg, cfg):
    """The unsharded step over a camera batch, as train_step takes one camera:
    each camera's gradients (render, photometric_loss, autograd), their mean
    into Adam, each camera's densify statistics added, the mean loss."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.models import densify, optim
    from gs_tpu_torch.renderer import render
    from gs_tpu_torch.utils import losses, schedules

    opt = OptimizationParams()
    ts = training.init_train_state(state, 1.0, 3)
    if len(cams) == 1:
        return training.train_step(ts.state, ts.adam, ts.stats, cams[0], bg, 0, 1.0,
                                   active_sh_degree=3, opt_cfg=opt, raster_cfg=cfg,
                                   accumulate_stats=True)
    stats, grads, loss = ts.stats, [], 0.0
    for cam in cams:
        params = {k: v.detach().requires_grad_() for k, v in state.params().items()}
        offset = torch.zeros((state.capacity, 2), device=state.device, requires_grad=True)
        with torch.enable_grad():
            out = render(cam, state.with_params(params), active_sh_degree=3, bg_color=bg,
                         means2d_offset=offset, cfg=cfg)
            cam_loss = losses.photometric_loss(out.image, cam.image, opt.lambda_dssim)
            g = torch.autograd.grad(cam_loss, [*params.values(), offset], allow_unused=True,
                                    materialize_grads=True)
        stats = densify.add_stats(stats, g[-1], out.radii, out.visibility, cam.width,
                                  cam.height)
        grads.append(dict(zip(params, g[:-1])))
        loss = loss + cam_loss.detach()
    mean = {k: sum(g[k] for g in grads) / len(cams) for k in grads[0]}
    xyz_lr = schedules.expon_lr(0, lr_init=opt.position_lr_init, lr_final=opt.position_lr_final,
                                lr_delay_mult=opt.position_lr_delay_mult,
                                max_steps=opt.position_lr_max_steps) * torch.tensor(1.0)
    new_params, adam = optim.update(state.params(), mean, ts.adam, optim.group_lrs(opt, xyz_lr))
    return state.with_params(new_params), adam, stats, {"loss": loss / len(cams)}


def close_share(torch, got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 is within tolerance."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def compare_step(torch, got, ref, label, against="the unsharded step") -> dict:
    """A sharded step against a reference step (``against``) at
    test_sharding.py's tolerances; xyz where the two gradients share a sign
    (the flips must sit below SHARD_FLIP_SHARE of the group's largest
    gradient)."""
    s, a, d, m = got
    rs, ra, rd, rm = ref
    loss_rel = abs(float(m["loss"]) - float(rm["loss"])) / abs(float(rm["loss"]))
    g, rg = a.mu["xyz"], ra.mu["xyz"]  # 0.1 x the gradient after one step from zero
    flips = torch.sign(g) != torch.sign(rg)
    flip_share = float(rg[flips].abs().max() / rg.abs().max()) if bool(flips.any()) else 0.0
    same = ~flips
    r = dict(loss=float(m["loss"]), ref_loss=float(rm["loss"]), loss_rel=loss_rel,
             xyz=close_share(torch, s.xyz[same], rs.xyz[same], *SHARD_XYZ_TOL),
             sign_flips=int(flips.sum()), flip_share=flip_share,
             stats=close_share(torch, d.xyz_grad_accum, rd.xyz_grad_accum, *SHARD_STATS_TOL),
             denom_equal=torch.equal(d.denom, rd.denom),
             radii_equal=torch.equal(d.max_radii2d, rd.max_radii2d),
             nu=close_share(torch, a.nu["opacity"], ra.nu["opacity"], *SHARD_NU_TOL))
    print(f"{label} vs {against}: loss {r['loss']:.7f} / {r['ref_loss']:.7f} (rel "
          f"{loss_rel:.3g}); xyz {r['xyz']:.3g}, stats {r['stats']:.3g}, Adam nu {r['nu']:.3g} "
          f"of their tolerances; {r['sign_flips']} xyz gradient sign flips (largest "
          f"{flip_share:.3g} of the max); denom equal {r['denom_equal']}, max radii equal "
          f"{r['radii_equal']}", flush=True)
    check(loss_rel <= SHARD_LOSS_RTOL and r["xyz"] <= 1 and r["stats"] <= 1 and r["nu"] <= 1
          and flip_share <= SHARD_FLIP_SHARE and r["denom_equal"] and r["radii_equal"],
          f"{label} within test_sharding.py's tolerances of {against}")
    return r


def same_bits(torch, a, b) -> bool:
    """Bitwise equality of two step results (nested tensors, dicts, tuples,
    dataclasses)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(torch, x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        return all(same_bits(torch, getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def to_host(torch, x):
    """A step result with every tensor copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: to_host(torch, v) for k, v in x.items()}
    if hasattr(x, "_fields"):  # a NamedTuple (Adam, densify stats)
        return type(x)(*(to_host(torch, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(torch, v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_host(torch, getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


@contextlib.contextmanager
def capture_results(module, name: str, store: list):
    """Record the result of every call of ``module.<name>``."""
    original = getattr(module, name)

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        store.append(out.detach() if hasattr(out, "detach") else out)
        return out

    setattr(module, name, recording)
    try:
        yield store
    finally:
        setattr(module, name, original)


def sharded_step(torch, mesh, state, cams, bg, budget, cfg):
    """One tile-sharded train step on ``mesh`` from fresh Adam and stats."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.parallel import sharded

    ts = training.init_train_state(state, 1.0, 3)
    step = sharded.make_sharded_train_step(mesh, OptimizationParams(), cfg, HEIGHT, WIDTH,
                                           state.capacity, 3, pair_budget=budget)
    return step(ts.state, ts.adam, ts.stats, cams[:mesh.data], bg, 0, 1.0, True)


def shard_render_leg(torch, dev, state, cam, bg, cfg) -> dict:
    """Leg 1: the frame cut into S column strips (SHARD_STRIPS), rendered one
    after another on the card and reassembled: bitwise equal to eval_render
    (clamped) and to render (not), S B1 launches a frame and nothing else,
    the form each strip ran; strip / frame times."""
    from gs_tpu_torch.ops import cuda_build, rasterize_tiled
    from gs_tpu_torch.parallel import mesh as mesh_mod
    from gs_tpu_torch.parallel import sharded
    from gs_tpu_torch.renderer import render
    from gs_tpu_torch.training import eval_render

    frame = render(cam, state, active_sh_degree=3, bg_color=bg, cfg=cfg).image
    clamped = eval_render(state, cam, bg, active_sh_degree=3, raster_cfg=cfg)
    frame_ms = cuda_ms(lambda: render(cam, state, active_sh_degree=3, bg_color=bg, cfg=cfg), 3)
    budget = rasterize_tiled.current_pair_budget(cfg, N_GAUSS)
    out = {}
    for n in SHARD_STRIPS:
        mesh = mesh_mod.in_process_mesh(1, n, device=dev)
        fn = sharded.make_sharded_render(mesh, cfg, HEIGHT, WIDTH, N_GAUSS, 3,
                                         pair_budget=n * budget)
        calls = []
        reset_launches()
        with capture_composite(calls):
            img = fn(state, cam, bg)
        torch.cuda.synchronize()
        launches = dict(cuda_build.LAUNCHES)
        forms = [c[0].kernel_mode for c in calls]
        bitwise = torch.equal(img, frame)
        if not bitwise:  # where and by how much the strips part from the frame
            d = (img - frame).abs().amax(0)
            th, tw = cfg.tile_h, cfg.tile_w
            ty, tx = torch.nonzero(d > 0, as_tuple=True)
            tiles = sorted({(int(y) // th, int(x) // tw) for y, x in zip(ty[:100000], tx[:100000])})
            print(f"strips S={n}: {int((d > 0).sum())} pixels differ, max {float(d.max()):.3g}, "
                  f"in {len(tiles)} tiles, e.g. {tiles[:12]}", flush=True)
        check(bitwise and torch.equal(torch.clamp(img, 0.0, 1.0), clamped),
              f"{n} strips reassembled equal render and eval_render bitwise")
        check(launches == launches_of(composite_fwd=n, preprocess_fwd=n)
              and forms == ["chunk"] * n,
              f"one chunk-grid forward and one P2 launch a strip, {n} a frame ({launches}, "
              f"{forms})")
        strips_ms = cuda_ms(lambda: fn(state, cam, bg), 3)
        st = sharded.strip_static(cfg, HEIGHT, WIDTH)
        one_ms = cuda_ms(lambda: sharded.render_strip(state, cam, bg, st, 3, n, 0, n * budget,
                                                      True), 3)
        out[f"S={n}"] = dict(launches=launches["composite_fwd"],
                             p2_launches=launches["preprocess_fwd"], forms=forms,
                             bitwise=bitwise, frame_ms=frame_ms, strips_ms=strips_ms,
                             strip0_ms=one_ms, pair_budget_a_strip=budget)
        print(f"strips S={n}: reassembled frame bitwise equal to render / eval_render; B1 "
              f"launches {launches['composite_fwd']} ({forms}); all {n} strips one after "
              f"another {strips_ms:.3f} ms, strip 0 alone {one_ms:.3f} ms, the whole frame "
              f"{frame_ms:.3f} ms", flush=True)
    return out


def shard_step_leg(torch, dev, state, cams, bg, meshes=SHARD_STEP_MESHES) -> dict:
    """Leg 2: one sharded step on each in-process mesh (``meshes``)
    under the default reduction, GRAD_REDUCE="cuda" and PAIR_SOURCE="carry",
    counts reset just before and read just after each; the default and
    "cuda" steps within test_sharding.py's tolerances of the unsharded step
    over the same cameras; carry bitwise equal to the "cuda" gather, strip
    by strip (the pair tables and B2's per-pair gradients) and in the whole
    result. Returns the results (on the host) and the launches."""
    from gs_tpu_torch.ops import cuda_build, rasterize_tiled
    from gs_tpu_torch.parallel import mesh as mesh_mod

    cfg, budget = step_budget(torch, state, cams, bg)
    refs = {d: batch_reference(torch, state, cams[:d], bg, cfg) for d in (1, 2)}
    results, launches, times, compared = {}, {}, {}, {}
    for data, shard in meshes:
        mesh = mesh_mod.in_process_mesh(data, shard, device=dev)
        strips = data * shard
        tables, pair_grads = {}, {}
        for mode, kw in (("scatter", {}), ("cuda", dict(grad_reduce="cuda")),
                         ("carry", dict(pair_source="carry"))):
            key = f"{data}x{shard} {mode}"
            calls, bwd = [], []
            reset_launches()
            with switches(**kw), capture_composite(calls), \
                    capture_results(rasterize_tiled, "composite_bwd_cuda", bwd):
                out = sharded_step(torch, mesh, state, cams, bg, budget, cfg)
            torch.cuda.synchronize()
            launches[key] = la = dict(cuda_build.LAUNCHES)
            want = launches_of(composite_fwd=strips, composite_bwd=strips, preprocess_fwd=strips,
                               preprocess_bwd=strips,
                               segment_reduce=0 if mode == "scatter" else strips,
                               expand_intervals=strips if mode == "carry" else 0)
            check(la == want, f"{key}: a strip's launches ({la})")
            check(int(out[3]["num_pairs_max"]) <= budget,
                  f"{key}: every strip held its pairs")
            tables[mode] = [c[1] for c in calls]
            pair_grads[mode] = bwd
            results[key] = to_host(torch, out)
            if mode != "carry":
                compared[key] = compare_step(torch, out, refs[data], key)
            with switches(**kw):
                times[key] = cuda_ms(lambda: sharded_step(torch, mesh, state, cams, bg, budget,
                                                          cfg), 2)
            del out
        check(all(torch.equal(a, b) for a, b in zip(tables["carry"], tables["cuda"]))
              and all(torch.equal(a, b) for a, b in zip(pair_grads["carry"],
                                                        pair_grads["cuda"]))
              and len(tables["carry"]) == len(pair_grads["carry"]) == strips,
              f"{data}x{shard}: carry's pair tables and per-pair gradients equal the cuda "
              f"gather's, strip by strip")
        check(same_bits(torch, results[f"{data}x{shard} carry"], results[f"{data}x{shard} cuda"]),
              f"{data}x{shard}: the carry step equals the cuda gather's bitwise")
        del tables, pair_grads
    ref_ms = {d: cuda_ms(lambda: batch_reference(torch, state, cams[:d], bg, cfg), 2)
              for d in (1, 2)}
    print(f"sharded steps (in-process, ms): {times}; unsharded step over 1 / 2 cameras "
          f"{ref_ms[1]:.2f} / {ref_ms[2]:.2f} ms", flush=True)
    return dict(results=results, launches=launches, step_ms=times, unsharded_ms=ref_ms,
                compared=compared, pair_budget=budget)


def sharded_rank(rank, world, rdv, out, meshes) -> None:
    """A rank of leg 3's world (on card ``rank % device_count``: two ranks on
    one card take gloo, a card a rank NCCL), making the bench scene and the
    two views itself, then one step on each (data, shard) mesh of
    ``meshes`` under GRAD_REDUCE "cuda" and "scatter", saved to ``out`` on
    the host; rank 0 also times the phases of three more steps on the
    first mesh under each."""
    import torch

    sys.path.insert(0, ROOT)
    from gs_tpu_torch.parallel import mesh as mesh_mod
    from gs_tpu_torch.parallel import sharded

    dev = mesh_mod.rank_device("cuda", rank)
    backend = mesh_mod.init_distributed(rdv, world, rank, device=dev)
    try:
        torch.cuda.set_device(dev)
        state = make_bench_state(dev, 0)
        cams = sharded_cameras(torch, dev)
        bg = torch.zeros(3, device=dev)
        cfg, budget = step_budget(torch, state, cams, bg)
        results = {"backend": backend, "device": str(dev)}
        for data, shard in meshes:
            mesh = mesh_mod.make_mesh(data, shard, device=dev)
            for reduce in ("cuda", "scatter"):
                with switches(grad_reduce=reduce):
                    results[f"{data}x{shard} {reduce}"] = to_host(
                        torch, sharded_step(torch, mesh, state, cams, bg, budget, cfg))
        mesh = mesh_mod.make_mesh(*meshes[0], device=dev)
        spent = {}

        def timed(module, name, kind):
            real = getattr(module, name)

            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = real(*args, **kwargs)
                torch.cuda.synchronize()
                spent[kind] = spent.get(kind, 0.0) + time.perf_counter() - t0
                return r
            setattr(module, name, run)
            return real

        saved = [(sharded, n, timed(sharded, n, k)) for n, k in (
            ("strip_forward", "strips"), ("strip_backward", "strips"),
            ("band_cotangent", "banded loss"), ("apply_step", "Adam and stats"))]
        saved += [(mesh_mod.Mesh, n, timed(mesh_mod.Mesh, n, "collectives"))
                  for n in ("gather_shard", "sum_shard", "sum_data", "max_data", "max_all")]
        try:
            for reduce in ("scatter", "cuda"):
                with switches(grad_reduce=reduce):
                    sharded_step(torch, mesh, state, cams, bg, budget, cfg)  # warm
                    spent.clear()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(3):
                        sharded_step(torch, mesh, state, cams, bg, budget, cfg)
                    torch.cuda.synchronize()
                results[f"phase_s {reduce}"] = {k: v / 3 for k, v in spent.items()}
                results[f"step_s {reduce}"] = (time.perf_counter() - t0) / 3
        finally:
            for module, name, real in saved:
                setattr(module, name, real)
        torch.save(results, out)
    finally:
        torch.distributed.destroy_process_group()


def spawn_world(target: str, world: int, workdir: str, args=(), rdv=None, envs=None,
                cwds=None, timeout=600):
    """``world`` child interpreters running ``chip_smoke.<target>(rank, world,
    rdv, out, *args)`` (``rdv`` by default a ``file://`` rendezvous in
    ``workdir``; rank r in ``cwds[r]`` with ``envs[r]``, by default the
    repository root and this environment); returns each rank's output and
    result path. A rank that fails fails the phase: the others are stopped
    at once (they would wait in a collective), as is every rank past
    ``timeout`` seconds, and every rank's output is printed."""
    rdv = rdv or f"file://{os.path.join(workdir, 'rendezvous')}"
    procs, outs, logs = [], [], []
    for r in range(world):
        outs.append(os.path.join(workdir, f"{target}{r}.out"))
        logs.append(open(os.path.join(workdir, f"{target}{r}.log"), "w+"))
        code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
                f"chip_smoke.{target}({r}, {world}, {rdv!r}, {outs[-1]!r}, *{tuple(args)!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code],
                                      cwd=cwds[r] if cwds else ROOT,
                                      env=envs[r] if envs else None, stdout=logs[-1],
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, (p, log) in enumerate(zip(procs, texts)):
        print(f"--- rank {r} of {target} (exit {p.returncode}) ---\n{log[-6000:]}", flush=True)
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"rank {r} of {target} exited 0")
    return texts, outs


def shard_ranks_leg(torch, step_leg, meshes=SHARD_RANK_MESHES) -> dict:
    """Leg 3: a world of data x shard processes (``meshes`` share the size;
    a file:// rendezvous under build/), one step on each mesh: the ranks
    bitwise equal to each other under either reduction; a world of two
    bitwise equal to leg 2's in-process steps under GRAD_REDUCE="cuda"
    (a larger world sums in its backend's order), else within its
    tolerances; the backend gloo with ranks sharing a card, NCCL with a card
    a rank; the phase shares of rank 0's steps on the first mesh."""
    from gs_tpu_torch.ops import cuda_build

    world = meshes[0][0] * meshes[0][1]
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as work:
        t0 = time.perf_counter()
        _, outs = spawn_world("sharded_rank", world, work, (meshes,))
        wall = time.perf_counter() - t0
        ranks = [torch.load(o, weights_only=False) for o in outs]
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    check(all(r["backend"] == backend for r in ranks),
          f"{world} ranks on {torch.cuda.device_count()} card(s) take {backend}")
    out = {}
    for data, shard in meshes:
        for reduce in ("cuda", "scatter"):
            key = f"{data}x{shard} {reduce}"
            check(all(same_bits(torch, ranks[0][key], r[key]) for r in ranks[1:]),
                  f"{key}: the ranks' states are bitwise equal")
            local = step_leg["results"][key]
            bitwise = same_bits(torch, ranks[0][key], local)
            if reduce == "cuda" and world == 2:
                check(bitwise, f"{key}: the ranks equal the in-process step bitwise")
            else:
                compare_step(torch, ranks[0][key], local, f"{key} ranks",
                             "the in-process step")
            out[key] = dict(bitwise_to_in_process=bitwise)
    step_ms, phase_ms, shares = {}, {}, {}
    for reduce in ("scatter", "cuda"):
        step_s, phase_s = ranks[0][f"step_s {reduce}"], ranks[0][f"phase_s {reduce}"]
        step_ms[reduce] = 1e3 * step_s
        phase_ms[reduce] = {k: 1e3 * v for k, v in phase_s.items()}
        shares[reduce] = {k: v / step_s for k, v in phase_s.items()}
        print(f"{world} ranks ({backend}), GRAD_REDUCE={reduce!r}: rank 0's "
              f"{meshes[0][0]}x{meshes[0][1]} step {step_ms[reduce]:.2f} ms: " + ", ".join(
                  f"{k} {phase_ms[reduce][k]:.2f} ms ({100 * shares[reduce][k]:.1f}%)"
                  for k in phase_s), flush=True)
    print(f"{world} ranks on {[r['device'] for r in ranks]}: {wall:.1f} s with start-up",
          flush=True)
    return dict(wall_s=wall, backend=backend, checks=out, step_ms=step_ms, phase_ms=phase_ms,
                shares=shares)


def cli_rank(rank, world, rdv, out, *argv) -> None:
    """A rank of a CLI leg: ``gs_tpu_torch.cli.train.main`` on ``argv`` with
    the process world from the environment, as ``python -m
    gs_tpu_torch.cli.train`` runs it, recording its sharded steps' times,
    losses and launches (either layout), the autotune's calls and the train
    images its Scene loaded; writes them and a digest of its final state
    (its shard under "gauss") as JSON, and that state on the host to
    ``out + ".pt"``."""
    import hashlib

    import torch

    sys.path.insert(0, ROOT)
    from gs_tpu_torch.cli import train as train_cli
    from gs_tpu_torch.ops import autotune, cuda_build
    from gs_tpu_torch.parallel import trainer

    tuned, step_ms, losses, images = [], [], [], []
    real_tune, real_run = autotune.autotune_formulation, trainer.run_training_parallel

    def tune(*args, **kwargs):
        tuned.append(1)
        return real_tune(*args, **kwargs)

    def run(scene, *args, **kwargs):
        images.append(sum(c.image is not None for c in scene.get_train_cameras()))
        return real_run(scene, *args, **kwargs)

    def timing(make):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)

            def timed(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = step(*a, **k)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                losses.append(float(r[3]["loss"]))
                return r
            return timed
        return made

    autotune.autotune_formulation, trainer.run_training_parallel = tune, run
    for name in ("make_sharded_train_step", "make_gauss_sharded_train_step"):
        setattr(trainer, name, timing(getattr(trainer, name)))
    t0 = time.perf_counter()
    ts = train_cli.main(list(argv))
    wall = time.perf_counter() - t0
    digest = hashlib.sha256()
    for t in (*ts.state.params().values(), ts.state.alive, *ts.adam.mu.values(),
              *ts.adam.nu.values(), *ts.stats):
        digest.update(t.detach().cpu().numpy().tobytes())
    torch.save(to_host(torch, (ts.state, ts.adam, ts.stats)), out + ".pt")
    with open(out, "w") as f:
        json.dump(dict(rank=rank, digest=digest.hexdigest(), step_ms=step_ms, losses=losses,
                       autotune_calls=len(tuned), launches=dict(cuda_build.LAUNCHES),
                       iteration=ts.iteration, alive=int(ts.state.num_alive),
                       capacity=ts.state.capacity, wall_s=wall, train_images=images[0],
                       device=str(ts.state.device)), f)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_cli_leg(torch, dev) -> dict:
    """Leg 4: ``cli_dataset``, then the train CLI with ``--shard_parallel 2``
    as two processes (GS_TPU_NUM_PROCESSES / GS_TPU_PROCESS_ID /
    GS_TPU_COORDINATOR; rank 1 in an empty working directory) for
    SHARD_CLI_ITERS iterations with densify rounds at 5 and 10: exit 0,
    finite losses, no autotune, rank 0 alone writing (the model's files
    there, rank 1's directory still empty, the saving and evaluation lines
    in rank 0's log only), equal final state digests, one B1 / B2 launch a
    strip a step on each rank; then ``cli.render`` of the final PLY, each PNG
    bytewise equal to save_png(eval_render(...)); step ms median and it/s."""
    from gs_tpu_torch.cli import render as render_cli
    from gs_tpu_torch.ops import cuda_build

    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as work:
        data, model, idle = (os.path.join(work, d) for d in ("colmap", "model", "idle"))
        os.makedirs(idle)
        t0 = time.perf_counter()
        cli_dataset(torch, dev, data)
        data_s = time.perf_counter() - t0
        rdv = f"127.0.0.1:{free_port()}"
        envs = [dict(os.environ, GS_TPU_NUM_PROCESSES="2", GS_TPU_PROCESS_ID=str(r),
                     GS_TPU_COORDINATOR=rdv) for r in range(2)]
        t0 = time.perf_counter()
        logs, outs = spawn_world("cli_rank", 2, work, ("-s", data, "-m", model, *SHARD_CLI_ARGS),
                                 rdv=rdv, envs=envs, cwds=[work, idle])
        wall = time.perf_counter() - t0
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
        check(os.listdir(idle) == [], f"rank 1 wrote nothing in its directory "
                                      f"({os.listdir(idle)})")
        check(ranks[0]["digest"] == ranks[1]["digest"], "the ranks' final states are equal")
        for r, (rk, log) in enumerate(zip(ranks, logs)):
            n = len(rk["step_ms"])
            check(n == SHARD_CLI_ITERS and all(math.isfinite(v) for v in rk["losses"]),
                  f"cli rank {r}: {SHARD_CLI_ITERS} steps, finite losses")
            check(rk["autotune_calls"] == 0, f"cli rank {r}: the autotune is skipped")
            la = rk["launches"]
            check(la["composite_bwd"] + la["composite_bwd_tile"] == la["preprocess_bwd"] == n
                  and la["preprocess_fwd"] == la["composite_fwd"] + la["composite_fwd_tile"],
                  f"cli rank {r}: one backward compositing and one preprocess VJP launch a "
                  f"step, one P2 a forward compositing launch ({la})")
            saving = log.count("Saving Gaussians")
            evaluating = log.count("Evaluating")
            check(saving == (1 if r == 0 else 0) and (evaluating > 0) == (r == 0),
                  f"cli rank {r}: saving / evaluation lines {saving} / {evaluating}")
            check(f"rank {r} of 2: gloo backend" in log, f"cli rank {r} took gloo")
        for f in ("cfg_args", "input.ply", "cameras.json",
                  f"point_cloud/iteration_{SHARD_CLI_ITERS}/point_cloud.ply"):
            check(os.path.exists(os.path.join(model, f)), f"rank 0 wrote {f}")
        reset_launches()
        render_cli.main(["-m", model, "--iteration", str(SHARD_CLI_ITERS), "--quiet"],
                        device=dev)
        torch.cuda.synchronize()
        _, state, written = check_cli_renders(torch, dev, data, model, SHARD_CLI_ITERS, work)
        check(written == {"train": 8, "test": 2}, "8 train and 2 test renders")
        del state
    steps = sorted(ranks[0]["step_ms"])
    median = steps[len(steps) // 2]
    r = dict(wall_s=wall, dataset_s=data_s, median_step_ms=median,
             it_per_s=SHARD_CLI_ITERS / ranks[0]["wall_s"],
             steps_it_per_s=1e3 * SHARD_CLI_ITERS / sum(steps), step_ms=ranks[0]["step_ms"],
             losses=ranks[0]["losses"], launches=[rk["launches"] for rk in ranks],
             alive=ranks[0]["alive"], capacity=ranks[0]["capacity"],
             devices=[rk["device"] for rk in ranks])
    print(f"cli across 2 processes: {SHARD_CLI_ITERS} iterations, median step {median:.2f} ms "
          f"(steps {ranks[0]['step_ms']}), {r['steps_it_per_s']:.2f} it/s over the steps, "
          f"{r['it_per_s']:.2f} it/s over the CLI's wall {ranks[0]['wall_s']:.2f} s (its Scene "
          f"loading and evaluation included); losses "
          f"{ranks[0]['losses']}; alive {r['alive']} of {r['capacity']}; launches by rank "
          f"{r['launches']}; devices {r['devices']}", flush=True)
    return r


def sharded_phase(torch, dev, state, cam, bg, cfgs) -> tuple[dict, dict, list]:
    """The tile-sharded layout on the bench scene at full width: leg 1 the
    render strips, leg 2 the in-process steps (with carry), leg 3 two ranks
    on the card, leg 4 the train CLI across two processes. Returns the
    phase's summary, leg 2's results (on the host) and the two views."""
    t0 = time.perf_counter()
    legs_s = {}

    def leg(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        legs_s[name] = time.perf_counter() - t
        return out

    cfg = cfgs[TILES[0]][0]
    render_leg = leg("render", shard_render_leg, torch, dev, state, cam, bg, cfg)
    cams = leg("views", sharded_cameras, torch, dev)
    step_leg = leg("steps", shard_step_leg, torch, dev, state, cams, bg)
    ranks_leg = leg("ranks", shard_ranks_leg, torch, step_leg)
    cli = leg("cli", shard_cli_leg, torch, dev)
    wall = time.perf_counter() - t0
    print(f"sharded phase: wall {wall:.1f} s; legs (s) {legs_s}", flush=True)
    results = step_leg.pop("results")
    return (dict(wall_s=wall, legs_s=legs_s, render=render_leg, steps=step_leg,
                 ranks=ranks_leg, cli=cli), results, cams)


# --- the Gaussian-sharded layout (parallel/gauss_sharded.py, densify_sharded.py) ------------

# in-process meshes of the gauss steps; the two-process world's mesh; densify's mesh; rows a
# shard a rebalance round may move on the bench state (8 rounds of gs_tpu's default 4,096
# would leave the skew at 1.5)
GAUSS_STEP_MESHES = ((1, 2), (1, 4), (2, 2))
GAUSS_RANK_MESHES = ((1, 2),)
GAUSS_DENSIFY_SHARDS = 4
GAUSS_MIGRATION = 32_768
GAUSS_REBALANCE_SKEW = 1.25  # ParallelConfig.rebalance_skew
GAUSS_RESUME_ITERS = 3
# the train CLI under "gauss": SHARD_CLI_ARGS' fit (densify at 5 and 10) without its mesh
# flags, its last state checkpointed
GAUSS_CLI_ARGS = SHARD_CLI_ARGS[:-2] + ("--parallel_layout", "gauss",
                                        "--checkpoint_iterations", str(SHARD_CLI_ITERS))


def gauss_shards(torch, state, n_shard, keep=None):
    """{shard index: (state, adam, stats)} of a fresh TrainState of
    ``state``, cut into ``n_shard`` shards (only those in ``keep``)."""
    from gs_tpu_torch import training
    from gs_tpu_torch.parallel import gauss_sharded

    ts = training.init_train_state(state, 1.0, 3)
    return {s: gauss_sharded.shard_rows((ts.state, ts.adam, ts.stats), n_shard, s)
            for s in (range(n_shard) if keep is None else keep)}


def run_gauss(torch, mesh, shards, cams, bg, budget, cfg, visible_budget=None):
    """One gauss train step on ``mesh`` from ``shards``."""
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.parallel import gauss_sharded

    capacity = next(iter(shards.values()))[0].capacity * mesh.shard
    step = gauss_sharded.make_gauss_sharded_train_step(
        mesh, OptimizationParams(), cfg, HEIGHT, WIDTH, capacity, 3, pair_budget=budget,
        visible_budget=visible_budget)
    return step(*({s: v[i] for s, v in shards.items()} for i in range(3)), cams[:mesh.data],
                bg, 0, 1.0, True)


def gauss_whole(torch, mesh, out):
    """A gauss step's (state, adam, stats, metrics), its shards put together."""
    from gs_tpu_torch.parallel import gauss_sharded

    whole = gauss_sharded.gather_rows(mesh, {s: (out[0][s], out[1][s], out[2][s])
                                             for s in out[0]})
    return (*whole, out[3])


GAUSS_MODES = (("scatter", {}), ("cuda", dict(grad_reduce="cuda")),
               ("carry", dict(pair_source="carry")), ("tile", dict(kernel_mode="tile")))


def gauss_kernels_vs_plain(torch, fwd, bwd, label) -> dict:
    """B1 / B2 on the inputs a gauss step's strips gave them against their
    plain versions: the forward bitwise, the backward at its tolerance and
    the same bits twice."""
    from gs_tpu_torch.ops import rasterize_cuda

    out = dict(fwd_bitwise=True, bwd_worst_share=0.0, bwd_same_bits=True, max_abs_err=0.0)
    for args in fwd:
        got = rasterize_cuda.composite_fwd_cuda(*args)
        ref = rasterize_cuda.composite_fwd_torch(*args)
        out["fwd_bitwise"] &= all(torch.equal(a, b) for a, b in zip(got, ref))
        out["max_abs_err"] = max(out["max_abs_err"], compare(got, ref)[0])
    for args in bwd:
        got = rasterize_cuda.composite_bwd_cuda(*args)
        again = rasterize_cuda.composite_bwd_cuda(*args)
        err, ratio = compare_bwd(got, rasterize_cuda.composite_bwd_torch(*args))
        out["bwd_worst_share"] = max(out["bwd_worst_share"], ratio)
        out["bwd_same_bits"] &= torch.equal(got, again)
    print(f"{label}: B1 vs plain on its {len(fwd)} strips bitwise {out['fwd_bitwise']}; B2 worst "
          f"{out['bwd_worst_share']:.3g} of its tolerance, the same bits twice "
          f"{out['bwd_same_bits']}", flush=True)
    check(out["fwd_bitwise"] and out["bwd_worst_share"] <= 1.0 and out["bwd_same_bits"],
          f"{label}: B1 / B2 against their plain versions in the gauss strips")
    return out


def gauss_step_leg(torch, dev, state, cams, bg, tile, tile_ms,
                   meshes=GAUSS_STEP_MESHES) -> dict:
    """Leg 1: one gauss step on each in-process mesh under the default
    reduction, GRAD_REDUCE="cuda", PAIR_SOURCE="carry" and (on the first
    mesh) KERNEL_MODE="tile", counts reset just before and read just after
    each: exact launches (B1 / B2, or B3 / B4, once a strip, B5 / B6 by
    mode), within test_sharding.py's tolerances of the unsharded step over
    the same views and of the tile layout's step on the same mesh (``tile``,
    leg 2 of the sharded phase, on the host; its ms ``tile_ms``); carry
    equal to the "cuda" gather bitwise, the tile form's loss equal to the
    chunk form's and its step within tolerance; B1 / B2 against
    their plain versions on the first mesh's strips. Times beside the tile
    layout's."""
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.parallel import mesh as mesh_mod
    from gs_tpu_torch.parallel.sharded import local_pair_budget

    cfg, budget = step_budget(torch, state, cams, bg)
    refs = {d: batch_reference(torch, state, cams[:d], bg, cfg) for d in (1, 2)}
    results, launches, times, compared, visible, kernels = {}, {}, {}, {}, {}, {}
    for data, shard in meshes:
        mesh = mesh_mod.in_process_mesh(data, shard, device=dev)
        strips, local_budget = data * shard, local_pair_budget(budget, shard, cfg.chunk)
        modes = GAUSS_MODES if (data, shard) == meshes[0] else GAUSS_MODES[:3]
        for mode, kw in modes:
            key = f"{data}x{shard} {mode}"
            fwd, bwd = [], []
            reset_launches()
            with switches(**kw), capture_composite(fwd), capture_composite_bwd(
                    bwd, "composite_bwd_tile_cuda" if mode == "tile" else "composite_bwd_cuda"):
                out = run_gauss(torch, mesh, gauss_shards(torch, state, shard), cams, bg, budget,
                                cfg)
            torch.cuda.synchronize()
            launches[key] = la = dict(cuda_build.LAUNCHES)
            form = ("composite_fwd_tile", "composite_bwd_tile") if mode == "tile" else (
                "composite_fwd", "composite_bwd")
            want = launches_of(**{form[0]: strips, form[1]: strips}, preprocess_fwd=strips,
                               preprocess_bwd=strips,
                               segment_reduce=strips if mode in ("cuda", "carry") else 0,
                               expand_intervals=strips if mode == "carry" else 0)
            check(la == want, f"gauss {key}: a strip's launches ({la})")
            check(0 < int(out[3]["num_pairs_max"]) <= local_budget,
                  f"gauss {key}: every strip held its pairs")
            visible[key] = int(out[3]["num_visible_max"])
            check(0 < visible[key] <= N_GAUSS // shard, f"gauss {key}: visible rows a shard")
            if key == f"{meshes[0][0]}x{meshes[0][1]} scatter":
                kernels = gauss_kernels_vs_plain(torch, fwd, bwd, f"gauss {key}")
            del fwd, bwd
            whole = gauss_whole(torch, mesh, out)
            del out
            if mode in ("scatter", "cuda"):
                compared[key] = compare_step(torch, whole, refs[data], f"gauss {key}")
                tile_key = f"{data}x{shard} {mode}"
                if tile_key in tile:
                    compared[f"{key} vs tile"] = compare_step(
                        torch, to_host(torch, whole), tile[tile_key], f"gauss {key}",
                        "the tile layout's step")
            results[key] = to_host(torch, whole)
            del whole
            with switches(**kw):
                times[key] = cuda_ms(lambda: run_gauss(
                    torch, mesh, gauss_shards(torch, state, shard), cams, bg, budget, cfg), 2)
        check(same_bits(torch, results[f"{data}x{shard} carry"], results[f"{data}x{shard} cuda"]),
              f"gauss {data}x{shard}: carry equals the cuda gather bitwise")
        if f"{data}x{shard} tile" in results:
            check(same_bits(torch, results[f"{data}x{shard} tile"][3]["loss"],
                            results[f"{data}x{shard} scatter"][3]["loss"]),
                  f"gauss {data}x{shard}: the tile form's loss equals the chunk form's")
            compare_step(torch, results[f"{data}x{shard} tile"],
                         results[f"{data}x{shard} scatter"], f"gauss {data}x{shard} tile form",
                         "the chunk form")
    print(f"gauss steps (in-process, ms): {times}; visible rows of the worst shard {visible}",
          flush=True)
    print("gauss / tile layout step ms: " + ", ".join(
        f"{k}: {v:.2f} / {tile_ms[k]:.2f}" for k, v in times.items() if k in tile_ms),
        flush=True)
    return dict(results=results, launches=launches, step_ms=times, compared=compared,
                visible_max=visible, pair_budget=budget, kernels_vs_plain=kernels)


def gauss_budget_leg(torch, dev, state, cams, bg, steps) -> dict:
    """Leg 2: ``visible_budget`` on the first mesh: at the worst shard's
    visible count (leg 1) the step equals the unbudgeted one (bitwise
    expected; reported, else held at tolerance); at half of it the overflow
    is reported (num_visible_max above the budget) and the result is
    finite. Each timed beside the unbudgeted step."""
    from gs_tpu_torch.parallel import mesh as mesh_mod

    data, shard = GAUSS_STEP_MESHES[0]
    key = f"{data}x{shard} scatter"
    worst, exact = steps["visible_max"][key], steps["results"][key]
    cfg, budget = step_budget(torch, state, cams, bg)
    mesh = mesh_mod.in_process_mesh(data, shard, device=dev)
    out = {}
    for name, vb in (("worst", worst), ("half", worst // 2)):
        got = to_host(torch, gauss_whole(torch, mesh, run_gauss(
            torch, mesh, gauss_shards(torch, state, shard), cams, bg, budget, cfg, vb)))
        ms = cuda_ms(lambda: run_gauss(torch, mesh, gauss_shards(torch, state, shard), cams, bg,
                                       budget, cfg, vb), 2)
        seen = int(got[3]["num_visible_max"])
        r = dict(visible_budget=vb, num_visible_max=seen, loss=float(got[3]["loss"]), ms=ms,
                 table_rows=shard * vb, unbudgeted_rows=N_GAUSS)
        if name == "worst":
            r["bitwise"] = same_bits(torch, got[:3], exact[:3])
            print(f"gauss {key}, visible_budget {vb} (the worst shard's count): the step equals "
                  f"the unbudgeted one bitwise {r['bitwise']}; {ms:.2f} ms against "
                  f"{steps['step_ms'][key]:.2f}", flush=True)
            check(seen == worst, f"gauss {key}: a budget at the worst count drops nothing")
            if not r["bitwise"]:
                compare_step(torch, got, exact, f"gauss {key} budget {vb}", "the unbudgeted step")
        else:
            finite = bool(torch.isfinite(got[0].xyz).all()) and math.isfinite(r["loss"])
            print(f"gauss {key}, visible_budget {vb}: num_visible_max {seen} reported above the "
                  f"budget, loss {r['loss']:.6f}, finite {finite}; {ms:.2f} ms", flush=True)
            check(seen > vb and finite, f"gauss {key}: a half budget reports its overflow")
        out[name] = r
    return out


def spread_rows(torch, state, n_shard):
    """``state`` in twice its capacity with its alive rows dealt round robin
    over ``n_shard`` shards (row i to shard i % n_shard), each shard half
    free (tests/test_sharding.py:311-314)."""
    from gs_tpu_torch.models import gaussians

    n, cap = state.capacity, 2 * state.capacity
    local = cap // n_shard
    grown = gaussians.grow_capacity(state, cap)
    i = torch.arange(n, device=state.device)
    order = torch.empty(cap, dtype=torch.int64, device=state.device)
    dest = (i % n_shard) * local + i // n_shard
    order[dest] = i
    free = torch.ones(cap, dtype=torch.bool, device=state.device)
    free[dest] = False
    order[free] = torch.arange(n, cap, device=state.device)
    return dataclasses.replace(grown, **{f.name: getattr(grown, f.name)[order]
                                         for f in dataclasses.fields(grown)})


def sorted_rows(torch, state, *extra):
    """The alive rows of ``state`` (every parameter group, then ``extra``
    [C, ...] tensors), lexsorted on the host."""
    alive = state.alive
    cols = [t[alive].reshape(int(alive.sum()), -1)
            for t in (*state.params().values(), *extra)]
    rows = torch.cat(cols, dim=1).cpu().numpy()
    return rows[np.lexsort(rows.T[::-1])]


def gauss_densify_leg(torch, dev, state) -> dict:
    """Leg 3: densify and rebalance on the bench state over 4 shards. The
    state in twice its capacity, its rows dealt round robin, with
    content-keyed hot statistics (tests/test_sharding.py:286-297): the
    sharded densify's report, alive count and lexsorted alive rows against
    one-device ``densify_and_prune`` fed the same noise. Then shards 0-1
    full and 2-3 empty, every row's Adam moments and statistics tagged: the
    rebalance loop leaves max / mean at most the skew threshold, the alive
    count, and every alive row with its moments and statistics, bitwise."""
    from gs_tpu_torch import training
    from gs_tpu_torch.config import OptimizationParams
    from gs_tpu_torch.models import densify, optim
    from gs_tpu_torch.parallel import densify_sharded, gauss_sharded
    from gs_tpu_torch.parallel import mesh as mesh_mod

    n_shard = GAUSS_DENSIFY_SHARDS
    mesh = mesh_mod.in_process_mesh(1, n_shard, device=dev)
    spread = spread_rows(torch, state, n_shard)
    cap = spread.capacity
    h = torch.sin(spread.xyz.sum(dim=1) * 977.13)
    hot = densify.DensifyStats(((h > 0.6) & spread.alive).to(torch.float32),
                               torch.ones(cap, device=dev), torch.zeros(cap, device=dev))
    # the dense limit (percent_dense x extent) halfway between the smallest and
    # the largest scale, so that the round both clones and splits
    opt = OptimizationParams()
    scales = spread.scaling.amax(dim=1)[spread.alive]
    extent = float(scales.min() + scales.max()) / 2 / opt.percent_dense
    adam = optim.init(spread.params())
    noise = densify.split_noise(torch.Generator(device=dev).manual_seed(5), cap, dev)
    shards = {s: gauss_sharded.shard_rows((spread, adam, hot), n_shard, s)
              for s in range(n_shard)}
    fn = densify_sharded.make_sharded_densify(mesh, opt, cap, use_size_prune=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, adams, stats, rep = fn(*({s: v[i] for s, v in shards.items()} for i in range(3)),
                                   noise, extent)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    got = gauss_sharded.gather_rows(mesh, {s: (states[s], adams[s], stats[s]) for s in states})
    one_state, _, _, one_rep = densify.densify_and_prune(
        spread, adam, hot, noise, max_grad=opt.densify_grad_threshold,
        min_opacity=training.MIN_OPACITY, extent=extent,
        percent_dense=opt.percent_dense, use_size_prune=False)
    reports = [tuple(int(v) for v in r) for r in (rep, one_rep)]
    a, b = sorted_rows(torch, got[0]), sorted_rows(torch, one_state)
    same = a.shape == b.shape and np.array_equal(a, b)
    close = a.shape == b.shape and np.allclose(a, b, rtol=1e-6, atol=1e-7)
    print(f"gauss densify on {n_shard} shards: report (cloned, split, pruned, dropped) "
          f"{reports[0]} (one device {reports[1]}), extent {extent:.4f}; alive "
          f"{int(got[0].num_alive)} "
          f"(one device {int(one_state.num_alive)}); sorted alive rows bitwise equal {same}, "
          f"within rtol 1e-6 {close}; {sharded_s * 1e3:.1f} ms", flush=True)
    check(reports[0] == reports[1] and reports[0][0] > 0 and reports[0][1] > 0
          and reports[0][3] == 0, "gauss densify: the one-device report, clones and splits")
    check(int(got[0].num_alive) == int(one_state.num_alive) and close,
          "gauss densify: the one-device alive rows")
    del got, states, adams, stats, one_state, shards

    # shards 0-1 full, 2-3 empty; moments and statistics tag their row
    ts = training.grow_train_state(training.init_train_state(state, 1.0, 3), cap)
    ts.adam = optim.AdamState(mu={k: v * 0.5 for k, v in ts.state.params().items()},
                              nu={k: v * v for k, v in ts.state.params().items()},
                              step=dict(ts.adam.step))
    ts.stats = densify.DensifyStats(ts.state.xyz[:, 0], ts.state.xyz[:, 1], ts.state.xyz[:, 2])
    before = sorted_rows(torch, ts.state, *ts.adam.mu.values(), *ts.adam.nu.values(), *ts.stats)
    shards = {s: gauss_sharded.shard_rows((ts.state, ts.adam, ts.stats), n_shard, s)
              for s in range(n_shard)}
    occ0 = densify_sharded.shard_occupancy(mesh, {s: v[0] for s, v in shards.items()})
    loop = densify_sharded.make_sharded_rebalance_loop(mesh, migration_budget=GAUSS_MIGRATION)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, adams, stats, moved = loop(*({s: v[i] for s, v in shards.items()} for i in range(3)),
                                       GAUSS_REBALANCE_SKEW)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    occ = densify_sharded.shard_occupancy(mesh, states)
    whole = gauss_sharded.gather_rows(mesh, {s: (states[s], adams[s], stats[s]) for s in states})
    after = sorted_rows(torch, whole[0], *whole[1].mu.values(), *whole[1].nu.values(), *whole[2])
    kept = before.shape == after.shape and np.array_equal(before, after)
    skew = max(occ) / (sum(occ) / len(occ))
    print(f"gauss rebalance on {n_shard} shards (migration budget {GAUSS_MIGRATION}): occupancy "
          f"{occ0} -> {occ}, max/mean {skew:.4f}, {moved} rows moved in {loop_s * 1e3:.1f} ms; "
          f"every alive row with its moments and statistics kept bitwise {kept}", flush=True)
    check(skew <= GAUSS_REBALANCE_SKEW and sum(occ) == sum(occ0) == N_GAUSS and kept,
          "gauss rebalance: balanced, no row lost, rows kept bitwise")
    return dict(densify=dict(report=reports[0], one_device_report=reports[1], extent=extent,
                             rows_bitwise=same, ms=sharded_s * 1e3),
                rebalance=dict(occupancy_before=occ0, occupancy_after=occ, skew=skew,
                               moved=moved, ms=loop_s * 1e3, rows_kept_bitwise=kept))


def gauss_rank(rank, world, rdv, out, meshes) -> None:
    """A rank of the gauss ranks leg (card ``rank % device_count``: gloo when
    ranks share a card, NCCL with a card a rank): the bench scene and the
    two views made here, one gauss step on each (data, shard) mesh of
    ``meshes`` under GRAD_REDUCE "cuda" and "scatter" from this rank's shard
    (the whole state freed first), saved to ``out`` on the host; then, on
    the first mesh, the bytes of the shard's leaves, the peak device memory
    of a step and of gathering the whole state, and the phase times of
    three more steps under each reduction."""
    import torch

    sys.path.insert(0, ROOT)
    from gs_tpu_torch.parallel import gauss_sharded
    from gs_tpu_torch.parallel import mesh as mesh_mod

    dev = mesh_mod.rank_device("cuda", rank)
    backend = mesh_mod.init_distributed(rdv, world, rank, device=dev)
    try:
        torch.cuda.set_device(dev)
        state = make_bench_state(dev, 0)
        cams = sharded_cameras(torch, dev)
        bg = torch.zeros(3, device=dev)
        cfg, budget = step_budget(torch, state, cams, bg)
        results = {"backend": backend, "device": str(dev)}
        mine = {}
        for data, shard in meshes:
            mesh = mesh_mod.make_mesh(data, shard, device=dev)
            s = mesh.ranks[0][1]
            mine[(data, shard)] = gauss_shards(torch, state, shard, keep=(s,))
        del state
        torch.cuda.empty_cache()
        for data, shard in meshes:
            mesh = mesh_mod.make_mesh(data, shard, device=dev)
            s = mesh.ranks[0][1]
            for reduce in ("cuda", "scatter"):
                with switches(grad_reduce=reduce):
                    o = run_gauss(torch, mesh, mine[(data, shard)], cams, bg, budget, cfg)
                results[f"{data}x{shard} {reduce}"] = to_host(torch, (o[0][s], o[1][s], o[2][s],
                                                                      o[3]))
                del o
        mesh = mesh_mod.make_mesh(*meshes[0], device=dev)
        shards = mine[meshes[0]]
        leaves = gauss_sharded.row_tensors(next(iter(shards.values())))
        torch.cuda.reset_peak_memory_stats(dev)
        with switches(grad_reduce="cuda"):
            run_gauss(torch, mesh, shards, cams, bg, budget, cfg)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        whole = gauss_sharded.gather_rows(mesh, shards)
        torch.cuda.synchronize()
        gather_peak = torch.cuda.max_memory_allocated(dev)
        whole_bytes = sum(t.nbytes for t in gauss_sharded.row_tensors(whole))
        del whole
        results["memory"] = dict(shard_bytes=sum(t.nbytes for t in leaves),
                                 whole_bytes=whole_bytes, step_peak=step_peak,
                                 gather_peak=gather_peak)
        results.update(gauss_phase_times(torch, mesh, shards, cams, bg, budget, cfg))
        torch.save(results, out)
    finally:
        torch.distributed.destroy_process_group()


def gauss_phase_times(torch, mesh, shards, cams, bg, budget, cfg) -> dict:
    """Wall seconds of the phases of three gauss steps under each
    reduction, after a warm-up: the projection, the table gather, the
    strips, the strip gather, the banded loss, the image cotangent and loss
    sums, the table cotangent sum (sum-then-slice), the data and metric
    reductions, Adam and the statistics; the rest is the backward through
    the strips and the projection."""
    from gs_tpu_torch.parallel import gauss_sharded
    from gs_tpu_torch.parallel import mesh as mesh_mod

    spent, active = {}, []

    def timed(owner, name, kind):
        real = getattr(owner, name)

        def run(*args, **kwargs):
            if active:  # a phase inside another is the outer one's
                return real(*args, **kwargs)
            label = kind(args) if callable(kind) else kind
            active.append(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
                active.pop()
        setattr(owner, name, run)
        return owner, name, real

    def gather_kind(args):
        x = next(iter(args[1].values()))
        return "table gather" if x.shape[-1] == gauss_sharded.SPLAT_W else "strip gather"

    saved = [timed(gauss_sharded, n, k) for n, k in (
        ("local_forward", "projection"), ("table_strip", "strips"),
        ("band_cotangent", "banded loss"), ("apply_step", "Adam and stats"))]
    saved += [timed(mesh_mod.Mesh, "gather_shard", gather_kind),
              timed(mesh_mod.Mesh, "sum_scatter_shard", "table cotangent sum"),
              timed(mesh_mod.Mesh, "sum_shard", "image cotangent and loss sums")]
    saved += [timed(mesh_mod.Mesh, n, "data and metric reductions")
              for n in ("sum_data", "max_data", "max_all")]
    out = {}
    try:
        for reduce in ("scatter", "cuda"):
            with switches(grad_reduce=reduce):
                run_gauss(torch, mesh, shards, cams, bg, budget, cfg)  # warm
                spent.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    run_gauss(torch, mesh, shards, cams, bg, budget, cfg)
                torch.cuda.synchronize()
            out[f"step_s {reduce}"] = (time.perf_counter() - t0) / 3
            out[f"phase_s {reduce}"] = {k: v / 3 for k, v in spent.items()}
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)
    return out


def gauss_ranks_leg(torch, steps, meshes=GAUSS_RANK_MESHES) -> dict:
    """Leg 4: a world of data x shard processes (``meshes`` share the size),
    one gauss step on each mesh under "cuda" and "scatter": the ranks'
    metrics bitwise equal; under "cuda" in a world of two, rank (d, s)'s
    shard bitwise equal to the in-process step's shard s (leg 1), else
    within its tolerances; the backend; per-rank memory; the phase shares
    of rank 0's steps on the first mesh."""
    from gs_tpu_torch.ops import cuda_build

    world = meshes[0][0] * meshes[0][1]
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as work:
        t0 = time.perf_counter()
        _, outs = spawn_world("gauss_rank", world, work, (meshes,))
        wall = time.perf_counter() - t0
        ranks = [torch.load(o, weights_only=False) for o in outs]
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    check(all(r["backend"] == backend for r in ranks),
          f"{world} gauss ranks on {torch.cuda.device_count()} card(s) take {backend}")
    checks = {}
    for data, shard in meshes:
        for reduce in ("cuda", "scatter"):
            key = f"{data}x{shard} {reduce}"
            check(all(same_bits(torch, ranks[0][key][3], r[key][3]) for r in ranks[1:]),
                  f"gauss {key}: the ranks' metrics are bitwise equal")
            local = steps["results"][key]
            rows = N_GAUSS // shard
            bitwise = []
            for rank, r in enumerate(ranks):
                s = rank % shard
                want = gauss_sharded_rows(torch, local, s * rows, (s + 1) * rows)
                bitwise.append(same_bits(torch, r[key][:3], want[:3]))
            if reduce == "cuda" and world == 2:
                check(all(bitwise), f"gauss {key}: each rank's shard equals the in-process "
                                    f"step's bitwise")
            else:
                got = gauss_concat(torch, [ranks[s][key] for s in range(shard)])
                compare_step(torch, got, local, f"gauss {key} ranks", "the in-process step")
            checks[key] = dict(bitwise_to_in_process=all(bitwise))
    memory = [r["memory"] for r in ranks]
    for rank, m in enumerate(memory):
        print(f"gauss rank {rank}: shard leaves {m['shard_bytes'] / 2**20:.1f} MiB (whole "
              f"{m['whole_bytes'] / 2**20:.1f} MiB); peak device memory of a step "
              f"{m['step_peak'] / 2**20:.1f} MiB, of gathering the whole state "
              f"{m['gather_peak'] / 2**20:.1f} MiB", flush=True)
    step_ms, phase_ms, shares = {}, {}, {}
    for reduce in ("scatter", "cuda"):
        step_s, phase_s = ranks[0][f"step_s {reduce}"], ranks[0][f"phase_s {reduce}"]
        step_ms[reduce] = 1e3 * step_s
        phase_ms[reduce] = {k: 1e3 * v for k, v in phase_s.items()}
        phase_ms[reduce]["rest (backward through strips and projection)"] = (
            1e3 * (step_s - sum(phase_s.values())))
        shares[reduce] = {k: v / step_ms[reduce] for k, v in phase_ms[reduce].items()}
        print(f"{world} gauss ranks ({backend}), GRAD_REDUCE={reduce!r}: rank 0's "
              f"{meshes[0][0]}x{meshes[0][1]} step {step_ms[reduce]:.2f} ms: " + ", ".join(
                  f"{k} {v:.2f} ms ({100 * shares[reduce][k]:.1f}%)"
                  for k, v in phase_ms[reduce].items()), flush=True)
    print(f"{world} gauss ranks on {[r['device'] for r in ranks]}: {wall:.1f} s with start-up",
          flush=True)
    return dict(wall_s=wall, backend=backend, checks=checks, step_ms=step_ms,
                phase_ms=phase_ms, shares=shares, memory=memory)


def gauss_sharded_rows(torch, result, lo, hi):
    """Rows [lo, hi) of a whole (state, adam, stats, metrics) result."""
    from gs_tpu_torch.parallel import gauss_sharded

    return (*gauss_sharded.map_tensors(lambda t: t[lo:hi] if t.dim() >= 1 else t, result[:3]),
            result[3])


def gauss_concat(torch, parts):
    """A whole (state, adam, stats, metrics) from shards' results in shard
    order (on the host)."""
    from gs_tpu_torch.parallel import gauss_sharded
    from gs_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.in_process_mesh(1, len(parts), device="cpu")
    return (*gauss_sharded.gather_rows(mesh, {s: p[:3] for s, p in enumerate(parts)}),
            parts[0][3])


def gauss_cli_leg(torch, dev, data=1, shard=2, evaluate=True) -> dict:
    """Leg 5: ``cli_dataset``, then the train CLI with ``--parallel_layout
    gauss`` as ``data`` x ``shard`` processes (rank r in an empty directory
    but rank 0) for SHARD_CLI_ITERS iterations with densify at 5 and 10 and
    a checkpoint at the last: exit 0, finite losses equal on every rank, no
    autotune, rank 0 alone writing and evaluating, one B2 launch a strip a
    step, each rank holding its data row's train images; rank 0's PLY holds
    the alive rows of the shards put together in shard order, bitwise, and
    renders (eval_render) equal to them; its .npz checkpoint is that state.
    Then the checkpoint as a directory (``ckpt.save_train_state`` of the
    .npz) and a run resumed from it for GAUSS_RESUME_ITERS steps. With
    ``evaluate=False`` the fit has no test split (10 train views)."""
    from gs_tpu_torch.config import ModelParams, RasterizeConfig
    from gs_tpu_torch.data import ply
    from gs_tpu_torch.ops import cuda_build
    from gs_tpu_torch.parallel import gauss_sharded
    from gs_tpu_torch.parallel import mesh as mesh_mod
    from gs_tpu_torch.renderer import render
    from gs_tpu_torch.scene import Scene
    from gs_tpu_torch.training import eval_render
    from gs_tpu_torch.utils import ckpt

    world = data * shard
    layout = ("--data_parallel", str(data), "--shard_parallel", str(shard))
    fit_args = [a for a in GAUSS_CLI_ARGS if a != "--eval" or evaluate] + list(layout)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as work:
        data_dir, model = os.path.join(work, "colmap"), os.path.join(work, "model")
        idle = [os.path.join(work, f"idle{r}") for r in range(1, world)]
        for d in idle:
            os.makedirs(d)
        t0 = time.perf_counter()
        cli_dataset(torch, dev, data_dir)
        data_s = time.perf_counter() - t0

        def run_world(argv):
            rdv = f"127.0.0.1:{free_port()}"
            envs = [dict(os.environ, GS_TPU_NUM_PROCESSES=str(world), GS_TPU_PROCESS_ID=str(r),
                         GS_TPU_COORDINATOR=rdv) for r in range(world)]
            t = time.perf_counter()
            logs, outs = spawn_world("cli_rank", world, work, ("-s", data_dir, "-m", model,
                                                               *argv),
                                     rdv=rdv, envs=envs, cwds=[work, *idle])
            wall = time.perf_counter() - t
            ranks = []
            for o in outs:
                with open(o) as f:
                    ranks.append(json.load(f))
            shards = [torch.load(o + ".pt", weights_only=False) for o in outs]
            return logs, ranks, shards, wall

        logs, ranks, shards, wall = run_world(fit_args)
        check(all(os.listdir(d) == [] for d in idle), "only rank 0 wrote in its directory")
        n_train = CLI_VIEWS - (2 if evaluate else 0)
        for r, (rk, log) in enumerate(zip(ranks, logs)):
            n = len(rk["step_ms"])
            check(n == SHARD_CLI_ITERS and all(math.isfinite(v) for v in rk["losses"])
                  and rk["losses"] == ranks[0]["losses"],
                  f"gauss cli rank {r}: {SHARD_CLI_ITERS} steps, finite losses equal to rank 0's")
            check(rk["autotune_calls"] == 0, f"gauss cli rank {r}: the autotune is skipped")
            la = rk["launches"]
            check(la["composite_bwd"] == la["preprocess_bwd"] == n
                  and la["composite_bwd_tile"] == 0
                  and la["preprocess_fwd"] == la["composite_fwd"] + la["composite_fwd_tile"],
                  f"gauss cli rank {r}: one B2 and one preprocess VJP launch a strip a step, "
                  f"one P2 a forward compositing launch ({la})")
            check(rk["train_images"] == n_train // data,
                  f"gauss cli rank {r}: its data row's {n_train // data} of {n_train} train "
                  f"images ({rk['train_images']})")
            saving, evaluating = log.count("Saving Gaussians"), log.count("Evaluating")
            check(saving == (1 if r == 0 else 0) and (evaluating > 0) == (r == 0),
                  f"gauss cli rank {r}: saving / evaluation lines {saving} / {evaluating}")
        for r in range(shard, world):  # the other data rows hold the same shards
            check(same_bits(torch, shards[r], shards[r % shard]),
                  f"gauss cli rank {r}: the shard of data row 0's rank {r % shard}")
        mesh = mesh_mod.in_process_mesh(1, shard, device=dev)
        whole = gauss_sharded.gather_rows(
            mesh, {s: tuple(to_device(torch, x, dev) for x in shards[s]) for s in range(shard)})
        saved = ply.load_gaussian_ply(os.path.join(
            model, f"point_cloud/iteration_{SHARD_CLI_ITERS}/point_cloud.ply"), device=dev)
        alive = whole[0].alive
        n_alive = int(alive.sum())
        check(n_alive == int(saved.num_alive) == sum(rk["alive"] for rk in ranks[:shard])
              and all(torch.equal(getattr(saved, k)[:n_alive], getattr(whole[0], k)[alive])
                      for k in ("xyz", "features_dc", "features_rest", "log_scale", "quat",
                                "logit_opacity")),
              "rank 0's PLY holds the shards' alive rows in shard order, bitwise")
        shown = Scene(ModelParams(source_path=data_dir, model_path=model, eval=evaluate,
                                  resolution=1), load_iteration=SHARD_CLI_ITERS, shuffle=False,
                      load_images=False, device=dev)
        bg = torch.zeros(3, device=dev)

        def full_render(st, c):
            """eval_render with a budget of 1.05 x the view's pairs: the PLY's
            capacity is not the shards', and the default budget truncates."""
            n = int(render(c, st, active_sh_degree=3, bg_color=bg,
                           cfg=RasterizeConfig()).num_pairs)
            return eval_render(st, c, bg, active_sh_degree=3, raster_cfg=RasterizeConfig(
                pair_budget_factor=1.05 * n / st.capacity))

        cams = (shown.get_test_cameras() or shown.get_train_cameras())[:2]
        renders_equal = all(torch.equal(full_render(saved, c), full_render(whole[0], c))
                            for c in cams)
        check(renders_equal, "the saved PLY renders as the shards put together, bitwise")
        npz = os.path.join(model, f"chkpnt{SHARD_CLI_ITERS}.npz")
        restored = ckpt.load_train_state(npz, device=dev)
        check(restored.iteration == SHARD_CLI_ITERS
              and same_bits(torch, (restored.state, restored.adam, restored.stats), whole),
              "rank 0's .npz checkpoint is the shards put together")
        directory = os.path.join(work, f"chkpnt{SHARD_CLI_ITERS}")
        ckpt.save_train_state(directory, restored)
        del whole, saved, restored, shards
        resume_args = list(fit_args) + ["--start_checkpoint", directory]
        i = resume_args.index("--iterations")
        resume_args[i + 1] = str(SHARD_CLI_ITERS + GAUSS_RESUME_ITERS)
        j = resume_args.index("--test_iterations")
        resume_args[j + 1] = "-1"
        r_logs, r_ranks, _, r_wall = run_world(resume_args)
        for r, (rk, log) in enumerate(zip(r_ranks, r_logs)):
            check(len(rk["step_ms"]) == GAUSS_RESUME_ITERS
                  and rk["iteration"] == SHARD_CLI_ITERS + GAUSS_RESUME_ITERS
                  and f"Restored checkpoint at iteration {SHARD_CLI_ITERS}" in log,
                  f"gauss cli rank {r}: resumed from the directory for {GAUSS_RESUME_ITERS} "
                  f"steps")
    steps = sorted(ranks[0]["step_ms"])
    median = steps[len(steps) // 2]
    out = dict(wall_s=wall, dataset_s=data_s, median_step_ms=median,
               steps_it_per_s=1e3 * SHARD_CLI_ITERS / sum(steps),
               it_per_s=SHARD_CLI_ITERS / ranks[0]["wall_s"], step_ms=ranks[0]["step_ms"],
               losses=ranks[0]["losses"], launches=[rk["launches"] for rk in ranks],
               train_images=[rk["train_images"] for rk in ranks], alive=n_alive,
               devices=[rk["device"] for rk in ranks], resume_wall_s=r_wall,
               resume_step_ms=r_ranks[0]["step_ms"], renders_equal=renders_equal)
    print(f"gauss cli on {data}x{shard} processes: {SHARD_CLI_ITERS} iterations, median step "
          f"{median:.2f} ms (steps {ranks[0]['step_ms']}), {out['steps_it_per_s']:.2f} it/s over "
          f"the steps, {out['it_per_s']:.2f} it/s over the CLI's wall {ranks[0]['wall_s']:.2f} s; "
          f"losses {ranks[0]['losses']}; alive {n_alive}; train images by rank "
          f"{out['train_images']}; resumed {GAUSS_RESUME_ITERS} steps "
          f"{r_ranks[0]['step_ms']} ms; devices {out['devices']}", flush=True)
    return out


def to_device(torch, x, dev):
    """A host result moved to ``dev`` (to_host's inverse)."""
    from gs_tpu_torch.parallel import gauss_sharded

    return gauss_sharded.map_tensors(lambda t: t.to(dev), x)


def gauss_phase(torch, dev, state, cams, bg, tile) -> dict:
    """The Gaussian-sharded layout on the bench scene at full width: leg 1
    the in-process steps (with carry and the tile form), leg 2 the visible
    budget, leg 3 densify and rebalance, leg 4 two ranks on the card, leg 5
    the train CLI across two processes with a directory resume. ``tile``:
    the sharded phase's step results and times."""
    t0 = time.perf_counter()
    legs_s = {}

    def leg(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        legs_s[name] = time.perf_counter() - t
        return out

    steps = leg("steps", gauss_step_leg, torch, dev, state, cams, bg, tile["results"],
                tile["step_ms"])
    budget = leg("visible budget", gauss_budget_leg, torch, dev, state, cams, bg, steps)
    dens = leg("densify", gauss_densify_leg, torch, dev, state)
    ranks = leg("ranks", gauss_ranks_leg, torch, steps)
    cli = leg("cli", gauss_cli_leg, torch, dev)
    wall = time.perf_counter() - t0
    print(f"gauss phase: wall {wall:.1f} s; legs (s) {legs_s}", flush=True)
    del steps["results"]
    return dict(wall_s=wall, legs_s=legs_s, steps=steps, visible_budget=budget,
                densify=dens, ranks=ranks, cli=cli)


def make_heavy_state(dev, seed: int):
    """bench.py's heavy scene (bench.py:64-81, heavy=True) made from
    ``default_rng(seed)``, draw for draw: ``create_from_pcd``'s state with
    its log-scales and opacities replaced by bench.py's draws. That state
    is built here field by field without ``create_from_pcd``'s 3-NN, whose
    scales the draws replace (the 1M-point brute-force 3-NN took 27 s of
    the card)."""
    import torch

    from gs_tpu_torch.models import gaussians
    from gs_tpu_torch.ops import sh

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, size=(N_HEAVY, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, size=(N_HEAVY, 3)).astype(np.float32)
    log_scale = rng.uniform(-5.5, -2.0, size=(N_HEAVY, 3)).astype(np.float32)
    logit_opacity = rng.uniform(-1.5, 2.5, size=(N_HEAVY, 1)).astype(np.float32)
    state = gaussians.empty_state(N_HEAVY, 3, device=dev)
    state.xyz.copy_(torch.from_numpy(pts))
    state.features_dc.copy_(sh.rgb_to_sh(torch.from_numpy(cols).to(dev))[:, None, :])
    state.log_scale.copy_(torch.from_numpy(log_scale))
    state.logit_opacity.copy_(torch.from_numpy(logit_opacity))
    state.alive.fill_(True)
    return state


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
    check(render_launches == launches_of(composite_fwd_tile=1, preprocess_fwd=1),
          "the heavy render launches composite_fwd_tile and P2 once and nothing else")
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
    losses, bwd_calls, pcalls, step_s = [], [], [], []
    reset_launches()
    with capture_composite_bwd(bwd_calls, "composite_bwd_tile_cuda"), \
            capture_preprocess_bwd(pcalls):
        for i in range(HEAVY_TRAIN_STEPS):
            bwd_calls.clear()  # keep the last step's inputs only
            pcalls.clear()
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
                                        composite_bwd_tile=HEAVY_TRAIN_STEPS,
                                        preprocess_fwd=HEAVY_TRAIN_STEPS,
                                        preprocess_bwd=HEAVY_TRAIN_STEPS),
          "one fwd-tile, one bwd-tile, one P2 and one preprocess VJP launch per heavy "
          "train_step, no chunk-grid kernel")
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
        print_ranges(f"{label} {kind}", r)
    check(same, "B3 equals B1 bitwise on the heavy frame")
    check(c_err <= TOL_COLOR and t_err <= TOL_T and mism <= TOL_NCON_SHARE * pixels,
          "B3 vs plain on the heavy frame")
    k_ms, b1_ms = timed_in_turns(torch, lambda: rc.composite_fwd_tile_cuda(*fwd_args),
                                 lambda: rc.composite_fwd_cuda(*fwd_args), other_reps=20,
                                 warm=False)
    k2_ms, p_ms = timed_in_turns(torch, lambda: rc.composite_fwd_tile_cuda(*fwd_args),
                                 lambda: rc.composite_fwd_torch(*fwd_args), warm=False)
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
                                 lambda: rc.composite_bwd_cuda(*bwd_args), other_reps=20,
                                 warm=False)
    k2_ms, p_ms = timed_in_turns(torch, lambda: rc.composite_bwd_tile_cuda(*bwd_args),
                                 lambda: rc.composite_bwd_torch(*bwd_args), warm=False)
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
    check(both == launches_of(segment_reduce=1, expand_intervals=1, preprocess_fwd=1,
                              preprocess_bwd=1,
                              **{k: 1 for k in tile_form}),
          "one heavy train_step with both switches launches B3, B4, B5 and B6 once each")
    check(math.isfinite(float(m["loss"])), "finite heavy loss with both switches on")
    carry = carry_path(torch, label, shape, state, cam, cam_t, bg, grown, tile_form)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"heavy phase peak device memory {peak:.2f} GiB", flush=True)
    args = pcalls.pop()
    pre_fwd = preprocess_fwd_path(torch, label, shape, args, train_launches["preprocess_fwd"])
    pre = preprocess_path(torch, label, shape, args, train_launches["preprocess_bwd"])
    return dict(fwd=fwd, bwd=bwd, peak_gib=peak, reduce=reduce, expand=expand,
                both_switches_launches=both, carry=carry, preprocess=pre,
                preprocess_fwd=pre_fwd)


def recovery_phase(torch, dev) -> dict:
    """run_training through synthetic.recover at benchmarks/synthetic_e2e.py's
    defaults, whose ``RasterizeConfig()`` now autotunes at startup (as
    benchmarks/synthetic_e2e.py:93 does on a TPU), counts reset just before
    and read just after, the sweep's launches counted apart and its globals
    put back afterwards, the ground truth's renders (before the sweep, at the
    default switches) counted apart too. The steps and the test renders
    launch the winner's form only, and the pair-movement kernels exactly
    when the winner carries."""
    from gs_tpu_torch import synthetic
    from gs_tpu_torch.ops import rasterize_cuda

    reset_launches()
    info, store = {}, {}
    t0 = time.perf_counter()
    iters, views = 2000, 64
    with switches(), record_autotune(store):
        psnr, state = synthetic.recover(iters=iters, res=256, gt_gaussians=4096,
                                        init_points=2048, views=views, device=dev, verbose=True,
                                        info=info)
    wall = time.perf_counter() - t0
    check(len(store["sweeps"]) == 1, "one startup sweep in the recovery run")
    sweep = check_sweep(store["sweeps"][0], "recovery")
    # the ground truth's 64 renders come before the sweep, at the default switches
    gt_launches = store["sweeps"][0]["launches_before"]
    check(gt_launches == launches_of(composite_fwd=views, preprocess_fwd=views),
          f"one B1 and one P2 launch a ground-truth render before the sweep ({gt_launches})")
    launches = {k: v - sweep["launches"][k] - gt_launches[k]
                for k, v in rasterize_cuda.LAUNCHES.items()}
    print(f"recovery: test PSNR {psnr:.3f} dB (min {RECOVERY_PSNR_MIN}), per view "
          f"{info['psnrs']}; alive {info['alive']} of capacity {state.capacity}; training "
          f"{info['train_s']:.2f} s ({iters / info['train_s']:.1f} it/s, the "
          f"{sweep['wall_s']:.2f} s sweep included) under {sweep['winner']}, phase wall "
          f"{wall:.2f} s; launches of the training and the test renders {launches} (the "
          f"ground truth's before the sweep {gt_launches})", flush=True)
    check(math.isfinite(psnr) and psnr > RECOVERY_PSNR_MIN, "recovery PSNR")
    fwd, bwd = FORM_KERNELS[sweep["kernel_mode"]]
    other_fwd, other_bwd = FORM_KERNELS["tile" if sweep["kernel_mode"] == "chunk" else "chunk"]
    tests = len(info["psnrs"])
    check(launches[fwd] == iters + tests and launches[bwd] == iters
          and launches["preprocess_bwd"] == iters and launches["preprocess_fwd"] == iters + tests,
          f"the winner's {fwd} and P2 a step and a test render, {bwd} and the preprocess VJP "
          f"a step")
    check(launches[other_fwd] == 0 and launches[other_bwd] == 0,
          f"no {other_fwd} / {other_bwd} launched by run_training under the winner's form")
    carry = sweep["pair_source"] == "carry"
    check(launches["segment_reduce"] == (iters if carry else 0)
          and launches["expand_intervals"] == (iters + tests if carry else 0),
          "B5 a step and B6 a step and a test render exactly when the winner carries")
    return dict(psnr=psnr, train_s=info["train_s"], it_per_s=iters / info["train_s"],
                alive=info["alive"], capacity=state.capacity, launches=launches,
                autotune=sweep)


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


def mesh_phase(torch, dev, cards: int) -> dict:
    """``--cards N``: on MESH_CARD_MESHES of N processes with a card each
    (NCCL), the tile-sharded step and the gauss step against the in-process
    meshes of the same shapes on card 0 (and the unsharded step), with
    rank 0's phase shares and, under "gauss", every rank's memory; on four
    cards also the train CLI on a (2, 2) gauss world, each data row's ranks
    loading only its 5 of the 10 train views."""
    meshes = tuple(m for m in MESH_CARD_MESHES if m[0] * m[1] == cards)
    check(bool(meshes), f"a mesh of {cards} cards in {MESH_CARD_MESHES}")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
        state, cam = bench_scene(torch, dev, workdir)
    cams = sharded_cameras(torch, dev)
    bg = torch.zeros(3, device=dev)
    step_leg = shard_step_leg(torch, dev, state, cams, bg, meshes)
    ranks = shard_ranks_leg(torch, step_leg, meshes)
    gauss_steps = gauss_step_leg(torch, dev, state, cams, bg, step_leg.pop("results"),
                                 step_leg["step_ms"], meshes)
    del state
    gauss_ranks = gauss_ranks_leg(torch, gauss_steps, meshes)
    del gauss_steps["results"]
    out = dict(steps=step_leg, ranks=ranks, gauss_steps=gauss_steps, gauss_ranks=gauss_ranks)
    if (2, 2) in meshes:
        out["gauss_cli"] = gauss_cli_leg(torch, dev, data=2, shard=2, evaluate=False)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    cards = int(sys.argv[sys.argv.index("--cards") + 1]) if "--cards" in sys.argv else 1
    if "--p1_reference" in sys.argv:
        global P1_REFERENCE
        P1_REFERENCE = os.path.abspath(sys.argv[sys.argv.index("--p1_reference") + 1])
    sys.path.insert(0, ROOT)
    from gs_tpu_torch.ops import cuda_build

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

    phase_s, last = {}, [t_start]

    def mark(phase: str) -> None:
        """Record and print the wall seconds since the previous mark."""
        now = time.perf_counter()
        phase_s[phase] = round(now - last[0], 3)
        last[0] = now
        print(f"phase {phase}: {phase_s[phase]:.1f} s", flush=True)

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

    if cards > 1:
        check(count >= cards, f"{cards} cards ({count} found)")
        mesh = mesh_phase(torch, dev, cards)
        print(f"chip_smoke --cards {cards} wall {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"mesh": mesh}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": count}}), flush=True)
        return 0

    mark("card and build")
    # 3. the chunk-grid kernels, the render and its gradients on the golden bundle
    golden_phase(torch, dev)
    mark("golden")

    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as workdir:
        state, cam = bench_scene(torch, dev, workdir)
    bg = torch.zeros(3, device=dev)

    cfgs = bench_configs(torch, state, cam, bg)
    mark("bench scene")

    # 4. the render path
    render_launches, fwd_results, fwd_captured = render_phase(torch, state, cam, bg, cfgs)
    mark("render")
    # 5. the training path
    train_launches, bwd_results, bwd_captured, cam_t, p1_results, p2_results = train_phase(
        torch, dev, state, cam, bg, cfgs)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    mark("train")
    # 5b. the bench scene at SH degree 4: render, train_steps, PLY, the reference binning
    sh4 = sh4_phase(torch, dev, state, cam_t, bg, cfgs)
    mark("sh4")
    # 6. the tile-walk kernels on the bench inputs, against the chunk-grid ones
    fwd_tile_bench, bwd_tile_bench = tile_forms_on_bench(torch, fwd_captured, bwd_captured)
    del fwd_captured, bwd_captured
    mark("tile forms")
    # 6b. B1-B4 at the chunk sizes the startup autotune can choose
    chunk_paths = chunk_sizes_phase(torch, state, cam_t, bg, cfgs)
    mark("chunk sizes")
    # 7. B5 (GRAD_REDUCE="cuda"), B6 (EXPAND_IMPL="cuda") and both under
    # PAIR_SOURCE="carry" on the bench scene
    reduce_paths, expand_paths, carry_paths = {}, {}, {}
    for tw, th in TILES:
        label = f"bench {tw}x{th}"
        shape = f"{WIDTH}x{HEIGHT}, {N_GAUSS} Gaussians, {tw}x{th} tiles"
        chunk_form = ("composite_fwd", "composite_bwd")
        reduce_paths[label] = reduce_path(torch, label, shape, state, cam_t, bg,
                                          cfgs[(tw, th)][0], REDUCE_STEPS, chunk_form)
        expand_paths[label] = expand_path(torch, label, shape, state, cam, cam_t, bg,
                                          cfgs[(tw, th)][0], chunk_form)
        carry_paths[label] = carry_path(torch, label, shape, state, cam, cam_t, bg,
                                        cfgs[(tw, th)][0], chunk_form)
    mark("reduce, expand, carry")
    segment_edges = segment_reduce_edges(torch, dev)
    expand_edges = expand_intervals_edges(torch, dev)
    preprocess_edge_worst = preprocess_edges(torch, dev)
    preprocess_fwd_edge_total = preprocess_fwd_edges(torch, dev)
    p1_fit, p2_fit = preprocess_fit_size(torch, dev)
    del cam_t
    mark("edge layouts")
    # 8. the tile-sharded layout: strips, in-process steps, two ranks on the card and the
    # train CLI across two processes
    shard, tile_results, cams = sharded_phase(torch, dev, state, cam, bg, cfgs)
    mark("sharded")
    # 8b. the Gaussian-sharded layout: in-process steps, the visible budget, densify and
    # rebalance, two ranks on the card and the train CLI across two processes
    gauss = gauss_phase(torch, dev, state, cams, bg,
                        dict(results=tile_results, step_ms=shard["steps"]["step_ms"]))
    del state, tile_results, cams
    mark("gauss")
    # 9. the heavy scene through the tile-walk kernels, and B5 / B6 / carry on it
    heavy = heavy_phase(torch, dev, cam, bg)
    carry_paths[f"heavy {HEAVY_TILE[0]}x{HEAVY_TILE[1]}"] = heavy["carry"]
    mark("heavy")
    # 10. the train (with its startup autotune and viewer), render, metrics and
    # full-eval CLIs on a COLMAP dataset at full width, the viewer at 1080p
    # and a profiler trace
    cli = cli_phase(torch, dev)
    mark("cli")
    # 11. run_training on the synthetic recovery scene
    recovery = recovery_phase(torch, dev)
    mark("recovery")

    def keyed(results):
        return {f"bench {tw}x{th}": r for (tw, th), r in results.items()}

    heavy_label = f"heavy {HEAVY_TILE[0]}x{HEAVY_TILE[1]}"

    sweeps = {f"cli {k}": r["autotune"] for k, r in cli["runs"].items()}
    sweeps["recovery"] = recovery["autotune"]
    sweep_launches = {k: {n: v for n, v in r["launches"].items() if v}
                      for k, r in sweeps.items()}
    b1_paths = keyed(fwd_results)
    b1_paths[heavy_label] = dict(shape=heavy["fwd"]["shape"], launches=0,
                                 ms=heavy["fwd"]["composite_fwd_ms"],
                                 ms_runs=heavy["fwd"]["composite_fwd_ms_runs"])
    sh4_label = f"bench {TILES[0][0]}x{TILES[0][1]} SH 4"
    b1_paths[sh4_label] = dict(shape=sh4["shape"], launches=1,
                               max_abs_err=sh4["fwd_max_abs_err"],
                               equal_to_plain=sh4["fwd_equal_to_plain"])
    b2_paths = keyed(bwd_results)
    b2_paths[sh4_label] = dict(shape=sh4["shape"], launches=SH4_STEPS,
                               max_abs_err=sh4["bwd_max_abs_err"],
                               worst_share_of_tolerance=sh4["bwd_worst_share_of_tolerance"],
                               same_bits=sh4["bwd_same_bits"])
    b2_paths[heavy_label] = dict(shape=heavy["bwd"]["shape"], launches=0,
                                 ms=heavy["bwd"]["composite_bwd_ms"],
                                 ms_runs=heavy["bwd"]["composite_bwd_ms_runs"])
    main_label = f"bench {TILES[0][0]}x{TILES[0][1]}"
    cli_launches = {name: {k: r["launches"][k] for k in ("composite_fwd", "composite_bwd",
                                                          "composite_fwd_tile",
                                                          "composite_bwd_tile")}
                    for name, r in cli["runs"].items()}
    carry_reduce = {f"carry {k}": r["reduce"] for k, r in carry_paths.items()}
    carry_expand = {f"carry {k}": r["expand"] for k, r in carry_paths.items()}
    b1_paths.update(chunk_paths["composite_fwd"])
    b2_paths.update(chunk_paths["composite_bwd"])
    shard_steps = shard["steps"]["launches"]

    def shard_launches(kernel, modes=("scatter", "cuda", "carry")):
        return {k: la[kernel] for k, la in shard_steps.items() if k.split()[1] in modes}

    shard_cli = shard["cli"]["launches"]

    def gauss_launches(kernel):
        return {"steps": {k: la[kernel] for k, la in gauss["steps"]["launches"].items()},
                "cli_ranks": [la[kernel] for la in gauss["cli"]["launches"]]}

    kernels = [
        kernel_entry("composite_fwd", "gs_tpu_torch/csrc/composite_fwd.cu",
                     "gs_tpu/ops/rasterize_pallas.py:937", render_launches["composite_fwd"],
                     main_label, b1_paths,
                     {"launches_train_path": train_launches["composite_fwd"],
                      "launches_cli_phase": cli_launches,
                      "cli_render_launches": cli["render_launches"],
                      "autotune": sweeps, "launches_autotune_sweeps": sweep_launches,
                      "viewer": cli["viewer"], "metrics": cli["metrics"],
                      "profiler": cli["profiler"],
                      "launches_sharded": {
                          "render": {k: r["launches"] for k, r in shard["render"].items()},
                          "steps": shard_launches("composite_fwd"),
                          "cli_ranks": [la["composite_fwd"] for la in shard_cli]},
                      "sharded": shard, "launches_gauss": gauss_launches("composite_fwd"),
                      "gauss": gauss,
                      "launches_sh4": {"render": sh4["render_launches"]["composite_fwd"],
                                       "steps": sh4["step_launches"]["composite_fwd"]},
                      "sh4": sh4}),
        kernel_entry("composite_bwd", "gs_tpu_torch/csrc/composite_bwd.cu",
                     "gs_tpu/ops/rasterize_pallas.py:1034", train_launches["composite_bwd"],
                     main_label, b2_paths,
                     {"recovery": recovery, "launches_cli_phase": cli_launches,
                      "cli_it_per_s": {k: r["it_per_s"] for k, r in cli["runs"].items()},
                      "cli_median_step_ms": {k: r["median_step_ms"]
                                             for k, r in cli["runs"].items()},
                      "launches_sharded": {
                          "steps": shard_launches("composite_bwd"),
                          "cli_ranks": [la["composite_bwd"] for la in shard_cli]},
                      "launches_gauss": gauss_launches("composite_bwd"),
                      "launches_sh4": sh4["step_launches"]["composite_bwd"]}),
        kernel_entry("composite_fwd_tile", "gs_tpu_torch/csrc/composite_fwd_tile.cu",
                     "gs_tpu/ops/rasterize_pallas.py:645", heavy["fwd"]["launches"],
                     heavy_label, {heavy_label: heavy["fwd"], **keyed(fwd_tile_bench),
                                   **chunk_paths["composite_fwd_tile"]},
                     {"launches_train_path": heavy["fwd"]["launches_train_path"],
                      "launches_gauss": gauss_launches("composite_fwd_tile")}),
        kernel_entry("composite_bwd_tile", "gs_tpu_torch/csrc/composite_bwd_tile.cu",
                     "gs_tpu/ops/rasterize_pallas.py:777", heavy["bwd"]["launches"],
                     heavy_label, {heavy_label: heavy["bwd"], **keyed(bwd_tile_bench),
                                   **chunk_paths["composite_bwd_tile"]},
                     {"heavy_peak_gib": heavy["peak_gib"],
                      "launches_gauss": gauss_launches("composite_bwd_tile")}),
        kernel_entry("segment_reduce", "gs_tpu_torch/csrc/segment_reduce.cu",
                     "gs_tpu/ops/pairmove.py:63",
                     sum(r["launches"] for r in reduce_paths.values())
                     + sum(r["launches"] for r in carry_reduce.values()), main_label,
                     {**reduce_paths, heavy_label: heavy["reduce"], **carry_reduce},
                     {"launches_heavy_path": heavy["reduce"]["launches"],
                      "launches_carry_paths": {k: r["launches"] for k, r in carry_reduce.items()},
                      "both_switches_launches": heavy["both_switches_launches"],
                      "launches_sharded": shard_launches("segment_reduce", ("cuda", "carry")),
                      "launches_gauss": gauss_launches("segment_reduce"),
                      "edge_layouts": segment_edges},
                     library_ms=reduce_paths[main_label]["library_ms"]),
        kernel_entry("expand_intervals", "gs_tpu_torch/csrc/expand_intervals.cu",
                     "gs_tpu/ops/pairmove.py:254",
                     sum(r["launches"] for r in expand_paths.values())
                     + sum(r["launches"] for r in carry_expand.values()), main_label,
                     {**expand_paths, heavy_label: heavy["expand"], **carry_expand},
                     {"launches_heavy_path": heavy["expand"]["launches"],
                      "launches_carry_paths": {k: r["launches"] for k, r in carry_expand.items()},
                      "launches_sharded": shard_launches("expand_intervals", ("carry",)),
                      "launches_gauss": gauss_launches("expand_intervals"),
                      "edge_layouts": expand_edges},
                     library_ms=expand_paths[main_label]["library_ms"]),
        kernel_entry("preprocess_bwd", "gs_tpu_torch/csrc/preprocess_bwd.cu",
                     "none: gs_tpu leaves this VJP to XLA's autodiff",
                     train_launches["preprocess_bwd"], main_label,
                     {**keyed(p1_results), sh4_label: sh4["preprocess_bwd"],
                      heavy_label: heavy["preprocess"], "fit size": p1_fit},
                     {"launches_sh4": sh4["step_launches"]["preprocess_bwd"],
                      "launches_heavy_path": heavy["preprocess"]["launches"],
                      "launches_sharded": {
                          "steps": shard_launches("preprocess_bwd"),
                          "cli_ranks": [la["preprocess_bwd"] for la in shard_cli]},
                      "launches_gauss": gauss_launches("preprocess_bwd"),
                      "launches_cli_phase": {k: r["launches"]["preprocess_bwd"]
                                             for k, r in cli["runs"].items()},
                      "launches_recovery": recovery["launches"]["preprocess_bwd"],
                      "edge_inputs": preprocess_edge_worst},
                     library_ms=p1_results[TILES[0]]["library_ms"]),
        kernel_entry("preprocess_fwd", "gs_tpu_torch/csrc/preprocess_fwd.cu",
                     "none: gs_tpu leaves this stage to XLA, which fuses it",
                     render_launches["preprocess_fwd"], main_label,
                     {**keyed(p2_results), sh4_label: sh4["preprocess_fwd"],
                      heavy_label: heavy["preprocess_fwd"], "fit size": p2_fit},
                     {"launches_train_path": train_launches["preprocess_fwd"],
                      "launches_sh4": {"render": sh4["render_launches"]["preprocess_fwd"],
                                       "steps": sh4["step_launches"]["preprocess_fwd"]},
                      "launches_heavy_path": heavy["preprocess_fwd"]["launches"],
                      "launches_sharded": {
                          "render": {k: r["p2_launches"] for k, r in shard["render"].items()},
                          "steps": shard_launches("preprocess_fwd"),
                          "cli_ranks": [la["preprocess_fwd"] for la in shard_cli]},
                      "launches_gauss": gauss_launches("preprocess_fwd"),
                      "launches_cli_phase": {k: r["launches"]["preprocess_fwd"]
                                             for k, r in cli["runs"].items()},
                      "launches_recovery": recovery["launches"]["preprocess_fwd"],
                      "edge_inputs": preprocess_fwd_edge_total}),
    ]
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"phase_s": phase_s}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
