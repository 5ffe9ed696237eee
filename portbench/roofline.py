"""The yardstick of every roofline and ``mfu`` share: peaks of one H100 and
the operations a step or a frame needs, counted from its inputs alone.

The compositing count is a frozen copy of the bring-up smoke test's
(``needed_work``, ``needed_work_bwd``, ``fwd_bound``, ``bwd_bound``): the
pair x pixel evaluations these inputs need at least, whichever kernel form
(chunk-grid B1 / B2 or tile-walk B3 / B4) ran them, so a later change of
form reads against the same bound. One change from that copy: the null
rows that pad each tile's range to the form's alignment (zero opacity;
a live splat's opacity is above 1/255, or binning drops it) are neither
needed work nor needed bytes, so the count is the same for both forms.
The per-Gaussian and per-pixel terms of a whole step are closed-form
counts of the published algorithm.
"""

from __future__ import annotations

import torch

# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, and HBM3 bandwidth; special-function results (the exp2
# inside expf): 16 per SM per clock x 132 SMs x the 1.98 GHz boost clock
# the fp32 peak assumes
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 16 * 132 * 1.98e9
# fp32 operations of the compositing forward per pair x pixel evaluation, by
# how far the evaluation gets: every one computes dx, dy (2) and power (9)
# and tests the cull (1); past the cull, expf (counted as 1), * opac, min
# and the skip test (4); past the skip, 1 - alpha, * T and the stop test
# (3); a contribution then w = alpha * T and 3 mul + 3 add of color (7)
OPS_EVAL, OPS_PAST_CULL, OPS_PAST_SKIP, OPS_CONTRIB = 12, 4, 3, 7
# the backward per evaluation: the same 12 up to the cull and 4 past it; a
# contribution then costs 1 - alpha, the division of T, w (3), b = rgb .
# g_color (5), d_alpha (4), the suffix sum (2), d_power (1) and the nine
# accumulated gradients (32): 47
BWD_OPS_EVAL, BWD_OPS_PAST_CULL, BWD_OPS_CONTRIB = 12, 4, 47
# fp32 operations a Gaussian, forward: covariance from scale and quaternion
# (normalize 11, rotation 30, R S S^T R^T 60), projection (camera and clip
# transforms 42, pixel 8, Jacobian 12, J W 30, the 2D covariance 36, conic
# and radius 20), SH degree 3 colour (direction 10, basis 40, 16 x 3
# multiply-adds 96, + 0.5 and clamp 6), activations 4: 405. The backward
# of each is counted at twice its forward.
GAUSS_FWD_OPS = 405
GAUSS_BWD_OPS = 2 * GAUSS_FWD_OPS
# Adam, per parameter (59 a Gaussian at SH degree 3): both moments (6), the
# bias corrections' division and square root (4), the update (2)
ADAM_OPS_PER_PARAM = 12
PARAMS_PER_GAUSSIAN = 3 + 3 + 45 + 1 + 3 + 4
# the loss per pixel and channel, forward: L1 (3); SSIM's five blurred
# maps, each 11 + 11 taps of a multiply-add (5 x 44 = 220), the squares and
# product (3) and the map (16): 242; its backward at twice that
LOSS_FWD_OPS_PER_VALUE = 242
LOSS_BWD_OPS_PER_VALUE = 2 * LOSS_FWD_OPS_PER_VALUE


def needed_work(st, sp_attr, tile_ids, starts, ends, ncon) -> dict:
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
    counts = torch.zeros(5, dtype=torch.int64, device=dev)
    batch = max(1, (1 << 16) // p)  # tiles at a time: [batch, S, P] temporaries
    for b0 in range(0, tile_ids.shape[0], batch):
        sl = slice(b0, b0 + batch)
        tid = tile_ids[sl].long()[:, None, None]
        px = ((tid % st.tiles_x) * st.tile_w + pix % st.tile_w).float()  # [tb, 1, P]
        py = ((tid // st.tiles_x) * st.tile_h + pix // st.tile_w).float()
        start, end = starts[sl].long(), ends[sl].long()
        last = ncon[sl].long()[:, None, :]
        stopped = torch.zeros_like(last, dtype=torch.bool)
        n_chunks = int(((end - start + s - 1) // s).max()) if end.numel() else 0
        for k in range(n_chunks):
            pos = start[:, None] + k * s + lane  # [tb, S]
            a = sp_attr[pos.clamp(max=b - 1)][..., None]  # [tb, S, 9, 1]
            dx, dy = a[:, :, 0] - px, a[:, :, 1] - py
            power = -0.5 * (a[:, :, 2] * dx * dx + a[:, :, 4] * dy * dy) - a[:, :, 3] * dx * dy
            alpha = torch.clamp(a[:, :, 8] * torch.exp(power), max=0.99)
            past_cull = power <= 0.0
            past_skip = past_cull & (alpha >= 1.0 / 255.0)
            real = (pos < end[:, None]) & (a[:, :, 8, 0] > 0.0)  # [tb, S]
            pos = pos[..., None]
            in_range = real[..., None]
            stop = past_skip & in_range & (pos >= last)
            stop_i = stop.int()
            need = in_range & ~stopped & (torch.cumsum(stop_i, 1) - stop_i == 0)
            counts += torch.stack([need.sum(), (need & past_cull).sum(),
                                   (need & past_skip).sum(), (need & past_skip & (pos < last)).sum(),
                                   real.sum()])
            stopped |= stop.any(1, keepdim=True)
    evals, past_cull, past_skip, contrib, pairs = (int(c) for c in counts.cpu())
    return dict(evals=evals, past_cull=past_cull, past_skip=past_skip, contributions=contrib,
                pairs=pairs,
                fp32_ops=OPS_EVAL * evals + OPS_PAST_CULL * past_cull
                + OPS_PAST_SKIP * past_skip + OPS_CONTRIB * contrib)


def needed_work_bwd(st, sp_attr, tile_ids, starts, ends, ncon) -> dict:
    """The pair x pixel evaluations the backward needs, and how far each
    gets (see BWD_OPS_*): each pixel needs the pairs of its tile's range
    below its own ncon; of those, the ones past the cull and the skip are
    exactly its contributors."""
    s, p, b = st.chunk, st.tile_w * st.tile_h, sp_attr.shape[0]
    dev = sp_attr.device
    lane = torch.arange(s, device=dev)
    pix = torch.arange(p, device=dev)
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
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
            real = (pos < end[:, None]) & (a[:, :, 8, 0] > 0.0)  # [tb, S]
            pos = pos[..., None]
            need = real[..., None] & (pos < last)
            past_cull = need & (power <= 0.0)
            contrib = past_cull & (alpha >= 1.0 / 255.0)
            counts += torch.stack([need.sum(), past_cull.sum(), contrib.sum(), real.sum()])
    evals, past_cull, contrib, pairs = (int(c) for c in counts.cpu())
    return dict(evals=evals, past_cull=past_cull, contributions=contrib, pairs=pairs,
                fp32_ops=BWD_OPS_EVAL * evals + BWD_OPS_PAST_CULL * past_cull
                + BWD_OPS_CONTRIB * contrib)


def _bound(work, bytes_moved) -> dict:
    fp32_ms = work["fp32_ops"] / PEAK_FP32_OPS * 1e3
    sfu_ms = work["past_cull"] / PEAK_SFU * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    ops_ms = max(fp32_ms, sfu_ms)
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes", fp32_ms=fp32_ms,
                sfu_ms=sfu_ms, bytes_ms=bytes_ms, bytes=bytes_moved, **work)


def fwd_bound(st, sp_attr, tile_ids, starts, ends, ncon) -> dict:
    """The least time of the forward on these inputs: the larger of its
    needed fp32 operations (or expf results) at the card's peak and its
    bytes (the pairs of the ranges read once, 12 B per tile, color, T and
    ncon written) at the memory rate. The same count holds B1 and B3."""
    work = needed_work(st, sp_attr, tile_ids, starts, ends, ncon)
    bytes_moved = work["pairs"] * 36 + 3 * 4 * tile_ids.numel() + ncon.numel() * (3 * 4 + 4 + 4)
    return _bound(work, bytes_moved)


def bwd_bound(st, sp_attr, tile_ids, starts, ends, t_final, ncon) -> dict:
    """The least time of the backward on these inputs (B2 and B4): sp_attr
    over the trimmed ranges read, all of d_attr written, the per-pixel
    t_final, ncon, g_color and gt_term read, 12 B per tile."""
    work = needed_work_bwd(st, sp_attr, tile_ids, starts, ends, ncon)
    bytes_moved = (work["pairs"] * 36 + sp_attr.shape[0] * 36 + t_final.numel() * (4 + 4 + 12 + 4)
                   + 3 * 4 * tile_ids.numel())
    return _bound(work, bytes_moved)


def step_ops(fwd_ops: int, bwd_ops: int, gaussians: int, pixels: int) -> int:
    """fp32 operations a training step needs: the compositing forward and
    backward counted from their inputs, and the closed-form terms."""
    per_gauss = GAUSS_FWD_OPS + GAUSS_BWD_OPS + ADAM_OPS_PER_PARAM * PARAMS_PER_GAUSSIAN
    per_value = LOSS_FWD_OPS_PER_VALUE + LOSS_BWD_OPS_PER_VALUE
    return fwd_ops + bwd_ops + gaussians * per_gauss + 3 * pixels * per_value


def frame_ops(fwd_ops: int, gaussians: int) -> int:
    """fp32 operations a rendered frame needs."""
    return fwd_ops + gaussians * GAUSS_FWD_OPS
