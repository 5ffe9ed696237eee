"""Tile compositing, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``gs_tpu/ops/rasterize_pallas.py``'s four compositing
kernels, in its two forms:

- the chunk-grid kernels ``_fwd_kernel`` (B1, entered through
  ``composite_fwd_pallas``) and ``_bwd_kernel`` (B2,
  ``composite_bwd_pallas``): wrappers ``composite_fwd_cuda`` /
  ``composite_bwd_cuda``;
- the tile-walk kernels ``_fwd_tile_kernel`` (B3) and ``_bwd_tile_kernel``
  (B4), which gs_tpu runs when the pair buffer is large: wrappers
  ``composite_fwd_tile_cuda`` / ``composite_bwd_tile_cuda``.

Both forms compute the same function, so, as gs_tpu's one XLA path
(``_composite_fwd_xla`` / ``_composite_bwd_xla``) serves both of its Pallas
modes, one plain version per direction (``composite_fwd_torch`` /
``composite_bwd_torch``) is the reference of both kernels.
``rasterize_tiled.pick_kernel_mode`` decides which form a call takes.
Arguments:

  st         tile geometry (``tiles_x``, ``tile_w``, ``tile_h``, ``chunk``,
             ``tile_batch``), e.g. ``rasterize_tiled.CompositeStatic``
  sp_attr    [B, 9] float32 packed pair attributes (mean xy | conic abc |
             rgb | opacity), each tile's pairs in depth order
  tile_ids, starts, ends   [M] int32: tile m composites pairs
             [starts[m], ends[m])

Forward returns color [M, P, 3] f32, t_final [M, P] f32 and ncon [M, P]
int32 (global index of the last contributing pair + 1, 0 if none),
P = tile_w * tile_h.

Backward also takes the forward's ``t_final`` and ``ncon``, the cotangent
``g_color`` [M, P, 3] and ``gt_term`` [M, P] (the cotangent of t_final
times t_final), with ``ends`` trimmed to each tile's last contributor
(``rasterize_tiled.ncon_trimmed_ends``), and returns d_attr [B, 9] f32,
exactly 0 in rows no range covers.

The ``*_cuda`` wrappers launch the hand-written Hopper kernels in
``gs_tpu_torch/csrc/composite_{fwd,bwd}{,_tile}.cu`` (their headers explain
the designs). All four are bound by the fp32 / expf rate of the pair x
pixel evaluations, not by memory: each 36-byte pair feeds P >= 256
evaluations. On CPU tensors a wrapper runs its plain version; on CUDA
tensors it launches the kernel or raises, never falling back.

The ``*_torch`` functions are the plain PyTorch versions (the kernels'
references, and the CPU path). They batch ``st.tile_batch`` tiles, evaluate
each chunk's [tiles, S, P] alpha block at once, and carry transmittance
(and, backward, the suffix sum) pair by pair in the order the kernels do,
so both take the same skip / stop / contribution decisions. They are bound
by kernel-launch overhead on the card (~10 small launches per pair
position) and are no yardstick of speed.

The kernels are built, loaded and counted by ``ops/cuda_build.py``
(``LAUNCHES`` is its shared count).
"""

from __future__ import annotations

import torch

from gs_tpu_torch.ops import cuda_build
from gs_tpu_torch.ops.cuda_build import LAUNCHES
from gs_tpu_torch.ops.rasterize_oracle import ALPHA_MAX, ALPHA_SKIP, T_EPS

ATTR_W = 9


def _check_inputs(st, sp_attr, tile_ids, starts, ends) -> None:
    if sp_attr.dtype != torch.float32 or sp_attr.dim() != 2 or sp_attr.shape[1] != ATTR_W:
        raise ValueError(f"sp_attr must be float32 [B, {ATTR_W}], got "
                         f"{sp_attr.dtype} {tuple(sp_attr.shape)}")
    m = tile_ids.shape[0]
    for name, t in (("tile_ids", tile_ids), ("starts", starts), ("ends", ends)):
        if t.dtype != torch.int32 or t.shape != (m,):
            raise ValueError(f"{name} must be int32 [{m}], got {t.dtype} {tuple(t.shape)}")
        if t.device != sp_attr.device:
            raise ValueError(f"{name} is on {t.device}, sp_attr on {sp_attr.device}")


def _check_bwd_inputs(st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color,
                      gt_term) -> None:
    _check_inputs(st, sp_attr, tile_ids, starts, ends)
    m, p = tile_ids.shape[0], st.tile_w * st.tile_h
    for name, t, dtype, shape in (("t_final", t_final, torch.float32, (m, p)),
                                  ("ncon", ncon, torch.int32, (m, p)),
                                  ("g_color", g_color, torch.float32, (m, p, 3)),
                                  ("gt_term", gt_term, torch.float32, (m, p))):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != sp_attr.device:
            raise ValueError(f"{name} is on {t.device}, sp_attr on {sp_attr.device}")


def _kernel_lib(name: str, st, sp_attr):
    """The kernel's library for CUDA tensors, None for CPU tensors (whose
    caller runs the plain version); raises for any other device or a tile
    the kernel does not take."""
    if sp_attr.device.type == "cpu":
        return None
    if sp_attr.device.type != "cuda":
        raise ValueError(f"{name}_cuda takes CUDA or CPU tensors, got {sp_attr.device}")
    lib = cuda_build.load(name)
    p = st.tile_w * st.tile_h
    limit = getattr(lib, f"gs_{name}_max_pixels")()
    if p > limit:
        raise ValueError(f"tile of {p} pixels exceeds {name}'s {limit}")
    return lib


def _launch_fwd(name, st, sp_attr, tile_ids, starts, ends):
    """Forward through kernel ``name`` (plain version for CPU tensors)."""
    _check_inputs(st, sp_attr, tile_ids, starts, ends)
    lib = _kernel_lib(name, st, sp_attr)
    if lib is None:
        return composite_fwd_torch(st, sp_attr, tile_ids, starts, ends)
    p = st.tile_w * st.tile_h
    m = tile_ids.shape[0]
    dev = sp_attr.device
    sp_attr, tile_ids, starts, ends = (t.contiguous() for t in (sp_attr, tile_ids, starts, ends))
    color = torch.empty((m, p, 3), dtype=torch.float32, device=dev)
    t_final = torch.empty((m, p), dtype=torch.float32, device=dev)
    ncon = torch.empty((m, p), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"gs_{name}")(
            sp_attr.data_ptr(), tile_ids.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            color.data_ptr(), t_final.data_ptr(), ncon.data_ptr(),
            m, st.tiles_x, st.tile_w, st.tile_h, st.chunk, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if m:
        LAUNCHES[name] += 1
    return color, t_final, ncon


def _launch_bwd(name, st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term):
    """Backward through kernel ``name`` (plain version for CPU tensors)."""
    args = (st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term)
    _check_bwd_inputs(*args)
    lib = _kernel_lib(name, st, sp_attr)
    if lib is None:
        return composite_bwd_torch(*args)
    m, b = tile_ids.shape[0], sp_attr.shape[0]
    dev = sp_attr.device
    tensors = [t.contiguous() for t in args[1:]]
    d_attr = torch.empty((b, ATTR_W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"gs_{name}")(*(t.data_ptr() for t in tensors), d_attr.data_ptr(),
                                         b, m, st.tiles_x, st.tile_w, st.tile_h, st.chunk,
                                         stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if m:
        LAUNCHES[name] += 1
    return d_attr


def composite_fwd_cuda(st, sp_attr, tile_ids, starts, ends):
    """Composite tiles with B1, the chunk-grid form's kernel (plain version
    for CPU tensors)."""
    return _launch_fwd("composite_fwd", st, sp_attr, tile_ids, starts, ends)


def composite_fwd_tile_cuda(st, sp_attr, tile_ids, starts, ends):
    """Composite tiles with B3, the tile-walk form's kernel (plain version
    for CPU tensors)."""
    return _launch_fwd("composite_fwd_tile", st, sp_attr, tile_ids, starts, ends)


def composite_bwd_cuda(st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term):
    """Pair gradients d_attr [B, 9] with B2 (plain version for CPU tensors).
    ``ends`` must be trimmed to each tile's last contributor."""
    return _launch_bwd("composite_bwd", st, sp_attr, tile_ids, starts, ends, t_final, ncon,
                       g_color, gt_term)


def composite_bwd_tile_cuda(st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color,
                            gt_term):
    """Pair gradients d_attr [B, 9] with B4 (plain version for CPU tensors).
    ``ends`` must be trimmed to each tile's last contributor."""
    return _launch_bwd("composite_bwd_tile", st, sp_attr, tile_ids, starts, ends, t_final,
                       ncon, g_color, gt_term)


def _tile_pixel_coords(tile_ids: torch.Tensor, st) -> tuple[torch.Tensor, torch.Tensor]:
    """Global pixel coordinates [M, P] (float32) of each tile's pixels."""
    p = torch.arange(st.tile_w * st.tile_h, device=tile_ids.device)
    tid = tile_ids.to(torch.int64)[:, None]
    px = ((tid % st.tiles_x) * st.tile_w + p % st.tile_w).to(torch.float32)
    py = ((tid // st.tiles_x) * st.tile_h + p // st.tile_w).to(torch.float32)
    return px, py


def _chunk_alpha(attr, px, py):
    """dx, dy, power, exp(power), opac * exp(power) and alpha of a [tb, S]
    chunk of pairs against [tb, 1, P] pixels, in the kernels' order."""
    dx = attr[..., 0:1] - px  # [tb, S, P]
    dy = attr[..., 1:2] - py
    power = (-0.5 * (attr[..., 2:3] * dx * dx + attr[..., 4:5] * dy * dy)
             - attr[..., 3:4] * dx * dy)
    g_exp = torch.exp(power)
    au = attr[..., 8:9] * g_exp
    return dx, dy, power, g_exp, au, torch.clamp(au, max=ALPHA_MAX)


def composite_fwd_torch(st, sp_attr, tile_ids, starts, ends):
    """Plain PyTorch tile compositing (the kernel's reference; see module doc).

    Semantics of gs_tpu's ``_forward_one_tile`` / ``_composite_fwd_xla``:
    per pixel, a pair is skipped if power > 0 or alpha < 1/255; the first
    pair with T * (1 - alpha) < 1e-4 kills the pixel, which keeps T from
    before that pair; otherwise color += alpha * T * rgb, T *= 1 - alpha and
    ncon = pair index + 1. A tile whose pixels have all died stops.
    """
    _check_inputs(st, sp_attr, tile_ids, starts, ends)
    s = st.chunk
    p = st.tile_w * st.tile_h
    m = tile_ids.shape[0]
    dev = sp_attr.device
    b = sp_attr.shape[0]
    color = torch.zeros((m, p, 3), dtype=torch.float32, device=dev)
    t_final = torch.ones((m, p), dtype=torch.float32, device=dev)
    ncon = torch.zeros((m, p), dtype=torch.int32, device=dev)
    lane = torch.arange(s, device=dev)
    for b0 in range(0, m, st.tile_batch):
        sl = slice(b0, min(b0 + st.tile_batch, m))
        start = starts[sl].to(torch.int64)
        end = ends[sl].to(torch.int64)
        n_chunks = int(((end - start + s - 1) // s).max()) if end.numel() else 0
        px, py = _tile_pixel_coords(tile_ids[sl], st)  # [tb, P]
        px, py = px[:, None, :], py[:, None, :]
        col, t, nc = color[sl], t_final[sl], ncon[sl]  # views: updated in place
        died = torch.zeros_like(t, dtype=torch.bool)
        for k in range(n_chunks):
            pos = start[:, None] + k * s + lane  # [tb, S]
            attr = sp_attr[pos.clamp(max=b - 1)]  # [tb, S, 9]
            _, _, power, _, _, alpha = _chunk_alpha(attr, px, py)
            incl = (pos < end[:, None])[..., None] & (alpha >= ALPHA_SKIP) & (power <= 0.0)
            omb = 1.0 - alpha
            rgb = attr[..., 5:8]  # [tb, S, 3]
            for j in range(s):
                live = incl[:, j] & ~died
                t_next = t * omb[:, j]
                stop = live & (t_next < T_EPS)
                contrib = live & ~stop
                w = torch.where(contrib, alpha[:, j] * t, 0.0)
                col += w[..., None] * rgb[:, j, None, :]
                t.copy_(torch.where(contrib, t_next, t))
                nc.copy_(torch.where(contrib, (pos[:, j, None] + 1).to(torch.int32), nc))
                died |= stop
            if bool(died.all()):  # every pixel of the batch has died
                break
    return color, t_final, ncon


def composite_bwd_torch(st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term):
    """Plain PyTorch compositing backward (the kernel's reference).

    Semantics of gs_tpu's ``_backward_chunk`` / ``_composite_bwd_xla``: each
    tile's chunks are walked from the (trimmed) end back to ``start``; a
    pair counts at a pixel where power <= 0, alpha >= 1/255 and its position
    is below the pixel's ncon. Pair by pair, back to front, as the kernel
    does: T /= 1 - alpha (T before the pair), w = alpha * T,
    b = rgb . g_color, d_alpha = T * b - (S + gt_term) / (1 - alpha), then
    S += w * b. The chains to conic, mean, rgb and opacity are summed over
    the tile's pixels per chunk.
    """
    _check_bwd_inputs(st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term)
    s = st.chunk
    m = tile_ids.shape[0]
    dev = sp_attr.device
    b = sp_attr.shape[0]
    d_attr = torch.zeros((b, ATTR_W), dtype=torch.float32, device=dev)
    lane = torch.arange(s, device=dev)
    for b0 in range(0, m, st.tile_batch):
        sl = slice(b0, min(b0 + st.tile_batch, m))
        start = starts[sl].to(torch.int64)
        end = ends[sl].to(torch.int64)
        tile_chunks = (end - start + s - 1) // s  # [tb]
        n_chunks = int(tile_chunks.max()) if end.numel() else 0
        px, py = _tile_pixel_coords(tile_ids[sl], st)  # [tb, P]
        px, py = px[:, None, :], py[:, None, :]
        t = t_final[sl].clone()  # T after the pairs still to be walked
        ssum = torch.zeros_like(t)  # suffix sum of w * b
        gc, gt = g_color[sl], gt_term[sl]  # [tb, P, 3], [tb, P]
        last = ncon[sl].to(torch.int64)[:, None, :]  # [tb, 1, P]
        for k in range(n_chunks - 1, -1, -1):  # chunk k of each tile, last first
            pos = start[:, None] + k * s + lane  # [tb, S]
            in_range = (k < tile_chunks)[:, None] & (pos < end[:, None])
            attr = sp_attr[pos.clamp(max=b - 1)]  # [tb, S, 9]
            dx, dy, power, g_exp, au, alpha = _chunk_alpha(attr, px, py)
            contrib = (in_range[..., None] & (alpha >= ALPHA_SKIP) & (power <= 0.0)
                       & (pos[..., None] < last))
            omb = 1.0 - alpha
            rgb = attr[..., 5:8, None]  # [tb, S, 3, 1]
            gcs = gc[:, None].transpose(-1, -2)  # [tb, 1, 3, P]
            bdot = rgb[..., 0, :] * gcs[..., 0, :] + rgb[..., 1, :] * gcs[..., 1, :] \
                + rgb[..., 2, :] * gcs[..., 2, :]  # [tb, S, P]
            w = torch.zeros_like(alpha)
            d_alpha = torch.zeros_like(alpha)
            for j in range(s - 1, -1, -1):
                cj, omb_j, b_j = contrib[:, j], omb[:, j], bdot[:, j]
                t = torch.where(cj, t / omb_j, t)  # T before pair j
                w_j = torch.where(cj, alpha[:, j] * t, 0.0)
                d_alpha[:, j] = torch.where(cj, t * b_j - (ssum + gt) / omb_j, 0.0)
                ssum = torch.where(cj, ssum + w_j * b_j, ssum)
                w[:, j] = w_j
            d_power = au * d_alpha
            ca, cb, cc = attr[..., 2:3], attr[..., 3:4], attr[..., 4:5]
            grads = torch.stack([
                (-(ca * dx + cb * dy) * d_power).sum(-1),
                (-(cc * dy + cb * dx) * d_power).sum(-1),
                (-0.5 * dx * dx * d_power).sum(-1),
                (-dx * dy * d_power).sum(-1),
                (-0.5 * dy * dy * d_power).sum(-1),
                (w * gcs[..., 0, :]).sum(-1),
                (w * gcs[..., 1, :]).sum(-1),
                (w * gcs[..., 2, :]).sum(-1),
                (g_exp * d_alpha).sum(-1),
            ], dim=-1)  # [tb, S, 9]
            d_attr[pos[in_range]] = grads[in_range]
    return d_attr
