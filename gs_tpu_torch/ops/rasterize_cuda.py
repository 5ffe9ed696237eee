"""Tile compositing, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``gs_tpu/ops/rasterize_pallas.py`` for the chunk-grid
kernels ``_fwd_kernel`` (entered through ``composite_fwd_pallas``) and
``_bwd_kernel`` (``composite_bwd_pallas``). Arguments:

  st         tile geometry (``tiles_x``, ``tile_w``, ``tile_h``, ``chunk``,
             ``tile_batch``), e.g. ``rasterize_tiled.CompositeStatic``
  sp_attr    [B, 9] float32 packed pair attributes (mean xy | conic abc |
             rgb | opacity), each tile's pairs in depth order
  tile_ids, starts, ends   [M] int32: tile m composites pairs
             [starts[m], ends[m])

Forward (``composite_fwd_cuda`` / ``composite_fwd_torch``) returns
color [M, P, 3] f32, t_final [M, P] f32 and ncon [M, P] int32 (global
index of the last contributing pair + 1, 0 if none), P = tile_w * tile_h.

Backward (``composite_bwd_cuda`` / ``composite_bwd_torch``) also takes the
forward's ``t_final`` and ``ncon``, the cotangent ``g_color`` [M, P, 3] and
``gt_term`` [M, P] (the cotangent of t_final times t_final), with ``ends``
trimmed to each tile's last contributor (``rasterize_tiled.
ncon_trimmed_ends``), and returns d_attr [B, 9] f32, exactly 0 in rows no
range covers.

The ``*_cuda`` wrappers launch the hand-written Hopper kernels in
``gs_tpu_torch/csrc/composite_{fwd,bwd}.cu`` (their headers explain the
designs). Both are bound by the fp32 / expf rate of the pair x pixel
evaluations, not by memory: each 36-byte pair feeds P >= 256 evaluations.
On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches the kernel or raises, never falling back.

The ``*_torch`` functions are the plain PyTorch versions (the kernels'
references, and the CPU path). They batch ``st.tile_batch`` tiles, evaluate
each chunk's [tiles, S, P] alpha block at once, and carry transmittance
(and, backward, the suffix sum) pair by pair in the order the kernels do,
so both take the same skip / stop / contribution decisions. They are bound
by kernel-launch overhead on the card (~10 small launches per pair
position) and are no yardstick of speed.

Each kernel library is compiled with ``nvcc`` the first time it is needed,
from its source in ``gs_tpu_torch/csrc`` only, into ``build/`` at the
repository root, keyed by a hash of that source and the flags; ``build()``
runs one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from gs_tpu_torch.ops.rasterize_oracle import ALPHA_MAX, ALPHA_SKIP, T_EPS

ATTR_W = 9

# launches of each kernel by its wrapper (reset and read by chip_smoke.py)
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0}

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = {name: _CSRC / f"{name}.cu" for name in LAUNCHES}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# per kernel: library path, nvcc seconds (when built in this process), ptxas report
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(names=tuple(SOURCES)) -> dict[str, Path]:
    """Compile each named kernel library whose source has not been built,
    one nvcc process per source, all started together; returns the paths.
    ``BUILD_INFO[name]`` gets the build time and nvcc's ptxas report."""
    procs = {}
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]}:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)  # atomic: a concurrent builder never sees half a file
        BUILD_INFO.setdefault(name, {})["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    paths = {}
    for name in names:
        so = _library_path(name)
        log = so.with_suffix(".log")
        info = BUILD_INFO.setdefault(name, {})
        info["path"] = str(so)
        info["ptxas"] = log.read_text() if log.exists() else ""
        paths[name] = so
    return paths


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build((name,))[name]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        if name == "composite_fwd":
            lib.gs_composite_fwd.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
            lib.gs_composite_fwd.restype = i32
        else:
            lib.gs_composite_bwd.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
            lib.gs_composite_bwd.restype = i32
        max_pixels = getattr(lib, f"gs_{name}_max_pixels")
        max_pixels.argtypes = []
        max_pixels.restype = i32
        _libs[name] = lib
    return _libs[name]


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


def _kernel_lib(name: str, st, sp_attr) -> ctypes.CDLL | None:
    """The kernel's library for CUDA tensors, None for CPU tensors (whose
    caller runs the plain version); raises for any other device or a tile
    the kernel does not take."""
    if sp_attr.device.type == "cpu":
        return None
    if sp_attr.device.type != "cuda":
        raise ValueError(f"{name}_cuda takes CUDA or CPU tensors, got {sp_attr.device}")
    lib = _load(name)
    p = st.tile_w * st.tile_h
    limit = getattr(lib, f"gs_{name}_max_pixels")()
    if p > limit:
        raise ValueError(f"tile of {p} pixels exceeds {name}'s {limit}")
    return lib


def composite_fwd_cuda(st, sp_attr, tile_ids, starts, ends):
    """Composite tiles with the CUDA kernel (plain version for CPU tensors)."""
    _check_inputs(st, sp_attr, tile_ids, starts, ends)
    lib = _kernel_lib("composite_fwd", st, sp_attr)
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
        err = lib.gs_composite_fwd(
            sp_attr.data_ptr(), tile_ids.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            color.data_ptr(), t_final.data_ptr(), ncon.data_ptr(),
            m, st.tiles_x, st.tile_w, st.tile_h, st.chunk, stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error {err}")
    if m:
        LAUNCHES["composite_fwd"] += 1
    return color, t_final, ncon


def composite_bwd_cuda(st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term):
    """Pair gradients d_attr [B, 9] with the CUDA kernel (plain version for
    CPU tensors). ``ends`` must be trimmed to each tile's last contributor."""
    args = (st, sp_attr, tile_ids, starts, ends, t_final, ncon, g_color, gt_term)
    _check_bwd_inputs(*args)
    lib = _kernel_lib("composite_bwd", st, sp_attr)
    if lib is None:
        return composite_bwd_torch(*args)
    m, b = tile_ids.shape[0], sp_attr.shape[0]
    dev = sp_attr.device
    tensors = [t.contiguous() for t in args[1:]]
    d_attr = torch.empty((b, ATTR_W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gs_composite_bwd(*(t.data_ptr() for t in tensors), d_attr.data_ptr(),
                                   b, m, st.tiles_x, st.tile_w, st.tile_h, st.chunk, stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: CUDA error {err}")
    if m:
        LAUNCHES["composite_bwd"] += 1
    return d_attr


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
