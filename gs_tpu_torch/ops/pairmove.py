"""Pair movement: the segment reduce (B5) and the interval expand (B6).

Counterpart of ``gs_tpu/ops/pairmove.py``'s two kernels:

- ``_segred_kernel`` (B5, entered through ``segment_reduce_packed`` /
  ``segment_reduce_sorted``): the per-Gaussian sum of Gaussian-sorted
  pair-gradient rows, the reference backward's atomicAdd accumulation done
  without a scatter. Wrapper ``segment_reduce_sorted``, kernel
  ``csrc/segment_reduce.cu``, plain version ``segment_reduce_torch``.
- ``_expand_kernel`` (B6, ``expand_intervals``): each slot of an output
  range takes the values of the interval that owns it, binning's per-slot
  owner fields. Wrapper ``expand_intervals``, kernel
  ``csrc/expand_intervals.cu``, plain version ``expand_intervals_torch``.

The port is row-major with int32 indices. gs_tpu's ``pack_sorted_columns``
and ``pack_interval_columns``, and the [16, B] f32 layout they build with
the ids as exact-integer floats, exist to give the TPU lane-dense DMA and
matrix-unit operands; they are TPU layout and are not ported. So the
kernels take rows [B, K] and int32 bounds directly, and index in int32:
any B, N or total below 2^31 (gs_tpu's f32 ids stop at 2^24). The
wrappers raise past that.

On CPU tensors a wrapper runs its plain version; on CUDA tensors it
launches its kernel (``cuda_build.LAUNCHES`` counts it) or raises.
"""

from __future__ import annotations

import torch

from gs_tpu_torch.ops import cuda_build

INDEX_LIMIT = 1 << 31  # the kernels index rows, Gaussians and slots in int32
MAX_COLUMNS = 16  # the kernels are instantiated for 1..16 value columns


def _check_limit(what: str, size: int) -> None:
    if size >= INDEX_LIMIT:
        raise ValueError(f"{what} = {size} does not fit the kernels' int32 indices "
                         f"(limit 2^31)")


def _device_kind(fn: str, *tensors) -> str:
    """'cpu' or 'cuda' for tensors all on one such device, else raise."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{fn}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} takes CUDA or CPU tensors, got {dev}")
    return dev.type


# --- B5: segment reduce ---------------------------------------------------------------------


def _check_segment_inputs(rows, seg_cum, n) -> None:
    if rows.dtype != torch.float32 or rows.dim() != 2 or not 1 <= rows.shape[1] <= MAX_COLUMNS:
        raise ValueError(f"rows must be float32 [B, K<={MAX_COLUMNS}], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if seg_cum.dtype != torch.int32 or seg_cum.shape != (n,):
        raise ValueError(f"seg_cum must be int32 [{n}], got {seg_cum.dtype} "
                         f"{tuple(seg_cum.shape)}")
    _check_limit("rows", rows.shape[0])
    _check_limit("n", n)


def segment_reduce_torch(rows: torch.Tensor, seg_cum: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of B5: a float64 ``index_add_`` of the sorted rows by
    their segment's id, rounded once to float32. Rows past seg_cum[n-1]
    belong to no segment and are dropped."""
    _check_segment_inputs(rows, seg_cum, n)
    counts = torch.diff(seg_cum.to(torch.int64), prepend=seg_cum.new_zeros(1, dtype=torch.int64))
    ids = torch.repeat_interleave(torch.arange(n, device=rows.device), counts)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float64, device=rows.device)
    out.index_add_(0, ids, rows[:ids.numel()].to(torch.float64))
    return out.to(torch.float32)


def segment_reduce_sorted(rows: torch.Tensor, seg_cum: torch.Tensor, n: int) -> torch.Tensor:
    """[n, K] per-Gaussian sums of Gaussian-sorted rows [B, K]:
    out[g] = rows[seg_cum[g-1] : seg_cum[g]].sum(0) (seg_cum[-1] = 0), 0 for
    an empty segment. ``seg_cum`` [n] int32 is the inclusive cumulative
    row count, at most B; rows past seg_cum[n-1] are never read. B5 on CUDA
    tensors, the plain version on CPU tensors."""
    if _device_kind("segment_reduce_sorted", rows, seg_cum) == "cpu":
        return segment_reduce_torch(rows, seg_cum, n)
    _check_segment_inputs(rows, seg_cum, n)
    rows, seg_cum = rows.contiguous(), seg_cum.contiguous()
    out = torch.empty((n, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if n:
        with torch.cuda.device(rows.device):
            stream = torch.cuda.current_stream(rows.device).cuda_stream
            cuda_build.launch("segment_reduce", rows.data_ptr(), seg_cum.data_ptr(),
                              out.data_ptr(), rows.shape[0], n, rows.shape[1], stream)
    return out


# --- B6: interval expand --------------------------------------------------------------------


def _check_expand_inputs(offsets, ends, cols, total) -> None:
    n = offsets.shape[0]
    for name, t in (("offsets", offsets), ("ends", ends)):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got {t.dtype} {tuple(t.shape)}")
    if (cols.dtype not in (torch.int32, torch.float32) or cols.dim() != 2
            or cols.shape[1] != n or not 1 <= cols.shape[0] <= MAX_COLUMNS):
        raise ValueError(f"cols must be int32 or float32 [K<={MAX_COLUMNS}, {n}], got "
                         f"{cols.dtype} {tuple(cols.shape)}")
    _check_limit("n", n)
    _check_limit("total", total)


def expand_intervals_torch(offsets, ends, cols, total: int) -> torch.Tensor:
    """Plain version of B6: ``searchsorted`` for each slot's last interval
    starting at or before it, then a gather and a mask, both on the
    columns' 32-bit words (float columns keep NaN payloads, -0.0 and
    denormals bit for bit, as the kernel does)."""
    _check_expand_inputs(offsets, ends, cols, total)
    if offsets.numel() == 0:
        return cols.new_zeros((cols.shape[0], total))
    words = cols.view(torch.int32)
    slot = torch.arange(total, dtype=torch.int32, device=cols.device)
    owner = torch.searchsorted(offsets, slot, right=True) - 1
    safe = owner.clamp(min=0)
    owned = (owner >= 0) & (slot < ends[safe])
    return torch.where(owned, words[:, safe], 0).view(cols.dtype)


def expand_intervals(offsets: torch.Tensor, ends: torch.Tensor, cols: torch.Tensor,
                     total: int) -> torch.Tensor:
    """[K, total]: out[:, p] = cols[:, n] for the unique n with
    offsets[n] <= p < ends[n], 0 where no interval owns p. ``offsets`` and
    ``ends`` [N] int32 are non-decreasing and disjoint (ends[n] <=
    offsets[n+1]); ``cols`` [K, N] is int32 or float32, and the result
    has its type and bits. B6 on CUDA tensors, the plain version on CPU
    tensors."""
    if _device_kind("expand_intervals", offsets, ends, cols) == "cpu":
        return expand_intervals_torch(offsets, ends, cols, total)
    _check_expand_inputs(offsets, ends, cols, total)
    offsets, ends = offsets.contiguous(), ends.contiguous()
    words = cols.contiguous().view(torch.int32)
    out = torch.empty((cols.shape[0], total), dtype=torch.int32, device=cols.device)
    if total:
        with torch.cuda.device(cols.device):
            stream = torch.cuda.current_stream(cols.device).cuda_stream
            cuda_build.launch("expand_intervals", offsets.data_ptr(), ends.data_ptr(),
                              words.data_ptr(), out.data_ptr(), offsets.shape[0],
                              cols.shape[0], total, stream)
    return out.view(cols.dtype)
