"""Spans and counters of a traced run, placed by the benchmark around the
program's module attributes; nothing is installed in an untraced run.

Each span boundary is a CUDA event recorded on the stream, so a span's
device time is read on the device's timeline without a synchronization;
each span is also a ``torch.profiler.record_function`` range, which labels
the host's side of the trace. One steady slice of the window runs under
``torch.profiler`` (CPU and CUDA activity): its device intervals give the
busy time (their union, so kernels that overlap count once), the device
operations that took the most time and the idle gaps, each labelled by the
innermost benchmark span and host operation the host was in.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict

import numpy as np
import torch

PROFILE_AFTER = 0.25  # the profiled slice starts this share into the window
TOP = 10


class Patches:
    """Module attributes replaced for the traced window, and put back."""

    def __init__(self):
        self._saved = []

    def replace(self, owner, name: str, make):
        original = getattr(owner, name)
        self._saved.append((owner, name, original))
        setattr(owner, name, make(original))

    def restore(self) -> None:
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)
        self._saved.clear()


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class Recorder:
    """Span events by step (``records``), the profiled slice, one step's or
    frame's compositing inputs (``captured``) and a sync count."""

    def __init__(self, profile_units: int, count_syncs: bool):
        self.count_syncs = count_syncs
        self.patches = Patches()
        self.records: list[dict] = []
        self.current: dict | None = None
        self.profile_units = profile_units
        self.profiler = None
        self.profile_state = "pending"
        self.profile_count = 0
        self.profile_t0 = 0.0
        self.profile = None
        self.capture_state = "waiting"
        self.captured: dict = {}
        self.sync_state = "waiting"
        self._warnings = None
        self._sync_log = None
        self.sync_start = 0
        self.syncs_per_unit = None

    @property
    def complete(self) -> bool:
        """Whether every reading of the traced window has been taken."""
        return (self.profile_state == "done" and self.capture_state == "done"
                and (self.sync_state == "done" or not self.count_syncs))

    @staticmethod
    def warm_profiler(device) -> None:
        """Start the profiler's CUDA tracing once in set-up, so that its
        first start (seconds) falls outside the window."""
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            (torch.ones(1, device=device) + 1).sum().item()

    # -- spans ---------------------------------------------------------------
    def span(self, label: str):
        """A wrapper factory recording ``label``'s events into the current
        record and a profiler range around the call."""
        def make(original):
            def wrapped(*args, **kwargs):
                rec = self.current
                start = _event() if rec is not None else None
                with torch.profiler.record_function(f"pb.{label}"):
                    out = original(*args, **kwargs)
                if rec is not None:
                    rec[label] = (start, _event())
                return out
            return wrapped
        return make

    def begin_unit(self) -> dict:
        self.current = {}
        self.records.append(self.current)
        return self.current

    # -- the profiled slice -------------------------------------------------
    def maybe_start_profile(self, elapsed: float, seconds: float) -> None:
        if self.profile_state == "pending" and elapsed >= PROFILE_AFTER * seconds:
            torch.cuda.synchronize()
            self.profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
            self.profiler.__enter__()
            self.profile_t0 = time.perf_counter()
            self.profile_state = "on"

    def end_unit_profile(self) -> None:
        """Count a unit (step or frame) of the slice; close it after
        ``profile_units``, then arm the capture of the next unit."""
        if self.profile_state != "on":
            return
        self.profile_count += 1
        if self.profile_count < self.profile_units:
            return
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.profile_t0
        self.profiler.__exit__(None, None, None)
        self.profile = summarize(self.profiler, wall)
        self.profile["units"] = self.profile_count
        self.profiler = None
        self.profile_state = "done"
        self.capture_state = "armed"

    # -- compositing inputs of one unit ----------------------------------------
    def capture(self, key: str):
        """A wrapper factory keeping the arguments (and the result) of the
        compositing call ``key`` of the armed unit."""
        def make(original):
            def wrapped(*args):
                out = original(*args)
                if self.capture_state == "armed":
                    self.captured[key] = (original, args, out)
                return out
            return wrapped
        return make

    def end_unit_capture(self) -> None:
        """After the armed unit: move its inputs to the host, so they hold
        no device memory while the window goes on."""
        if self.capture_state != "armed" or not self.captured:
            return
        torch.cuda.synchronize()
        memo = {}
        host = {}
        for key, (fn, args, out) in self.captured.items():
            host[key] = (fn, _to_host(args, memo), _to_host(out, memo))
        self.captured = host
        self.capture_state = "done"
        if self.count_syncs:
            self.sync_state = "pending"

    # -- synchronizations --------------------------------------------------------
    def sync_mark(self, unit: int) -> None:
        """Called at the program's own sync points: count device-to-host
        synchronizations (``torch.cuda.set_sync_debug_mode``) from one mark
        to the next."""
        if self.sync_state == "pending":
            self._warnings = warnings.catch_warnings(record=True)
            self._sync_log = self._warnings.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            self.sync_start = unit
            self.sync_state = "on"
        elif self.sync_state == "on" and unit > self.sync_start:
            torch.cuda.set_sync_debug_mode(0)
            n = sum("synchroniz" in str(w.message) for w in self._sync_log)
            self._warnings.__exit__(None, None, None)
            self.syncs_per_unit = n / (unit - self.sync_start)
            self.sync_state = "done"

    def close(self) -> None:
        """Put the attributes back and end whatever is still open."""
        self.patches.restore()
        if self.sync_state == "on":
            torch.cuda.set_sync_debug_mode(0)
            self._warnings.__exit__(None, None, None)
            self.sync_state = "cut"
        if self.profile_state == "on":
            self.profiler.__exit__(None, None, None)
            self.profile_state = "cut"

    def span_ms(self) -> dict[str, list[float]]:
        """Device milliseconds of each span, by label, over the records."""
        torch.cuda.synchronize()
        out = defaultdict(list)
        for rec in self.records:
            for label, pair in rec.items():
                if isinstance(pair, tuple):
                    out[label].append(pair[0].elapsed_time(pair[1]))
        return dict(out)

    def between_ms(self, first: str, second: str) -> list[float]:
        """Device ms from the end of span ``first`` to the start of span
        ``second`` in each record that has both."""
        torch.cuda.synchronize()
        return [rec[first][1].elapsed_time(rec[second][0]) for rec in self.records
                if first in rec and second in rec]


def _to_host(x, memo: dict):
    """``x`` with its tensors on the host, each tensor copied once."""
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = x.detach().cpu()
        return memo[id(x)]
    if isinstance(x, tuple):
        return _same_tuple(x, [_to_host(v, memo) for v in x])
    return x


def to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return _same_tuple(x, [to_device(v, device) for v in x])
    return x


def _same_tuple(like, values):
    """``values`` as a tuple of ``like``'s type (a named tuple keeps its fields)."""
    return type(like)(*values) if hasattr(like, "_fields") else tuple(values)


def _union(intervals):
    """Merged, sorted [start, end] intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(spans, t):
    """The name of the shortest span of ``spans`` (names, starts, ends as
    arrays) that holds time ``t``, or None."""
    names, starts, ends = spans
    hold = np.nonzero((starts <= t) & (ends >= t))[0]
    if hold.size == 0:
        return None
    return names[hold[np.argmin(ends[hold] - starts[hold])]]


def _arrays(spans):
    return ([n for n, _, _ in spans], np.array([s for _, s, _ in spans], np.float64),
            np.array([e for _, _, e in spans], np.float64))


def summarize(prof, wall_s: float) -> dict:
    """Busy seconds (the union of device intervals), the wall of the slice,
    the device operations that took most time and the idle gaps by label."""
    from torch.autograd import DeviceType

    events = prof.events()
    # the device's own work: kernels, copies, sets; not the ranges that the
    # benchmark's record_function spans mirror onto the device's timeline
    device_ops = [e for e in events if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith(("pb.", "ProfilerStep"))]
    dev = [(e.time_range.start, e.time_range.end) for e in device_ops]
    merged = _union(dev)
    busy_us = sum(e - s for s, e in merged)
    by_op = defaultdict(float)
    for e in device_ops:
        by_op[e.name[:120]] += (e.time_range.end - e.time_range.start) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU]
    spans = _arrays([h for h in host if h[0].startswith("pb.")])
    # host operations, without the CUDA runtime calls they make
    others = _arrays([h for h in host
                      if not h[0].startswith(("pb.", "ProfilerStep", "[memory]", "cuda"))])
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(merged, merged[1:])),
                  reverse=True)
    by_label = defaultdict(float)
    for length, mid in gaps[:200]:
        label = f"{_innermost(spans, mid) or 'loop'} > {_innermost(others, mid) or 'python'}"
        by_label[label] += length / 1e6
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy_us / 1e6, window_s=wall_s,
                device_ops=[[k, v] for k, v in ops], idle_gaps=[[k, v] for k, v in idle],
                device_ops_count=len(dev))
