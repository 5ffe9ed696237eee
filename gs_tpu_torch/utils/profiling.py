"""Step timing, profiler traces, and the program's spans and counters
(port of ``gs_tpu/utils/profiling.py``).

``StepTimer`` is gs_tpu's, unchanged: an exponential moving average of the
step time fed only at synchronizing steps, with the per-step average since
the previous one, plus pixels/s. The traces come from ``torch.profiler``
(CPU activity, and CUDA activity where a card is present) instead of
``jax.profiler``: ``Tracer`` / ``trace`` write one Chrome trace
(``trace_<pid>_<ns>.json``) under the log directory, which
``chrome://tracing`` or Perfetto open, and beside it the window's span
table (``spans_<pid>_<ns>.json``).

Spans and counters. ``annotate(name)`` marks a layer of the program
(``gs.render``, ``gs.backward.composite``, ...; PERF.md section 3 lists
them) and ``count(name, n)`` adds to a counter. Both record into the
``Recorder`` installed with ``recording`` (``Tracer`` installs one for its
window). With none installed, ``annotate`` returns one shared null context
and ``count`` returns at once: no CUDA event is made and no profiler range
is opened.

Host syncs are measured, not declared: while a recording is on, a card
runs under ``torch.cuda.set_sync_debug_mode("warn")``, and each warning of
a synchronizing operation is counted as ``gs.sync.<dir>/<file>:<line>`` of
the Python line that made it (the last two parts of its path), in the
current unit, beside the innermost span open there (the unit's
``sync_spans``). The warnings are consumed; every other warning passes on.
On the CPU nothing synchronizes and nothing is counted.

A recorded span keeps its name, its parent span, its unit (``step <i>``
for the loop's 1-based iteration, ``frame <n>`` for the n-th viewer frame,
``setup`` before both), its host start and end (``perf_counter_ns``) and,
where a card is present, the device milliseconds between two CUDA events on the current stream. It is also a
``record_function`` range of its name, so a profiler over the window
places the layers on its own clock beside the kernels. The parent stack
is the recorder's, not a thread's: autograd runs the backward of a custom
function on its own device thread while the caller waits in
``torch.autograd.grad``, and those spans still nest under ``gs.backward``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from dataclasses import dataclass, field

import torch

from gs_tpu_torch.ops import cuda_build


@dataclass
class StepTimer:
    """Exponential-moving-average step timer with throughput accounting.

    The card runs ahead of the host, so only steps that pull a value to the
    host wait for the work queued before them. Callers mark which stops are
    synchronizing (``stop(synced=...)``): the EMA is fed only there, with
    the *per-step average* since the previous sync, so ``ema_s`` is a true
    per-step time for any sync cadence.
    """

    ema_decay: float = 0.9
    ema_s: float = 0.0
    last_s: float = 0.0
    total_s: float = 0.0
    steps: int = 0
    _t0: float = field(default=0.0, repr=False)
    _accum_s: float = field(default=0.0, repr=False)
    _accum_steps: int = field(default=0, repr=False)
    _ema_seeded: bool = field(default=False, repr=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, synced: bool = True) -> float:
        dt = time.perf_counter() - self._t0
        self.last_s = dt
        self.total_s += dt
        self.steps += 1
        self._accum_s += dt
        self._accum_steps += 1
        if synced:
            per_step = self._accum_s / self._accum_steps
            self.ema_s = per_step if not self._ema_seeded else (
                self.ema_decay * self.ema_s + (1.0 - self.ema_decay) * per_step
            )
            self._ema_seeded = True
            self._accum_s = 0.0
            self._accum_steps = 0
        return dt

    def pixels_per_s(self, pixels_per_step: int) -> float:
        return pixels_per_step / self.ema_s if self.ema_s > 0 else 0.0


SETUP = "setup"  # the unit of spans opened before the first step or frame


class SpanRecord:
    """One closed span: its name, its parent's name (None at the top), its
    unit, its host start and end (ns) and its device milliseconds (None
    without device time). ``events`` holds the CUDA events until
    ``Recorder.resolve`` reads them."""

    __slots__ = ("name", "parent", "unit", "t0_ns", "t1_ns", "device_ms", "events")

    def __init__(self, name, parent, unit, t0_ns, t1_ns, device_ms=None, events=None):
        self.name, self.parent, self.unit = name, parent, unit
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.device_ms, self.events = device_ms, events

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class _Span:
    """The context manager of one recorded span."""

    __slots__ = ("rec", "name", "parent", "unit", "range", "ev0", "t0")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.parent = rec.stack[-1] if rec.stack else None
        self.unit = rec.unit
        rec.stack.append(self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.ev0 = rec.event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        t1 = time.perf_counter_ns()
        ev1 = rec.event()
        self.range.__exit__(*exc)
        rec.stack.pop()
        events = None if ev1 is None else (self.ev0, ev1)
        rec.spans.append(SpanRecord(self.name, self.parent, self.unit, self.t0, t1,
                                    events=events))
        return False


class Recorder:
    """The program's spans and counters, kept in memory by unit.

    Where a card is present each span gets its device milliseconds (two
    CUDA events on the current stream). Counters are kept per unit
    (``counters``, with ``sync_spans``: the span open at each sync site),
    and each unit also gets the change of ``cuda_build.LAUNCHES`` over it
    (``launches``), which stays the one count of kernel launches.
    ``table()`` sums each unit's spans by name after ``resolve`` has read
    the device times."""

    def __init__(self):
        self.device_time = torch.cuda.is_available()
        self.spans: list[SpanRecord] = []
        self.units: dict[str, dict] = {}
        self.stack: list[str] = []
        self.frames = 0
        self.unit = SETUP
        self._launches = {}
        self._open(SETUP)

    def event(self):
        if not self.device_time:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, n: int) -> None:
        counters = self.units[self.unit]["counters"]
        counters[name] = counters.get(name, 0) + n

    def sync(self, site: str) -> None:
        """Count a host sync made at ``site`` (``<dir>/<file>:<line>``)."""
        self.add(f"gs.sync.{site}", 1)
        self.units[self.unit]["sync_spans"].setdefault(site, self.stack[-1] if self.stack
                                                       else None)

    def begin_unit(self, kind: str, index: int | None = None) -> None:
        """End the current unit and open ``<kind> <index>``; a frame with no
        index takes the recorder's running frame number."""
        if index is None:
            index, self.frames = self.frames, self.frames + 1
        self._close()
        self._open(f"{kind} {index}")

    def _open(self, unit: str) -> None:
        self.unit = unit
        self.units.setdefault(unit, {"counters": {}, "sync_spans": {}, "launches": {}})
        self._launches = dict(cuda_build.LAUNCHES)

    def _close(self) -> None:
        launches = self.units[self.unit]["launches"]
        for name, n in cuda_build.LAUNCHES.items():
            if n != self._launches.get(name, 0):
                launches[name] = launches.get(name, 0) + n - self._launches.get(name, 0)
        self._launches = dict(cuda_build.LAUNCHES)

    def resolve(self) -> None:
        """Close the current unit's launch count and read every span's
        device time (one synchronization)."""
        self._close()
        pending = [s for s in self.spans if s.events is not None]
        if pending:
            torch.cuda.synchronize()
        for s in pending:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None

    def table(self) -> dict[str, dict]:
        """``{unit: {"spans": ..., "counters": ..., "launches": ...}}``,
        each unit's spans summed by name (``span_table``)."""
        self.resolve()
        by_unit = span_table(self.spans)
        return {u: {"spans": by_unit.get(u, {}), **rec} for u, rec in self.units.items()}


def span_table(spans) -> dict[str, dict[str, dict]]:
    """``{unit: {name: row}}`` of resolved spans, summed by unit and name.
    A row holds ``calls``, ``parent`` (the first call's), ``host_ms`` and
    ``device_ms`` (None if any call had none), and ``self_host_ms`` /
    ``self_device_ms``: the span's time less its children's, where a child
    is a span whose parent has the row's name in the same unit."""
    out: dict[str, dict[str, dict]] = {}
    children: dict[tuple, list] = {}
    for s in spans:
        rows = out.setdefault(s.unit, {})
        row = rows.setdefault(s.name, {"calls": 0, "parent": s.parent, "host_ms": 0.0,
                                       "device_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += s.host_ms
        row["device_ms"] = (None if row["device_ms"] is None or s.device_ms is None
                            else row["device_ms"] + s.device_ms)
        if s.parent is not None:
            kids = children.setdefault((s.unit, s.parent), [0.0, 0.0])
            kids[0] += s.host_ms
            kids[1] = None if kids[1] is None or s.device_ms is None else kids[1] + s.device_ms
    for unit, rows in out.items():
        for name, row in rows.items():
            host, device = children.get((unit, name), (0.0, 0.0))
            row["self_host_ms"] = row["host_ms"] - host
            row["self_device_ms"] = (None if row["device_ms"] is None or device is None
                                     else row["device_ms"] - device)
    return out


def span_kernels(events):
    """``(span, kernel, ms)`` for each device kernel and copy of a profile
    (``torch.profiler``'s ``prof.events()``): the span is the innermost
    ``gs.`` range open on the host when the runtime call that launched the
    kernel (its CUDA correlation id) was made, on whatever thread, as the
    recorder's parent stack is kept (autograd launches the backward from
    its device thread while the caller's ``gs.backward`` is open, and a
    hand-written kernel bound through ctypes is launched by no operator).
    A kernel whose launch is not in the profile, or is outside every
    range, counts under ``"(none)"``. The ranges' own mirrors on the
    device's timeline are not kernels."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = sorted((e.time_range.end - e.time_range.start, e.time_range.start,
                     e.time_range.end, e.name) for e in cpu if e.name.startswith("gs."))
    launched = {e.id: e.time_range.start for e in cpu if e.name.startswith(("cuda", "cu"))}
    for e in events:
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.name.startswith(("gs.", "pb.", "ProfilerStep"))):
            continue
        t = launched.get(e.id)
        span = "(none)" if t is None else next(
            (n for _, start, end, n in ranges if start <= t <= end), "(none)")
        yield span, e.name, (e.time_range.end - e.time_range.start) / 1e3


def kernel_ms_by_span(events) -> dict[str, float]:
    """Device milliseconds of a profile's kernels by span
    (``span_kernels``), largest first."""
    out: dict[str, float] = {}
    for span, _, ms in span_kernels(events):
        out[span] = out.get(span, 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


_NULL = contextlib.nullcontext()
_RECORDER: Recorder | None = None


def _install(rec: Recorder | None) -> Recorder | None:
    """Install ``rec`` (None: none) as the process's recorder; returns the
    one it replaces."""
    global _RECORDER
    previous, _RECORDER = _RECORDER, rec
    return previous


# the warning of torch.cuda.set_sync_debug_mode("warn") at each host sync
SYNC_WARNING = "called a synchronizing CUDA operation"


def _counting_syncs(show):
    """A ``warnings.showwarning`` that counts each sync warning at its
    file and line into the installed recorder and hands every other
    warning to ``show``."""
    def showwarning(message, category, filename, lineno, file=None, line=None):
        rec = _RECORDER
        if rec is None or not str(message).startswith(SYNC_WARNING):
            return show(message, category, filename, lineno, file, line)
        rec.sync(f"{'/'.join(os.path.normpath(filename).split(os.sep)[-2:])}:{lineno}")
    return showwarning


@contextlib.contextmanager
def recording(rec: Recorder):
    """Record the program's spans, counters and host syncs into ``rec``
    inside the block, then put back the recorder, the warning filters and
    the card's sync debug mode that were there before it."""
    previous = _install(rec)
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.showwarning = _counting_syncs(warnings.showwarning)
            if mode is not None:
                torch.cuda.set_sync_debug_mode("warn")
            yield rec
    finally:
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        _install(previous)


def annotate(name: str):
    """The span ``name`` around a block: recorded by the installed
    recorder and a ``record_function`` range in profiler traces; one shared
    null context when no recorder is installed."""
    rec = _RECORDER
    return _NULL if rec is None else rec.span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the installed recorder's
    current unit; nothing when none is installed."""
    rec = _RECORDER
    if rec is not None:
        rec.add(name, n)


def begin_unit(kind: str, index: int | None = None) -> None:
    """Open the unit the spans and counters after it belong to (``step``
    with the loop's iteration, ``frame`` with none: the recorder numbers
    frames); nothing when no recorder is installed."""
    rec = _RECORDER
    if rec is not None:
        rec.begin_unit(kind, index)


class Tracer:
    """A ``torch.profiler`` trace started and stopped by the caller, written
    as a Chrome trace under ``log_dir`` when it stops. A ``Recorder`` is
    installed with ``recording`` for the window, so the trace
    carries the program's ``gs.*`` spans, and their table is written
    beside the trace: ``{"units": Recorder.table(), "kernel_ms_by_span":
    kernel_ms_by_span(...)}``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: str | None = None
        self.spans_path: str | None = None
        self.recorder = Recorder()
        self._recording = contextlib.ExitStack()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)

    def start(self) -> None:
        self._recording.enter_context(recording(self.recorder))
        self._prof.start()

    def stop(self) -> str:
        """Stop tracing and write the trace and the span table; returns the
        trace's path."""
        self._recording.close()
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the queued kernels end inside the trace
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        stem = f"{os.getpid()}_{time.time_ns()}.json"
        self.path = os.path.join(self.log_dir, f"trace_{stem}")
        self._prof.export_chrome_trace(self.path)
        self.spans_path = os.path.join(self.log_dir, f"spans_{stem}")
        with open(self.spans_path, "w") as f:
            json.dump({"units": self.recorder.table(),
                       "kernel_ms_by_span": kernel_ms_by_span(self._prof.events())}, f)
        return self.path


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profiler trace of the block written under ``log_dir``; no-op for None."""
    if log_dir is None:
        yield
        return
    tracer = Tracer(log_dir)
    tracer.start()
    try:
        yield
    finally:
        tracer.stop()
