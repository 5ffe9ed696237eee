"""Step timing and profiler hooks (port of ``gs_tpu/utils/profiling.py``).

``StepTimer`` is gs_tpu's, unchanged: an exponential moving average of the
step time fed only at synchronizing steps, with the per-step average since
the previous one, plus pixels/s. The traces come from ``torch.profiler``
(CPU activity, and CUDA activity where a card is present) instead of
``jax.profiler``: ``Tracer`` / ``trace`` write one Chrome trace
(``trace_<pid>_<ns>.json``) under the log directory, which
``chrome://tracing`` or Perfetto open.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


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


class Tracer:
    """A ``torch.profiler`` trace started and stopped by the caller, written
    as a Chrome trace under ``log_dir`` when it stops."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path: str | None = None
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> str:
        """Stop tracing and write the trace; returns its path."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the queued kernels end inside the trace
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
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


@contextlib.contextmanager
def annotate(name: str):
    """Named region in profiler traces (``record_function``)."""
    with torch.profiler.record_function(name):
        yield
