"""What every run shares: the manifest, the card, the clocks, the checks
and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gs_tpu")
# ~5 ms at the 1.98 GHz boost clock: the host queues short kernels ahead
# of the card before the start event, so the events time the card
HOST_AHEAD_CYCLES = 10_000_000


class WindowClosed(Exception):
    """Raised from the program's progress callback to end a fit's window."""


class Window:
    """The measured window of a loop that reports at its own sync points:
    it opens at the first report at or past ``warm`` units and closes at
    the first report ``seconds`` or more after it opened. A report that
    asks to ``hold`` keeps it open, up to ``hold_limit`` times ``seconds``."""

    def __init__(self, seconds: float, warm: int, hold_limit: float = 6.0):
        self.seconds, self.warm, self.hold_limit = seconds, warm, hold_limit
        self.t_open = self.u_open = self.t_close = self.u_close = None

    @property
    def is_open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    def tick(self, unit: int, now: float, hold: bool = False) -> bool:
        """Take a report of ``unit`` units done at time ``now``; True when
        it closes the window."""
        if self.t_open is None:
            if unit >= self.warm:
                self.t_open, self.u_open = now, unit
            return False
        if self.t_close is not None:
            return False
        elapsed = now - self.t_open
        if elapsed >= self.seconds and not (hold and elapsed < self.hold_limit * self.seconds):
            self.t_close, self.u_close = now, unit
            return True
        return False

    @property
    def units(self) -> int:
        return self.u_close - self.u_open

    def ms_per_unit(self) -> float:
        """Wall milliseconds a unit: all the window's time over all its units."""
        return (self.t_close - self.t_open) / self.units * 1e3

    def units_per_s(self) -> float:
        """Units a second: all the window's units over all its time."""
        return self.units / (self.t_close - self.t_open)


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, traffic mix,
    limits and the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


@dataclass
class Outcome:
    """What a driver hands back: end-to-end values by name, the traced
    run's records for the per-layer readers, the comparisons, and the
    device's numbers."""

    end_to_end: dict
    checks: list  # (name, value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None
    notes: dict = field(default_factory=dict)  # what the control reads (a fit: its phases)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Cell:
    """The cell ``name`` of the manifest, with the files it names."""
    bench = manifest()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m) and ("workloads" in m or m["moves"] in names)]
    return Cell(name=name, chips=w["chips"], config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=per_layer)


def driver(cell_: Cell):
    """The traffic driver of ``cell_``: the module ``portbench/traffic/<kind>.py``
    that the kind named in its traffic mix names. It has ``run`` (one run
    of the cell), ``control`` and, where the cell has faults to plant,
    ``FAULTS`` and ``fault`` (the readings of ``portbench/control.py``)."""
    kind = cell_.traffic["kind"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", kind):
        raise SystemExit(f"traffic kind {kind!r} is not a module name")
    return importlib.import_module(f"portbench.traffic.{kind}")


def metric_reader(name: str):
    """``read(trace) -> float | None`` of the per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def card_info(torch) -> dict:
    """The card's name and, from nvidia-smi, its power limit and clocks."""
    info = {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    query = "power.limit,clocks.sm,clocks.max.sm,temperature.gpu,power.draw"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        info["nvidia_smi"] = out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        info["nvidia_smi"] = f"unavailable ({type(e).__name__})"
    return info


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs (CUDA
    events), the card spun first so that the events time the card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_peak_memory(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)


def peak_memory(device) -> int:
    """Bytes at the device's allocation peak since the last reset (0 off the card)."""
    if device.type != "cuda":
        return 0
    import torch

    return torch.cuda.max_memory_allocated(device)


def free_cached(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile (0 < q <= 100) of ``values``."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def log(*parts) -> None:
    print(*parts, flush=True)


def result_line(outcome: Outcome, cell_: Cell, traced: bool, device: dict) -> tuple[dict, bool]:
    """The result object (``checks`` last) and whether the run is correct."""
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in outcome.checks)
    units = {m["name"]: m["unit"] for m in cell_.end_to_end + cell_.per_layer}
    metrics = {}
    if traced:
        for m in cell_.per_layer:
            value = metric_reader(m["name"])(outcome.trace or {})
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in cell_.end_to_end:
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": units[m["name"]]}
    dev = {"platform": "gpu", "kind": device["kind"], "count": cell_.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": dev}
    if traced and outcome.trace:
        prof = outcome.trace.get("profile") or {}
        if prof:
            dev["busy_s"] = prof["busy_s"]
            dev["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    return result, correct


def emit(result: dict) -> None:
    """The result as the last line of stdout, then each compared number
    beside its limit as the last lines of stderr."""
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} (limit {c['limit']!r})\n")
    sys.stderr.flush()


def scratch_path(name: str) -> str:
    """A file of this run under the run's temporary directory."""
    return os.path.join(tempfile.gettempdir(), name)
