"""One run of a cell with the program's own recorder installed
(``gs_tpu_torch.utils.profiling``), read from inside the program:

    python3 portbench/inside.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1> [--record <0|1>] [--profile_units <k>] [--table <path.json>]

A diagnostic beside ``run.py``, which it does not replace: it prints no
result line. ``--trace`` is ``run.py``'s. With ``--record 1`` (the
default) the cell's driver runs inside ``profiling.recording`` from its
set-up (a fit's sweep and restore are recorded) to its end. The run then
logs the program's spans over the window's units (median device, self and
host ms a unit), its kernel launches a unit, the set-up's spans and the
driver's end-to-end numbers; with ``--table`` it writes the whole table.

- Untraced, it also logs the host syncs a unit by the line that made them
  (the ``gs.sync.*`` counters, with the span open there) and, with
  ``--profile_units k``, runs a ``torch.profiler`` over ``k`` units of the
  window and sums their kernel time by the innermost ``gs.*`` span
  (``profiling.kernel_ms_by_span``).
- Traced, it sets the program's spans beside the benchmark's:
  ``gs.render`` / ``gs.backward`` / ``gs.adam`` against ``render_ms`` /
  ``backward_ms`` / ``adam_ms``, the children's cover of their parents,
  ``gs.frame.to_host`` + ``gs.frame.pack`` against ``convert_ms``. It
  logs no sync counters there: the benchmark's own sync count takes the
  warnings in its stretch and turns the card's sync debug mode off after
  it. Read them, and ``host_syncs.train``, from separate runs.

To be deleted once the benchmark's drivers install the recorder and its
readers read the spans (ROADMAP E1).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# each inside span checked against the benchmark's span of the same work
CLOSURE = {"gs.render": "render_ms", "gs.backward": "backward_ms", "gs.adam": "adam_ms"}
PARENTS = ("gs.render", "gs.render.preprocess", "gs.backward", "gs.adam", "gs.frame")
PROFILE_AFTER = 50  # units of the window before the profiled ones


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile_units", type=int, default=0,
                    help="untraced: profile this many units of the window (0: none)")
    ap.add_argument("--table", type=Path, default=None,
                    help="write the recorder's whole table and the readings here (JSON)")
    return ap.parse_args(argv)


def median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def warm_units(cell) -> tuple[str, int]:
    """The kind of the cell's units and the units the driver runs before
    its window opens."""
    t = cell.traffic
    if t["kind"] == "fit":
        return "step", t["warmup_steps"]
    return "frame", t["warmup_frames"]


def window_units(cell, table: dict, attempted: int) -> list[str]:
    """The recorder's units of the window, the ``attempted`` units after
    the warm-up ones, less the last: the driver's work after the window's
    close (the fit's state copied for its watch, the viewer's reference)
    falls in that unit, which is still open."""
    kind, warm = warm_units(cell)
    units = sorted((u for u in table if u.startswith(kind + " ")),
                   key=lambda u: int(u.split()[1]))
    return units[warm:warm + attempted - 1]


def summary(table: dict, units: list[str]) -> dict:
    """Per span: median device, self device and host ms a unit; per counter
    and kernel: its mean a unit; the span open at each sync site."""
    rows = [table[u] for u in units if u in table]
    names = sorted({n for r in rows for n in r["spans"]})
    spans = {}
    for n in names:
        got = [r["spans"][n] for r in rows if n in r["spans"]]
        spans[n] = {"units": len(got), "parent": got[0]["parent"],
                    "device_ms": median(g["device_ms"] for g in got),
                    "self_device_ms": median(g["self_device_ms"] for g in got),
                    "host_ms": median(g["host_ms"] for g in got)}
    totals, launches, where = Counter(), Counter(), {}
    for r in rows:
        totals.update(r["counters"])
        launches.update(r["launches"])
        for site, span in r["sync_spans"].items():
            where.setdefault(site, span)
    per = max(len(rows), 1)
    return {"units": len(rows), "spans": spans,
            "counters": {k: v / per for k, v in sorted(totals.items())},
            "sync_spans": where,
            "launches": {k: v / per for k, v in sorted(launches.items())}}


def profiling_recorder(profiling, torch, kind: str, first: int, count: int):
    """A ``profiling.Recorder`` that runs a ``torch.profiler`` over units
    ``first`` to ``first + count - 1`` of ``kind`` (counted from 0) and keeps
    their kernel time by span (``kernels``) and their top kernels (``top``)."""

    class Profiled(profiling.Recorder):
        def __init__(self):
            super().__init__()
            self.seen, self.prof, self.kernels, self.top = 0, None, {}, []

        def begin_unit(self, kind_, index=None):
            super().begin_unit(kind_, index)
            if kind_ != kind or not count:
                return
            if self.seen == first:
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.__enter__()
            elif self.seen == first + count:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
                events = self.prof.events()
                self.kernels = profiling.kernel_ms_by_span(events)
                top = Counter()
                for span, name, ms in profiling.span_kernels(events):
                    top[f"{span} > {name[:80]}"] += ms
                self.top = top.most_common(15)
                self.prof = None
            self.seen += 1

    return Profiled()


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from gs_tpu_torch.utils import profiling
    from portbench import common

    cell = common.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"inside: {cell.name} needs {cell.chips} CUDA card(s)\n")
        return 2
    if args.trace and args.profile_units:
        sys.stderr.write("inside: --profile_units needs --trace 0 (one profiler at a time)\n")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = common.card_info(torch)
    common.log(f"card: {info['kind']} x{info['count']}; nvidia-smi: {info['nvidia_smi']}; "
               f"record {args.record} trace {args.trace}")

    kind, warm = warm_units(cell)
    run = common.driver(cell).run
    rec = None
    if args.record:
        rec = profiling_recorder(profiling, torch, kind, warm + PROFILE_AFTER,
                                 args.profile_units)
        with profiling.recording(rec):
            outcome = run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    else:
        outcome = run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    bad = common.forbidden_modules()
    if bad:
        sys.stderr.write(f"inside: the run loaded {bad}; no readings\n")
        return 3
    common.log(f"end to end: {outcome.end_to_end}; units {outcome.attempted}; checks "
               f"(value, limit) { {n: (v, lim) for n, v, lim in outcome.checks} }")
    if rec is None:
        return 0

    table = rec.table()
    found = summary(table, window_units(cell, table, outcome.attempted))
    setup = table.get(profiling.SETUP, {}).get("spans", {})
    found["setup_spans"] = {n: {"host_ms": r["host_ms"], "device_ms": r["device_ms"],
                                "calls": r["calls"]} for n, r in setup.items()}
    for n, s in found["spans"].items():
        common.log(f"span {n} (under {s['parent']}): device {s['device_ms']} self "
                   f"{s['self_device_ms']} host {s['host_ms']} ms, {s['units']} units")
    for n, s in found["setup_spans"].items():
        common.log(f"set-up span {n}: host {s['host_ms']} device {s['device_ms']} ms, "
                   f"{s['calls']} calls")
    common.log(f"launches a unit ({found['units']} units): {found['launches']}")
    for p in PARENTS:
        kids = [s["device_ms"] for n, s in found["spans"].items() if s["parent"] == p]
        if p in found["spans"] and kids:
            common.log(f"children of {p}: {sum(kids)} of {found['spans'][p]['device_ms']} "
                       f"ms (medians)")
    if not args.trace:
        syncs = {k: v for k, v in found["counters"].items() if k.startswith("gs.sync.")}
        common.log(f"syncs a unit: {sum(syncs.values())}")
        for name, n in syncs.items():
            site = name[len("gs.sync."):]
            common.log(f"sync site {site}: {n} a unit, in {found['sync_spans'].get(site)}")
    if rec.kernels:
        common.log(f"kernel ms of {args.profile_units} profiled units by span: {rec.kernels}")
        for name, ms in rec.top:
            common.log(f"top kernel {name}: {ms} ms")
    tr = outcome.trace
    if tr:
        for n, key in CLOSURE.items():
            if n in found["spans"] and tr.get(key):
                common.log(f"closure {n}: inside {found['spans'][n]['device_ms']} outside "
                           f"{key} {median(tr[key])} ms")
        if tr.get("convert_ms"):
            inside = [found["spans"].get(n, {}).get(f) for n, f in
                      (("gs.frame.to_host", "device_ms"), ("gs.frame.pack", "host_ms"))]
            common.log(f"closure convert: to_host {inside[0]} + pack {inside[1]} against "
                       f"convert_ms {median(tr['convert_ms'])} ms")
    if args.table is not None:
        args.table.parent.mkdir(parents=True, exist_ok=True)
        args.table.write_text(json.dumps({"window": found, "kernel_ms_by_span": rec.kernels,
                                          "top_kernels": rec.top, "table": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
