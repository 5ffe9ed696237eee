"""The readings a cell's limits are set from (not run by the benchmark's
own runs):

    python3 portbench/control.py --workload <name> --seeds 1,2,... --control-seeds 7,8,9

Every seed of either list runs the cell as a run does (its window at
``--seconds``, the manifest's ``run_seconds`` by default), all in one
process, and gives the lower readings: the program's numbers as the run
compares them. On each of ``--control-seeds`` the upper readings follow,
from what that run watched: the control's (the reference itself put in
the program's place and computed in bfloat16, the nearest precision below
the float32 the configurations state) and each fault the cell's driver
plants (``FAULTS``). A step that leaves its state unchanged reads 1 by
construction.

One JSON line a reading goes to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL_DTYPE = "bfloat16"


def reuse_first_autotune() -> None:
    """Later fits in this process train with the first fit's sweep result
    (the sweep leaves its kernel switches set process-wide)."""
    from gs_tpu_torch.ops import autotune

    real = autotune.autotune_formulation
    first = {}

    def once(*args, **kwargs):
        if "result" not in first:
            first["result"] = real(*args, **kwargs)
        return first["result"]

    autotune.autotune_formulation = once


def readings(cell, seed: int, seconds: float, device, control_dtype=None):
    """The JSON lines of ``seed``: the program's numbers and, with a
    ``control_dtype``, the control's and each fault's."""
    from portbench import common

    driver = common.driver(cell)
    t0 = time.perf_counter()
    out = driver.run(cell, seed, seconds, False, device, t0)
    yield {"reading": "program", "seed": seed, **{n: v for n, v, _ in out.checks},
           "seconds": time.perf_counter() - t0}
    if control_dtype is None:
        return
    t0 = time.perf_counter()
    nums = driver.control(cell, seed, device, control_dtype, out)
    yield {"reading": "control", "dtype": str(control_dtype), "seed": seed, **nums,
           "seconds": time.perf_counter() - t0}
    for name in getattr(driver, "FAULTS", ()):
        t0 = time.perf_counter()
        nums = driver.fault(cell, seed, device, name, out)
        yield {"reading": "fault", "fault": name, "seed": seed, **nums,
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import common

    if not torch.cuda.is_available():
        sys.stderr.write("portbench control: no CUDA card\n")
        return 2
    device = torch.device("cuda", 0)
    cell = common.cell(args.workload)
    seconds = args.seconds or common.manifest()["run_seconds"]
    reuse_first_autotune()
    dtype = getattr(torch, CONTROL_DTYPE)
    for text, ctl in ((args.seeds, None), (args.control_seeds, dtype)):
        for seed in [int(s) for s in text.split(",") if s]:
            for line in readings(cell, seed, seconds, device, ctl):
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
