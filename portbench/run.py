"""One run of one cell of the gs_tpu_torch benchmark, on the card(s) of
the machine it starts on:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix, its limits and the metrics
it reports come from ``BENCHMARK.json`` and the files it names. With
``--trace 0`` the result's metrics are the cell's end-to-end ones; with
``--trace 1`` its per-layer ones, from spans the benchmark places around
the program. The last line of stdout is the result; the last lines of
stderr are the comparisons that decide ``correct``, each beside its limit.
Without enough CUDA cards, or if JAX or the JAX package was loaded, the
run exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    # kernel and build caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT))
    from portbench import common

    cell = common.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), "
                         f"found {found}\n")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    info = common.card_info(torch)
    common.log(f"card: {info['kind']} x{info['count']}; nvidia-smi power.limit, clocks.sm, "
               f"clocks.max.sm, temperature, power.draw: {info['nvidia_smi']}; torch "
               f"{torch.__version__} CUDA {torch.version.cuda}")
    outcome = common.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    common.log(f"card after the run: {common.card_info(torch)['nvidia_smi']}")
    bad = common.forbidden_modules()
    if bad:
        sys.stderr.write(f"portbench: the run loaded {bad}; no result\n")
        return 3
    result, _ = common.result_line(outcome, cell, bool(args.trace), info)
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
