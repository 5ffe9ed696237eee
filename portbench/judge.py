"""The comparisons that decide ``correct``: the numbers the program's
timed path produced against the plain reference's, each with its limit
(the cell's ``workloads/<cell>.json``, where the readings each limit was
set from are written beside it)."""

from __future__ import annotations

import statistics

import torch

# a leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by round-off alone: it is left out of the change
FLAT_LEAF_SHARE = 1e-3


def worst_leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    median = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves)


def fit_numbers(prog: dict, ref: dict) -> dict:
    """The three numbers of a fit: the worst step's relative loss gap, the
    worst leaf's first-gradient norm gap and the worst leaf's change gap."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    leaves = sorted(ref["grad"])
    grad_gap = worst_leaf_gap(prog["grad"], ref["grad"], leaves)
    median_grad = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= FLAT_LEAF_SHARE * median_grad]
    change_gap = worst_leaf_gap(prog["change"], ref["change"], moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def fit_checks(prog: dict, ref: dict, limits: dict, prefix: str = "") -> list:
    """The fit's numbers, named with ``prefix``, each with its limit."""
    if len(prog["losses"]) != len(ref["losses"]):
        return [(prefix + "steps_missing",
                 float(abs(len(prog["losses"]) - len(ref["losses"]))), 0.0)]
    numbers = fit_numbers(prog, ref)
    return [(prefix + name, numbers[name], limits[prefix + name])
            for name in ("loss_gap", "grad_gap", "change_gap")]


def frame_numbers(frames: list, refs: list) -> dict:
    """Frames of uint8 bytes against the reference's: the largest byte gap
    and the share of bytes that differ at all."""
    worst, off, total = 0, 0, 0
    for got, want in zip(frames, refs):
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        worst = max(worst, int(diff.max()))
        off += int((diff > 0).sum())
        total += diff.numel()
    return {"byte_gap": float(worst), "bytes_off_share": off / total if total else 1.0}


def frame_checks(frames: list, refs: list, limits: dict) -> list:
    if not frames:
        return [("frames_missing", 1.0, 0.0)]
    numbers = frame_numbers(frames, refs)
    return [(name, numbers[name], limits[name]) for name in ("byte_gap", "bytes_off_share")]
