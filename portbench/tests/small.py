"""The cells at a size the CPU runs in seconds: the same configurations
and traffic mixes with fewer Gaussians, views and pixels."""

from __future__ import annotations

import copy

from portbench import common

SEED = 2 ** 31 + 77  # past 32 signed bits, as the driver's seeds are


def small_cell(name: str) -> common.Cell:
    c = common.cell(name)
    cfg = copy.deepcopy(c.config)
    scale = 80 / cfg["width"]
    cfg.update(gaussians=3000, width=80, height=56, views=12,
               focal_px=cfg["focal_px"] * scale)
    traffic = dict(c.traffic)
    if traffic["kind"] == "fit":
        traffic.update(warmup_steps=10, log_every=5)
    else:
        traffic.update(warmup_frames=2, sample_every=2, compare_frames=3)
    c.config, c.traffic = cfg, traffic
    return c
