"""Device ms of training.render a step (the median over the traced window)."""

import statistics


def read(trace: dict):
    ms = trace.get("render_ms")
    return statistics.median(ms) if ms else None
