"""Device ms of optim.update a step (median over the traced window)."""

import statistics


def read(trace: dict):
    ms = trace.get("adam_ms")
    return statistics.median(ms) if ms else None
