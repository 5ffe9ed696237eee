"""Device ms a step from the loss's end to Adam's start: the backward through
compositing, the pair reduction, projection and SH (median over the traced window)."""

import statistics


def read(trace: dict):
    ms = trace.get("backward_ms")
    return statistics.median(ms) if ms else None
