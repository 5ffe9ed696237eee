"""Host ms from the render's completion event to the frame's bytes on the host
(the float image's copy, astype(uint8), the transpose), median over the window."""

import statistics


def read(trace: dict):
    ms = trace.get("convert_ms")
    return statistics.median(ms) if ms else None
