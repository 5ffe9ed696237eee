"""A frame's needed fp32 operations (roofline.frame_ops, from one traced
frame's inputs) over the profiled slice's mean frame time at the card's fp32
peak, in percent."""

from portbench.roofline import PEAK_FP32_OPS


def read(trace: dict):
    if trace.get("frame_ops") is None or not trace.get("frame_s"):
        return None
    return 100.0 * trace["frame_ops"] / (trace["frame_s"] * PEAK_FP32_OPS)
