"""The training step's needed fp32 operations (roofline.step_ops, from one
traced step's inputs) over the profiled slice's mean step time at the
card's fp32 peak, in percent."""

from portbench.roofline import PEAK_FP32_OPS


def read(trace: dict):
    if trace.get("step_ops") is None or not trace.get("step_s"):
        return None
    return 100.0 * trace["step_ops"] / (trace["step_s"] * PEAK_FP32_OPS)
