"""The compositing backward's frozen bound over the device time of whichever
kernel ran it (B2 or B4), on one traced step's inputs, in percent."""


def read(trace: dict):
    if not trace.get("bwd_kernel_ms"):
        return None
    return 100.0 * trace["bwd_bound_ms"] / trace["bwd_kernel_ms"]
