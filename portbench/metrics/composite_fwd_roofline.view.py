"""The compositing forward's frozen bound over the device time of whichever
kernel ran it (B1 or B3), on one traced frame's inputs, in percent."""


def read(trace: dict):
    if not trace.get("fwd_kernel_ms"):
        return None
    return 100.0 * trace["fwd_bound_ms"] / trace["fwd_kernel_ms"]
