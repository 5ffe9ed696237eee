"""1 - the union of device intervals over the profiled slice's wall, in percent."""


def read(trace: dict):
    prof = trace.get("profile")
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
