"""torch.cuda.max_memory_allocated over the window (reset at its start), GiB."""


def read(trace: dict):
    b = trace.get("peak_mem_bytes")
    return None if not b else b / 2 ** 30
