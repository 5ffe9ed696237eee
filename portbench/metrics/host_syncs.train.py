"""Device-to-host synchronizations a training step, counted with
torch.cuda.set_sync_debug_mode over the steps between two of the loop's
progress callbacks."""


def read(trace: dict):
    return trace.get("syncs_per_step")
