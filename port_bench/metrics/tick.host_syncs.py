"""tick.host_syncs: synchronising calls a tick, counted by PyTorch's CUDA
sync debug mode around each call of the entry in the traced window (the
harness's own read of the wheel targets is outside the count)."""


def read(run):
    if not run.syncs or run.device.type != "cuda":
        return None
    return sum(run.syncs) / len(run.syncs)
