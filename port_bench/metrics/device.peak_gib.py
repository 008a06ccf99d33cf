"""device.peak_gib: `torch.cuda.max_memory_allocated` over the window,
after a reset at its start, in GiB."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
