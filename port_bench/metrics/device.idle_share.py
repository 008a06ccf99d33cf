"""device.idle_share: 1 - (the union of every device operation's span in
the profiled window) / (the window's wall time), in %."""


def read(run):
    r = run.reading
    if r is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
