"""setup_s: from the process's start until the first timed tick: imports,
the kernels' build (or finding them built), the seed-made inputs, the
program's state and the warm-up ticks."""


def read(run):
    return run.setup_s
