"""From the process's start to the first timed frame: imports, weights,
the kernels' build or load, the cell's warm-up (host clock)."""
UNIT, SOURCE, BETTER = 's', 'host_clock', 'lower'


def read(ctx):
    return ctx.setup_s
