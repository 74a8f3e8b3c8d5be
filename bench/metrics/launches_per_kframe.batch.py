"""Device operations in the traced window per thousand committed frames."""
from bench.readers import ops_per_kframe

UNIT, SOURCE, BETTER = 'launches/kframe', 'device_trace', 'lower'
LAYER, MOVES = 'dispatch and per-step products', 'frames_per_s'


def read(ctx):
    return ops_per_kframe(ctx)
