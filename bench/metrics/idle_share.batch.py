"""1 - the union of the device's operations over the traced window, %."""
from bench.readers import idle_share

UNIT, SOURCE, BETTER = '%', 'device_trace', 'lower'
LAYER, MOVES = 'device', 'frames_per_s'


def read(ctx):
    return idle_share(ctx)
