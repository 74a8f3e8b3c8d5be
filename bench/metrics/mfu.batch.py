"""The whole step's share of the card's peak in the configuration's type:
committed frames x the network's operations a frame (its reference's 2 x
MACs: 7.556 MFLOP at 123 -> 3x421 -> 62), over the traced window and the
peak (67 TFLOP/s float32, 1,979 TOP/s int8)."""
from bench.readers import mfu

UNIT, SOURCE, BETTER = '%', 'device_trace', 'higher'
LAYER, MOVES = 'whole step', 'frames_per_s'


def read(ctx):
    return mfu(ctx)
