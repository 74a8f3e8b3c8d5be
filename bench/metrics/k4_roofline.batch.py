"""K4's share of its roofline over the calls of the traced window."""
from bench import yardstick
from bench.readers import kernel_roofline

UNIT, SOURCE, BETTER = '%', 'device_trace', 'higher'
LAYER, MOVES, KERNEL = 'kernels', 'frames_per_s', 'lstm_stack_seq_q_kernel'


def bound_s(call, cfg):
    """The bound of one int8 K4 call (T, B, live) at the int8 peak."""
    T, B, live = call
    return yardstick.bound_s(*yardstick.k4_call(T, B, live, cfg['n_h'],
                                                cfg['n_layers']),
                             yardstick.INT8_OPS_PER_S)


def read(ctx):
    return kernel_roofline(ctx, KERNEL, bound_s)
