"""K2's share of its roofline over the calls of the traced window."""
from bench import yardstick
from bench.readers import kernel_roofline

UNIT, SOURCE, BETTER = '%', 'device_trace', 'higher'
LAYER, MOVES, KERNEL = 'kernels', 'frames_per_s', 'lstm_stack_seq_kernel'


def bound_s(call, cfg):
    """The bound of one f32 K2 call (T, B, live) at the f32 peak."""
    T, B, live = call
    return yardstick.bound_s(*yardstick.k2_call(T, B, live, cfg['n_h'],
                                                cfg['n_layers']),
                             yardstick.F32_FLOPS_PER_S)


def read(ctx):
    return kernel_roofline(ctx, KERNEL, bound_s)
