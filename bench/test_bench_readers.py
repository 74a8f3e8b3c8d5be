"""The metric readers and the trace reduction on a small synthetic
profiler trace."""
import pytest
from torch.autograd import DeviceType

from bench import harness, yardstick
from bench.readers import Context, Traced
from bench.trace import summarize

CFG = dict(n_x=123, n_h=421, n_layers=3, n_out=62, dtype='float32')
MS = 1_000_000


class Ev:
    def __init__(self, name, start, dur, cuda=True, label=False):
        self._v = (name, start, dur, cuda, label)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


def _trace():
    # a 10 ms window: host label bench.step over [0, 10), an aten op over
    # [6, 9); device: K2 [1, 4) and [2, 3) (overlapping), a copy [5, 6)
    events = [Ev('bench.step', 0, 10 * MS, cuda=False, label=True),
              Ev('aten::einsum', 6 * MS, 3 * MS, cuda=False),
              Ev('void lstm_stack_seq_kernel(float const*)', 1 * MS, 3 * MS),
              Ev('void lstm_stack_seq_kernel(float const*)', 2 * MS, 1 * MS),
              Ev('Memcpy DtoH (Device -> Pinned)', 5 * MS, 1 * MS)]
    return summarize(events, 0.010)


def test_summary():
    t = _trace()
    assert t.window_s == 0.010
    assert t.busy_s == pytest.approx(0.004)
    assert t.kernel_s('lstm_stack_seq_kernel') == pytest.approx(0.004)
    assert t.kernel_s('lstm_stack_seq_q_kernel') == 0
    assert len(t.ops) == 3
    gaps = dict(t.breakdown()['idle_gaps'])
    assert gaps['bench.step/python'] == pytest.approx(0.002)   # [0,1) [4,5)
    assert gaps['bench.step/aten::einsum'] == pytest.approx(0.004)  # [6,10)
    ops = t.breakdown()['device_ops']
    assert ops[0] == ['void lstm_stack_seq_kernel(float const*)',
                      pytest.approx(0.004)]


def _ctx(**kw):
    calls = [(64, 1024, 60_000), (64, 1024, 62_000)]
    return Context(config=CFG, cell={}, setup_s=12.5, window_s=2.0,
                   frames=900_000, ops_per_frame=2 * 3_778_054,
                   trace=_trace(), traced=Traced(calls=calls), **kw)


@pytest.mark.parametrize('name, want', [
    ('frames_per_s', 450_000.0),
    ('setup_s', 12.5),
    ('slot_fill.batch', 100.0 * 122_000 / (2 * 64 * 1024)),
    ('launches_per_kframe.batch', 3 / 122.0),
    ('idle_share.batch', 60.0),
])
def test_readers(name, want):
    assert harness.metric_module(name).read(_ctx()) == pytest.approx(want)


def test_roofline_and_mfu():
    ctx = _ctx()
    bound = sum(yardstick.bound_s(*yardstick.k2_call(T, B, n, 421, 3),
                                  yardstick.F32_FLOPS_PER_S)
                for T, B, n in ctx.traced.calls)
    got = harness.metric_module('k2_roofline.batch').read(ctx)
    assert got == pytest.approx(100 * bound / 0.004)
    # no K4 in the trace: nothing to read, never 0
    assert harness.metric_module('k4_roofline.batch').read(ctx) is None
    want = 100 * 122_000 * 2 * 3_778_054 / 0.010 / 67e12
    assert harness.metric_module('mfu.batch').read(ctx) == pytest.approx(want)


def test_mfu_takes_the_peak_of_the_type():
    ctx = _ctx(run={})
    ctx.config = dict(CFG, dtype='int8')
    want = 100 * 122_000 * 2 * 3_778_054 / 0.010 / 1979e12
    assert harness.metric_module('mfu.batch').read(ctx) == pytest.approx(want)


@pytest.mark.parametrize('name', ['k2_roofline.batch', 'idle_share.batch',
                                  'mfu.batch', 'launches_per_kframe.batch',
                                  'slot_fill.batch', 'frames_per_s'])
def test_untraced_readers_read_nothing(name):
    ctx = Context(config=CFG, cell={}, setup_s=1.0)
    assert harness.metric_module(name).read(ctx) is None
