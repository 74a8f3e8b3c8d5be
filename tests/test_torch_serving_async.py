"""The port's §11 serving runtime against the JAX reference: the silicon
model (``core.perf_model``), the chunk-size policy, and the streaming
engine's async dispatch; and the batch blocks of K1-K4 (their launch rule
and block split, pure Python).

Schedules come from ``tests/_serving_strategies.py`` (real ``hypothesis``
or its stub).  Inside the port, async == sync and policy == fixed chunk bit
for bit (``np.testing.assert_array_equal``).  Against the reference, each
stream is allclose to the reference's SYNC engine and its ``forward`` at
rtol=1e-5, atol=1e-6 (f32, other summation orders): the reference's own
async tests fail on jax 0.9.0 (ROADMAP R1), so its sync engine is the
yardstick.  The engine runs on ``torch_scan`` on the CPU.
"""
import functools
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings

import _serving_strategies as ss

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import perf_model as jpm  # noqa: E402
from repro.models import chipmunk_net as jnet  # noqa: E402
from repro.models import get_bundle  # noqa: E402
from repro.runtime import ChunkSizePolicy as JPolicy  # noqa: E402
from repro.serving import StreamingEngine as JEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.core import perf_model as pm  # noqa: E402
from repro_torch.kernels.lstm_seq import (lstm_seq_ref,  # noqa: E402
                                          lstm_stack_seq_quantized_ref,
                                          seq_geometry, seq_q_geometry,
                                          stack_geometry, stack_q_geometry)
from repro_torch.kernels.lstm_seq.kernel import (  # noqa: E402
    batch_blocks, largest_batch, run_in_blocks)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import chipmunk_net  # noqa: E402
from repro_torch.runtime import ChunkSizePolicy  # noqa: E402
from repro_torch.serving import StreamingEngine  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
CHUNK, SLOTS = 4, 3


@functools.lru_cache(maxsize=None)
def _smoke():
    """(JAX cfg, JAX params, port cfg, port params on the CPU), made once;
    a function, not a fixture, since the hypothesis stub's ``given`` passes
    no fixtures."""
    jcfg = jconfigs.get_smoke_config('chipmunk-ctc')
    jparams, _ = get_bundle(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = stack_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    return jcfg, jparams, cfg, params


@pytest.fixture
def smoke():
    return _smoke()


def _engine(smoke, async_mode, policy=None):
    _, _, cfg, params = smoke
    return StreamingEngine(cfg, params, max_streams=SLOTS, chunk=CHUNK,
                           async_dispatch=async_mode, chunk_policy=policy)


def _policy():
    """Boundaries move deterministically: an infinite budget halves the
    chunk every two commits (4, 2, 1)."""
    return ChunkSizePolicy(chunk_max=CHUNK, slack=1e9, patience=2)


def _reference(smoke, utts, sched):
    """The reference's sync engine on the same schedule, and its forward
    of each utterance."""
    jcfg, jparams, _, _ = smoke
    jeng = JEngine(jcfg, jparams, max_streams=SLOTS, chunk=CHUNK)
    out = ss.run_schedule(jeng, utts, sched)
    mono = [np.asarray(jnet.forward(jcfg, jparams, jnp.asarray(u)[None]))[:, 0]
            for u in utts]
    return out, mono


def _assert_close_to_reference(out, ref_out, mono):
    for i, (lp, errored) in out.items():
        assert not errored
        np.testing.assert_allclose(lp, ref_out[i][0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lp, mono[i], rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- perf_model
@pytest.mark.parametrize('chunk,slack', [(1, 1.0), (16, 1.0), (5, 2.5)])
def test_perf_model_equals_reference(chunk, slack):
    assert pm.FRAME_PERIOD_S == jpm.FRAME_PERIOD_S
    assert pm.table2() == jpm.table2()
    assert pm.staged_realtime_frame_s() == jpm.staged_realtime_frame_s()
    assert pm.staged_realtime_frame_s(chunk=chunk) == \
        jpm.staged_realtime_frame_s(chunk=chunk)
    assert pm.realtime_chunk_budget_s(chunk, slack) == \
        jpm.realtime_chunk_budget_s(chunk, slack)


# ------------------------------------------------------ chunk-size policy
def test_chunk_policy_grows_on_miss_and_pins_floor():
    """A deadline miss doubles the chunk and pins a floor: the policy never
    returns to a size that already missed."""
    pol = ChunkSizePolicy(chunk_max=32, chunk_min=1, slack=1.0)
    assert pol.size == 32
    assert pol.budget_s(8) == pm.realtime_chunk_budget_s(8)
    pol.size = 4
    pol.observe(4, dt=10.0)
    assert pol.misses == 1 and pol.size == 8
    for _ in range(50):
        pol.observe(8, dt=0.0)
    assert pol.size == 8, 'floor must pin the doubled size'


def test_chunk_policy_steps_down_only_when_provably_safe():
    """Step-down requires ``patience`` consecutive chunks already meeting
    the halved budget; observations that only meet the current budget keep
    the size."""
    pol = ChunkSizePolicy(chunk_max=16, chunk_min=2, slack=1.0, patience=3)
    half_budget = pol.budget_s(8)
    for _ in range(10):
        pol.observe(16, dt=half_budget * 1.5)
    assert pol.size == 16
    for _ in range(2):
        pol.observe(16, dt=half_budget * 0.5)
    assert pol.size == 16, 'patience not yet reached'
    pol.observe(16, dt=half_budget * 0.5)
    assert pol.size == 8
    for _ in range(3 * 10):
        pol.observe(pol.size, dt=0.0)
    assert pol.size == 2, 'bounded below by chunk_min'
    assert pol.misses == 0


def test_chunk_policy_budget_is_table2_arrival_rate():
    """The budget is the paper's 10 ms frame-arrival contract:
    ``chunk * FRAME_PERIOD_S * slack`` exactly."""
    pol = ChunkSizePolicy(chunk_max=8, slack=2.5)
    assert pol.budget_s(5) == pytest.approx(5 * pm.FRAME_PERIOD_S * 2.5)
    assert pm.realtime_chunk_budget_s(5, 2.5) == pytest.approx(
        pol.budget_s(5))


@pytest.mark.parametrize('slack,patience', [(1.0, 3), (0.3, 2), (4.0, 1)])
def test_chunk_policy_follows_reference_on_the_same_feed(slack, patience):
    """The same (chunk_len, dt) feed through the port's and the
    reference's policy gives the same size, misses and history at every
    step."""
    rng = np.random.RandomState(int(slack * 10) + patience)
    mine = ChunkSizePolicy(chunk_max=32, chunk_min=2, slack=slack,
                           patience=patience)
    ref = JPolicy(chunk_max=32, chunk_min=2, slack=slack, patience=patience)
    for _ in range(200):
        c = mine.size
        dt = float(rng.uniform(0.0, 2.0) * c * pm.FRAME_PERIOD_S)
        mine.observe(c, dt)
        ref.observe(c, dt)
        assert (mine.size, mine.misses) == (ref.size, ref.misses)
    assert mine.history == ref.history


def test_chunk_policy_rejects_bad_bounds():
    with pytest.raises(ValueError):
        ChunkSizePolicy(chunk_max=4, chunk_min=5)


# ------------------------------------------------------------ async engine
@pytest.mark.timeout(600)
@settings(max_examples=6, deadline=None)
@given(ss.op_schedules())
def test_async_matches_sync_on_control_op_schedules(sched):
    """Priority submissions and preempt/evict/resume interleaved with
    stepping: async == sync bit for bit, and each stream allclose to the
    reference's sync engine and its forward."""
    smoke = _smoke()
    _, _, cfg, _ = smoke
    utts = ss.make_utts(sched['lens'], cfg.lstm_inputs)
    sync_out = ss.run_schedule(_engine(smoke, False), utts, sched)
    async_out = ss.run_schedule(_engine(smoke, True), utts, sched)
    ss.assert_outputs_equal(sync_out, async_out, context=str(sched))
    _assert_close_to_reference(sync_out, *_reference(smoke, utts, sched))


@pytest.mark.timeout(600)
@settings(max_examples=4, deadline=None)
@given(ss.op_schedules())
def test_async_matches_sync_with_chunk_policy(sched):
    """The chunk-size policy moves chunk boundaries (deterministic
    step-downs under an infinite budget); every stream stays bit-equal to
    the fixed-chunk sync run, in both modes, and allclose to the
    reference."""
    smoke = _smoke()
    _, _, cfg, _ = smoke
    utts = ss.make_utts(sched['lens'], cfg.lstm_inputs)
    fixed = ss.run_schedule(_engine(smoke, False), utts, sched)
    for mode in (False, True):
        eng = _engine(smoke, mode, _policy())
        out = ss.run_schedule(eng, utts, sched)
        ss.assert_outputs_equal(fixed, out, context=f'{mode} {sched}')
        assert {c for c, _ in eng._policy.history} <= {1, 2, 4}
    _assert_close_to_reference(fixed, *_reference(smoke, utts, sched))


def test_policy_moves_chunk_boundaries(smoke):
    """Under the infinite budget the engine really steps down (chunks of
    4, then 2, then 1), and stats report the policy's state."""
    _, _, cfg, _ = smoke
    eng = _engine(smoke, True, _policy())
    for u in ss.make_utts([20, 11, 7], cfg.lstm_inputs):
        eng.submit(u)
    eng.run()
    lens = [c for c, _ in eng._policy.history]
    assert lens[:2] == [4, 4] and 2 in lens and lens[-1] == 1
    stats = eng.stats()
    assert stats['async'] and stats['chunk_len'] == 1
    assert stats['deadline_misses'] == 0 and stats['events_dropped'] == 0
    assert stats['event_counts'].get('squash', 0) == 0


def test_squashed_speculation_leaves_committed_state_untouched(
        smoke, monkeypatch):
    """A speculation that admits a waiting stream into a slot that does not
    free (a wrong plan) is squashed at commit; its admission wrote only
    into copies, so committed states and every stream's outputs equal the
    sync engine's bit for bit."""
    _, _, cfg, _ = smoke
    utts = ss.make_utts([22, 18, 14, 9, 6], cfg.lstm_inputs)
    sync = _engine(smoke, False)
    sync_sess = [sync.submit(u) for u in utts]
    sync.run()

    eng = _engine(smoke, True)
    real = eng._speculate

    def wrong(rec):
        spec = real(rec)
        if spec is None or spec[1] or not eng.sched.pending:
            return spec
        plan, _ = spec
        slot, newcomer = plan[0][0], eng.sched.pending[0]
        plan = [(slot, newcomer, newcomer.cursor)] + plan[1:]
        return plan, [(slot, newcomer)]

    monkeypatch.setattr(eng, '_speculate', wrong)
    sess = [eng.submit(u) for u in utts]
    eng.run()
    assert eng.stats()['event_counts'].get('squash', 0) >= 1
    for a, b in zip(sess, sync_sess):
        np.testing.assert_array_equal(a.full_log_probs(), b.full_log_probs())
    for (h, c), (hs, cs) in zip(eng.states, sync.states):
        assert torch.equal(h, hs) and torch.equal(c, cs)


@pytest.mark.parametrize('async_mode', [False, True])
def test_deadline_counts_inflight_time(smoke, monkeypatch, async_mode):
    """Fake clock that moves only between steps: under async dispatch a
    chunk's wall time spans launch to commit, one step apart, so the 5 s
    between the steps are charged to it (a ``deadline_miss`` and the
    policy's feedback); in sync mode launch and commit share a step and
    the chunk is charged nothing."""
    _, _, cfg, _ = smoke
    clock = {'t': 100.0}
    monkeypatch.setattr(engine_mod, 'time',
                        types.SimpleNamespace(time=lambda: clock['t']))
    eng = _engine(smoke, async_mode,
                  ChunkSizePolicy(chunk_max=CHUNK, slack=1.0))
    eng.submit(ss.make_utts([12], cfg.lstm_inputs)[0], sid=0)
    eng.step()
    clock['t'] += 5.0
    eng.step()
    want = 5.0 if async_mode else 0.0
    assert eng.chunk_walls[0] == want
    assert eng._policy.history[0] == (CHUNK, want)
    misses = [e for e in eng.events if e['kind'] == 'deadline_miss']
    assert [e['dt'] for e in misses] == ([5.0] if async_mode else [])
    eng.run()
    assert eng.sched.done[0].remaining == 0


def test_priority_preempts_bulk_under_async(smoke):
    """A priority-1 stream submitted while every slot serves bulk streams
    displaces one (preempt, requeue) in both modes; every stream completes,
    async == sync bit for bit, and allclose to the reference."""
    _, _, cfg, _ = smoke
    sched = {'lens': [24, 24, 24, 6], 'priorities': [0, 0, 0, 1],
             'submit_at': [0, 0, 0, 2], 'ops': [], 'fail_at': {},
             'poison_at': {}}
    utts = ss.make_utts(sched['lens'], cfg.lstm_inputs)
    outs = {}
    for mode in (False, True):
        eng = _engine(smoke, mode)
        outs[mode] = ss.run_schedule(eng, utts, sched)
        counts = eng.stats()['event_counts']
        assert counts.get('preempt', 0) >= 1 and counts.get('resume', 0) >= 1
    ss.assert_outputs_equal(outs[False], outs[True])
    _assert_close_to_reference(outs[True], *_reference(smoke, utts, sched))


def test_engine_rejects_policy_wider_than_packing(smoke):
    _, _, cfg, params = smoke
    with pytest.raises(ValueError):
        StreamingEngine(cfg, params, max_streams=2, chunk=4,
                        chunk_policy=ChunkSizePolicy(chunk_max=8))


def test_serve_cli_async_with_deadline_slo():
    stats = serve.main(['--device', 'cpu', '--smoke', '--requests', '4',
                        '--slots', '2', '--chunk', '4', '--async',
                        '--deadline-slo', '1.0'])
    assert stats['streams'] == 4 and stats['async']
    assert 1 <= stats['chunk_len'] <= 4


# ----------------------------------------------- F4: batch blocks of K1-K4
class _Props:
    multi_processor_count = 132


@pytest.fixture
def h100(monkeypatch):
    """A CUDA device of 132 SMs, as far as dispatch asks."""
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda dev: _Props())
    return 'cuda'


def test_serving_backend_resolves_any_batch(h100):
    """Past K2's and K1's largest single launch (24, 104 streams at N_h
    421), ``auto`` still resolves (to ``cuda_seq``, as before blocks
    existed past K2's), and an explicit kernel backend is admissible at any
    B; only a geometry that fails for one stream raises."""
    cfg = configs.get_config('chipmunk-ctc')
    params = chipmunk_net.init(cfg, device='cpu')
    resolve = lambda b, B: tlstm.resolve_serving_backend(params, b, 16, B,
                                                         h100)
    assert resolve('auto', 24) == 'cuda_seq_fused'
    assert resolve('auto', 25) == resolve('auto', 105) == 'cuda_seq'
    assert resolve('cuda_seq_fused', 105) == 'cuda_seq_fused'
    assert resolve('cuda_seq', 105) == 'cuda_seq'
    meta = lambda *s: torch.empty(s, device='meta')
    n = 4096            # one row slice's weights overflow shared memory
    wide = tlstm.LSTMStackParams(tuple(
        tlstm.LSTMParams(meta(4, n, n), meta(4, n, n), meta(3, n),
                         meta(4, n)) for _ in range(2)), None, None)
    for backend in ('cuda_seq', 'cuda_seq_fused'):
        with pytest.raises(ValueError):
            tlstm.resolve_serving_backend(wide, backend, 16, 1, h100)


def test_int8_dispatch_resolves_any_batch(h100):
    """The int8 stack dispatch at B = 121 (past K4's 96 and K3's inner
    plan's 120): the layerwise chain, no raise."""
    for B in (96, 97, 121, 400):
        pick = tlstm.select_quantized_stack_backend(421, 3, 16, B,
                                                    device=h100, tile=96)
        assert pick == ('fused' if B <= 96 else 'layerwise')


@pytest.mark.parametrize('kernel,geometry,want', [
    ('k1', lambda B: seq_geometry(421, B, 132), 104),
    ('k2', lambda B: stack_geometry(421, 3, B, 132), 24),
    ('k3 layer 0', lambda B: seq_q_geometry(192, 480, 96, B, 132), 208),
    ('k3 inner', lambda B: seq_q_geometry(480, 480, 96, B, 132), 120),
    ('k4', lambda B: stack_q_geometry(480, 96, 3, B, 132), 96)])
def test_largest_batch_is_the_largest_single_launch(kernel, geometry, want):
    """The block size the wrappers launch: the largest admissible B, found
    by bisection, equal to a linear scan."""
    scan = max(B for B in range(1, 1024) if geometry(B).admissible(132))
    assert scan == want
    for B in (1, want - 1, want, want + 1, 3 * want + 5):
        assert largest_batch(geometry, B, 132) == min(B, want)
    assert largest_batch(lambda B: seq_geometry(4096, B, 132), 8, 132) == 0


@pytest.mark.parametrize('batch,block', [(1, 1), (8, 8), (105, 104),
                                         (121, 120), (97, 24), (200, 7)])
def test_batch_blocks_cover_every_row_once(batch, block):
    blocks = batch_blocks(batch, block)
    rows = [r for lo, hi in blocks for r in range(lo, hi)]
    assert rows == list(range(batch))
    assert all(0 < hi - lo <= block for lo, hi in blocks)
    assert len(blocks) == -(-batch // block)


def test_batch_blocks_reject_an_empty_block():
    with pytest.raises(ValueError):
        batch_blocks(8, 0)


def _blocked(ref, block, ins, in_dims, out_like, out_dims, **kw):
    """``ref`` run through ``run_in_blocks`` (the wrappers' block loop),
    its results copied into the blocks' outputs."""
    outs = [torch.empty_like(o) for o in out_like]

    def launch(ins_b, outs_b):
        for o, r in zip(outs_b, ref(*ins_b, **kw)):
            o.copy_(r)

    run_in_blocks(launch, block, ins, in_dims, outs, out_dims)
    return outs


@pytest.mark.parametrize('block', [1, 3, 4, 11])
def test_blocks_equal_one_call_f32(block):
    """K1's plain version through the block loop: each block's rows land
    where they belong (bit-equal to the plain version on those rows), and
    the whole is allclose to one call (the CPU's product picks its
    summation order by row count; the card's kernel does not)."""
    g = torch.Generator().manual_seed(block)
    T, B, N = 5, 11, 6
    r = lambda *s: torch.randn(*s, generator=g)
    mask = torch.rand(T, B, generator=g) > 0.3
    pre_x, h0, c0 = r(T, B, 4, N), r(B, N), r(B, N)
    w = (r(4, N, N), r(3, N), r(4, N))
    ref = lambda p, h, c, m: lstm_seq_ref(p, *w, h, c, m)
    whole = ref(pre_x, h0, c0, mask)
    got = _blocked(ref, block, (pre_x, h0, c0, mask), (1, 0, 0, 1), whole,
                   (1, 1))
    for lo, hi in batch_blocks(B, block):
        part = ref(pre_x[:, lo:hi], h0[lo:hi], c0[lo:hi], mask[:, lo:hi])
        for a, b in zip(got, part):
            assert torch.equal(a[:, lo:hi], b)
    for a, b in zip(got, whole):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('block', [2, 5])
def test_blocks_equal_one_call_int8_stack(block):
    """K4's plain version (layer-major outputs, batch on axis 2) through
    the block loop: bit-equal to one call."""
    rng = np.random.RandomState(block)
    T, B, L, P, tile = 4, 7, 2, 16, 8
    code = lambda *s: torch.from_numpy(rng.randint(-128, 128, s)
                                       .astype(np.int8))
    acc_x = torch.from_numpy(rng.randint(-3000, 3000, (T, B, P // tile, 4,
                                                      tile)).astype(np.int32))
    w = (code(L - 1, 4, P, P), code(L, 4, P, P), code(L, 3, P),
         torch.from_numpy(rng.randint(-500, 500, (L, 4, P)).astype(
             np.int16)), code(256), code(256))
    mask = torch.from_numpy(rng.rand(T, B) > 0.3)
    h0, c0 = code(L, B, P), code(L, B, P)
    ref = lambda a, h, c, m: lstm_stack_seq_quantized_ref(
        a, *w, h, c, m, tile=tile)
    whole = ref(acc_x, h0, c0, mask)
    got = _blocked(ref, block, (acc_x, h0, c0, mask), (1, 1, 1, 1), whole,
                   (2, 2))
    for a, b in zip(got, whole):
        assert torch.equal(a, b)


def test_engine_builds_past_every_single_launch_on_cpu(smoke):
    """The engine at 105 streams (past K1's largest single launch at full
    width) builds and drains; on the CPU every kernel backend runs its
    plain version."""
    _, _, cfg, params = smoke
    eng = StreamingEngine(cfg.replace(lstm_backend='cuda_seq'), params,
                          max_streams=105, chunk=CHUNK, async_dispatch=True)
    sess = [eng.submit(u) for u in ss.make_utts([6, 3, 9], cfg.lstm_inputs)]
    eng.run()
    assert all(s.remaining == 0 for s in sess)
