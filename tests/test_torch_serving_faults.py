"""The port's serving fault runtime (DESIGN.md §10) against the JAX
reference, at the smoke size on the CPU.

Each schedule of the reference's ``tests/test_serving_faults.py`` is
replayed on the reference's SYNC engine and on the port's sync engine
(``_torch_fault_parity``): the same events (backend names mapped, wall
times and ``straggler`` events dropped), the same quarantine verdicts, and
every stream allclose at rtol=1e-5, atol=1e-6 (f32, other summation
orders).  The reference's own async fault tests fail on jax 0.9.0
(ROADMAP R1), so inside the port async == sync is held bit for bit
(``np.testing.assert_array_equal``) on the strategies' fault schedules, as
are quarantine isolation, guard on == guard off, cross-engine checkpoint
resume, the int8 carries through the checkpointer, and the trainer's
``run_step`` restore.  On the CPU the kernel backends run their plain
versions; the reference's Pallas kernels run in interpret mode.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings

import _serving_strategies as ss

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import _torch_fault_parity as fp  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import systolic as jsys  # noqa: E402
from repro.core import lstm as jlstm  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.runtime import EngineFailure as JEngineFailure  # noqa: E402
from repro.runtime import ServingFaultConfig as JFaultConfig  # noqa: E402
from repro.runtime import finite_slots as jfinite_slots  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import quantized_packed_from_numpy  # noqa: E402
from repro_torch.data import SyntheticCTC  # noqa: E402
from repro_torch.kernels.lstm_seq import (  # noqa: E402
    lstm_stack_seq_quantized_auto)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.models import chipmunk_net  # noqa: E402
from repro_torch.optim import cosine_schedule, make_optimizer  # noqa: E402
from repro_torch.runtime import (EngineFailure, FaultConfig,  # noqa: E402
                                 FaultTolerantRunner, ServingFaultConfig,
                                 StreamStateCheckpointer, chunk_deadline_s,
                                 elastic_replace, finite_slots)
from repro_torch.serving import StreamingEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

case = fp.case

# The schedules of the reference's tests/test_serving_faults.py (its
# backend, packing, utterances, fault config and control ops).
CASES = {
    'preempt_resume': case('xla_scan', ('ramp', 4, 0),
                           ops=[('step',), ('step',), ('preempt', 0)]),
    'evict_resume': case('xla_scan', ('ramp', 4, 0),
                         ops=[('step',), ('evict_resume', 1)]),
    'transient_retry': case('pallas_seq', ('ramp', 3, 0),
                            fail_at={1: {'n_dead': 1, 'transient': True}},
                            backoff_s=0.0),
    'permanent_no_retry_budget': case('pallas_seq', ('ramp', 3, 0),
                                      fail_at={1: 1}, max_retries=0,
                                      backoff_s=0.0),
    'dict_spec_domain': case('pallas_seq', ('ramp', 3, 0),
                             fail_at={1: {'n_dead': 1, 'domain': 0}},
                             backoff_s=0.0),
    'degrade_no_stream_loss': case('pallas_seq', ('ramp', 5, 0),
                                   fail_at={2: 1}, backoff_s=0.0),
    'degrade_exhausted': case('xla_scan', ('ramp', 3, 0), fail_at={1: 2},
                              backoff_s=0.0),
    'degrade_then_preempt': case('pallas_seq', ('ramp', 4, 0),
                                 fail_at={2: 1}, backoff_s=0.0,
                                 ops=[('step',)] * 3 + [('preempt', 0)]),
    'quarantine': case('xla_scan', ('ramp', 5, 0), slots=3,
                       poison_at={1: 1}),
    'quarantine_rows': case('xla_scan', ('ramp', 3, 0), slots=3,
                            poison_at={0: 2}),
    'deadline_watchdog': case('xla_scan', ('ramp', 3, 0), deadline_s=1e-12),
    'guard_on': case('xla_scan', ('ramp', 4, 3)),
    # the card phase's ladder at the smoke size: K2 -> K1 -> scan and back
    'fused_ladder': case('pallas_seq_fused', ('flat', 2, 140),
                         fail_at={2: 1, 5: 1}, recover_at={8: 1, 14: 1},
                         promote_hysteresis=2, backoff_s=0.0),
}


@pytest.fixture(scope='module')
def reference():
    """The reference's sync engine per schedule, each run once."""
    return fp.reference_cache()


# ------------------------------------------------- config and pure parts
def test_fault_config_equals_reference():
    for kw in ({}, {'deadline_s': 0.5}, {'deadline_factor': 2.0},
               {'deadline_s': 0.25, 'deadline_factor': 3.0}):
        for chunk in (1, 8, 16):
            assert ServingFaultConfig(**kw).resolve_deadline_s(chunk) == \
                JFaultConfig(**kw).resolve_deadline_s(chunk)
    assert chunk_deadline_s(16, 2.0) == pytest.approx(
        JFaultConfig(deadline_factor=2.0).resolve_deadline_s(16))
    assert [f.name for f in dataclasses.fields(ServingFaultConfig)] == \
        [f.name for f in dataclasses.fields(JFaultConfig)]
    assert dataclasses.asdict(ServingFaultConfig()) == \
        dataclasses.asdict(JFaultConfig())


@pytest.mark.parametrize('spec', [2, {'n_dead': 2, 'transient': True,
                                      'domain': 1}, {'domain': 0}, {}])
def test_fail_schedule_equals_reference(spec):
    got = ServingFaultConfig(fail_at={3: spec}).make_fail_schedule()
    want = JFaultConfig(fail_at={3: spec}).make_fail_schedule()
    assert got(0) is None and want(0) is None
    g, w = got(3), want(3)
    assert isinstance(g, EngineFailure) and isinstance(w, JEngineFailure)
    assert (g.n_dead, g.transient, g.domain, str(g)) == \
        (w.n_dead, w.transient, w.domain, str(w))
    assert repr(g) == repr(w)


def test_finite_slots_equals_reference():
    rng = np.random.RandomState(0)
    rows = [[rng.randn(5, 7).astype(np.float32) for _ in range(2)]
            for _ in range(3)]
    rows[0][1][2, 3] = np.nan
    rows[2][0][4, 0] = np.inf
    want = np.asarray(jfinite_slots(tuple(
        (jnp.asarray(h), jnp.asarray(c)) for h, c in rows)))
    got = finite_slots(tuple((torch.from_numpy(h), torch.from_numpy(c))
                             for h, c in rows))
    assert got.dtype == torch.bool and got.shape == (5,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [True, True, False, True, False])
    # int8 carries are finite by definition
    q = torch.zeros((4, 6), dtype=torch.int8)
    assert bool(finite_slots(((q, q),)).all())


def test_elastic_replace_keeps_bits_and_never_aliases():
    x = torch.randn(4, 9)
    x[1, 2] = float('nan')
    q = torch.randint(-128, 127, (4, 9), dtype=torch.int8)
    tree = ((x, q), (x * 3, q))
    out = elastic_replace(tree)
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype and a.device == b.device
        assert a.data_ptr() != b.data_ptr()
        np.testing.assert_array_equal(a.numpy().view(np.uint8),
                                      b.numpy().view(np.uint8))


def test_build_fault_config_equals_reference(tmp_path):
    argv = ['--fail-at-step', '3', '--fail-engines', '2@5',
            '--fail-engines', '1@3', '--poison-slot', '1@4',
            '--recover-at-step', '1@7', '--promote-hysteresis', '3',
            '--no-canary', '--stream-ckpt-dir', str(tmp_path),
            '--deadline-factor', '2.5']
    args = serve.build_parser().parse_args(argv)
    got = serve._build_fault_config(args)
    want = jserve._build_fault_config(args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fail_at == {5: 2, 3: 1} and not got.canary
    none = serve.build_parser().parse_args([])
    assert serve._build_fault_config(none) is None
    assert jserve._build_fault_config(none) is None


# ---------------------------------------------- engine against reference
@pytest.mark.parametrize('name', sorted(CASES))
def test_engine_matches_reference_sync(reference, name):
    """The port's sync engine under the reference test's schedule: the
    same event trail and verdicts, every stream allclose."""
    c = CASES[name]
    fp.assert_matches_reference(fp.run_port(c), reference(c))


def test_transient_over_budget_raises_like_reference():
    """A transient fault with max_retries=0 is terminal in both."""
    c = case('pallas_seq', ('ramp', 2, 0), fail_at={1: {'transient': True}},
             max_retries=0, backoff_s=0.0)
    with pytest.raises(JEngineFailure):
        fp.run_reference(c)
    eng = fp.make_engine(c)
    for u in c.make_utts():
        eng.submit(u)
    with pytest.raises(EngineFailure):
        eng.run()
    assert eng.backend == 'cuda_seq'


def test_degrade_lands_on_ladder_with_payload():
    out, st = fp.run_port(CASES['degrade_no_stream_loss'])
    assert st['backend'] == 'torch_scan' and len(out) == 5
    assert [e for e in st['events'] if e['kind'] == 'degrade'] == [
        {'kind': 'degrade', 'step': 2, 'from_backend': 'cuda_seq',
         'to_backend': 'torch_scan', 'n_dead': 1, 'domain': 0}]
    out, st = fp.run_port(CASES['dict_spec_domain'])
    assert st['heartbeat']['fault_domain'] == 0


def test_kernel_error_retried_then_raised_never_degraded(monkeypatch):
    """A real error of the chunk call (not an ``EngineFailure``) is
    transient: retried under the budget, then raised; the ladder never
    moves."""
    c = case('pallas_seq', ('ramp', 2, 0), max_retries=2, backoff_s=0.0)
    eng = fp.make_engine(c)
    calls = []

    def broken(states, frames, valid):
        calls.append(1)
        raise RuntimeError('CUDA error: an illegal memory access')

    monkeypatch.setattr(eng, '_fwd', broken)
    for u in c.make_utts():
        eng.submit(u)
    with pytest.raises(RuntimeError, match='illegal'):
        eng.run()
    st = eng.stats()
    assert len(calls) == 3 and st['backend'] == 'cuda_seq'
    faults = [e for e in st['events'] if e['kind'] == 'fault']
    assert [f['transient'] for f in faults] == [True] * 3
    assert st['event_counts'].get('degrade', 0) == 0


# ------------------------------------------- inside the port: async == sync
@pytest.mark.timeout(600)
@settings(max_examples=10, deadline=None)
@given(ss.fault_schedules())
def test_async_matches_sync_on_fault_schedules(sched):
    """Engine failures and slot poisons: async == sync bit for bit (event
    kinds, verdicts, outputs), on the K1 rung's home (``cuda_seq``)."""
    _, _, cfg, params = fp.smoke()
    utts = ss.make_utts(sched['lens'], cfg.lstm_inputs)
    runs = []
    for mode in (False, True):
        eng = StreamingEngine(
            cfg.replace(lstm_backend='cuda_seq'), params, max_streams=3,
            chunk=4, async_dispatch=mode,
            faults=ServingFaultConfig(fail_at=dict(sched['fail_at']),
                                      poison_at=dict(sched['poison_at']),
                                      backoff_s=0.0))
        out = ss.run_schedule(eng, utts, sched)
        runs.append(({i: v for i, v in out.items()}, eng.stats()))
    fp.assert_bit_equal(*runs)


# -------------------------------------------------------------- quarantine
@pytest.mark.parametrize('backend', ['cuda_seq_fused', 'cuda_seq'])
def test_quarantine_isolates_poisoned_slot_bit_equal(backend):
    """The victim ends with an error; every other stream is bit-equal to a
    poison-free run, guard on or off; after the quarantine no state row is
    non-finite and nothing was written into the chunk's output states."""
    _, _, cfg, params = fp.smoke()
    c = cfg.replace(lstm_backend=backend)
    utts = fp.utts_ramp(5)

    def run(faults):
        eng = StreamingEngine(c, params, max_streams=3, chunk=8,
                              faults=faults)
        sess = [eng.submit(u) for u in utts]
        eng.run()
        return eng, sess

    clean_on, base = run(ServingFaultConfig())
    _, base_off = run(None)
    eng, sess = run(ServingFaultConfig(poison_at={1: 1}))
    victims = [s for s in sess if s.error is not None]
    assert len(victims) == 1 and 'quarantined' in victims[0].error
    assert victims[0] not in eng.sched.done
    for s, b, b_off in zip(sess, base, base_off):
        if s.error is None:
            np.testing.assert_array_equal(s.full_log_probs(),
                                          b.full_log_probs())
            np.testing.assert_array_equal(s.full_log_probs(),
                                          b_off.full_log_probs())
    for h, cc in eng.states:
        assert bool(torch.isfinite(h).all() and torch.isfinite(cc).all())


def test_quarantine_scrubs_copies_not_the_chunk_outputs(monkeypatch):
    _, _, cfg, params = fp.smoke()
    eng = StreamingEngine(cfg.replace(lstm_backend='cuda_seq'), params,
                          max_streams=3, chunk=8,
                          faults=ServingFaultConfig(poison_at={0: 2}))
    seen = []
    real = eng._commit

    def spy(rec):
        seen.append(rec)
        return real(rec)

    monkeypatch.setattr(eng, '_commit', spy)
    for u in fp.utts_ramp(3):
        eng.submit(u)
    eng.step()
    out = seen[0].new_states
    for (h, c), (ho, co) in zip(eng.states, out):
        assert torch.equal(h[2], torch.zeros_like(h[2]))
        assert bool(torch.isnan(ho[2]).all()), 'chunk outputs untouched'
        assert torch.equal(h[:2], ho[:2]) and torch.equal(c[:2], co[:2])
    assert bool(torch.isnan(seen[0].states_in[0][0][2]).all())


def test_poison_writes_copies_never_the_committed_cache():
    _, _, cfg, params = fp.smoke()
    eng = StreamingEngine(cfg, params, max_streams=2, chunk=8,
                          faults=ServingFaultConfig(poison_at={1: 0}))
    for u in fp.utts_ramp(2):
        eng.submit(u)
    eng.step()
    before = [t.clone() for t in leaves(eng.states)]
    rec = eng._launch(eng.states, [(i, s, s.cursor)
                                   for i, s in eng.sched.active()], 1, 8)
    for a, b in zip(before, leaves(eng.states)):
        assert torch.equal(a, b)
    assert bool(torch.isnan(rec.states_in[0][0][0]).all())


# ------------------------------------------------------------- guard cost
@pytest.mark.parametrize('async_mode', [False, True])
@pytest.mark.parametrize('backend', ['cuda_seq_fused', 'cuda_seq',
                                     'torch_scan'])
def test_guard_on_equals_guard_off_bit_equal(backend, async_mode):
    _, _, cfg, params = fp.smoke()
    c = cfg.replace(lstm_backend=backend)
    utts = fp.utts_ramp(4, seed=3)
    outs = []
    for faults in (None, ServingFaultConfig(),
                   ServingFaultConfig(guard_nonfinite=False)):
        eng = StreamingEngine(c, params, max_streams=2, chunk=8,
                              faults=faults, async_dispatch=async_mode)
        sess = [eng.submit(u) for u in utts]
        eng.run()
        outs.append([s.full_log_probs() for s in sess])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a, b)


def test_no_fault_config_runs_no_guard_and_no_runner(monkeypatch):
    """``faults=None`` is the engine without the runtime: no runner, no
    guard reduction, no mask copied back."""
    from repro_torch.serving import engine as engine_mod
    calls = []
    monkeypatch.setattr(engine_mod, 'finite_slots',
                        lambda s: calls.append(1) or finite_slots(s))
    _, _, cfg, params = fp.smoke()
    eng = StreamingEngine(cfg, params, max_streams=2, chunk=8)
    for u in fp.utts_ramp(2):
        eng.submit(u)
    rec = eng._launch(eng.states, [], 0, 8)
    assert rec.host_finite is None and eng._runner is None
    eng.run()
    assert calls == []
    st = eng.stats()
    assert st['heartbeat'] is None and st['healthy_domains'] is None
    guarded = StreamingEngine(cfg, params, max_streams=2, chunk=8,
                              faults=ServingFaultConfig())
    for u in fp.utts_ramp(2):
        guarded.submit(u)
    guarded.run()
    assert calls and guarded.stats()['heartbeat'] is not None


# -------------------------------------------------------------- checkpoints
@pytest.mark.parametrize('backend', ['cuda_seq_fused', 'cuda_seq'])
def test_cross_engine_checkpoint_resume_bit_equal(tmp_path, backend):
    """Preempt to disk, build a FRESH engine, resume from the checkpoint:
    the suffix continues bit-equal to the uninterrupted run."""
    _, _, cfg, params = fp.smoke()
    c = cfg.replace(lstm_backend=backend)
    utts = fp.utts_ramp(4)
    base = StreamingEngine(c, params, max_streams=2, chunk=8)
    ref = [base.submit(u) for u in utts]
    base.run()
    fc = ServingFaultConfig(checkpoint_dir=str(tmp_path))
    eng = StreamingEngine(c, params, max_streams=2, chunk=8, faults=fc)
    ss_ = [eng.submit(u) for u in utts[:2]]
    eng.step()
    eng.step()
    eng.evict(ss_[0].sid)
    eng.run()
    assert [e['kind'] for e in eng.events][:2] == ['checkpoint', 'preempt']
    eng2 = StreamingEngine(c, params, max_streams=2, chunk=8, faults=fc)
    assert eng2._ckpt.has(ss_[0].sid) and not eng2._ckpt.has(99)
    sess = eng2.resume_from_checkpoint(utts[0], ss_[0].sid)
    assert sess.cursor == 16
    eng2.run()
    np.testing.assert_array_equal(ref[0].full_log_probs()[16:],
                                  sess.full_log_probs())
    with pytest.raises(ValueError):
        StreamingEngine(c, params, max_streams=2,
                        chunk=8).resume_from_checkpoint(utts[0], 0)


def test_quarantined_session_cannot_resume():
    _, _, cfg, params = fp.smoke()
    eng = StreamingEngine(cfg, params, max_streams=3, chunk=8,
                          faults=ServingFaultConfig(poison_at={0: 0}))
    sess = [eng.submit(u) for u in fp.utts_ramp(3)]
    eng.run()
    assert sess[0].error is not None
    with pytest.raises(ValueError, match='quarantined'):
        eng.resume(sess[0])


def test_int8_carries_through_checkpointer_bit_identical(tmp_path):
    """The int8 stack's opaque ``(h_q, c_q)`` carries round-trip through
    ``StreamStateCheckpointer`` with their dtype, and the resumed chunk
    continues bit-identical to the uninterrupted stack (K4's plain
    version), which is bit-identical to the reference's."""
    rng = np.random.RandomState(4)
    n_x, n_h, tile = 16, 48, 16
    jqps = []
    for l in range(2):
        nx = n_x if l == 0 else n_h
        u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
        lp = jlstm.LSTMParams(w_x=jnp.asarray(u(4, n_h, nx)),
                              w_h=jnp.asarray(u(4, n_h, n_h)),
                              w_peep=jnp.asarray(u(3, n_h) * 0.5),
                              b=jnp.asarray(u(4, n_h) * 0.5))
        jqps.append(jsys.quantize_packed(jsys.pack_lstm(
            lp, jsys.SystolicPlan(nx, n_h, tile))))
    qps = [quantized_packed_from_numpy(jax.tree.map(np.asarray, q), 'cpu')
           for q in jqps]
    xs = rng.randn(9, 3, n_x).astype(np.float32) * 0.5
    xq = torch.from_numpy(np.array(jquant.quantize(jnp.asarray(xs))))
    ref = lstm_stack_seq_quantized_auto(qps, xq, backend='fused')
    head, state = lstm_stack_seq_quantized_auto(
        qps, xq[:6], return_state=True, backend='fused')
    ckpt = StreamStateCheckpointer(str(tmp_path))
    ckpt.save(7, (tuple(state),), cursor=6)
    like = (tuple(torch.zeros_like(s) for s in state),)
    (restored,), cursor = ckpt.load(7, like)
    assert cursor == 6
    for a, b in zip(restored, state):
        assert a.dtype == b.dtype == torch.int8
        assert torch.equal(a, b)
    tail = lstm_stack_seq_quantized_auto(qps, xq[6:], state=tuple(restored),
                                         backend='fused')
    assert torch.equal(torch.cat([head, tail]), ref)


# --------------------------------------------------- trainer under runner
def test_train_run_step_restore_bit_equal(tmp_path):
    """An injected fault in ``run_step`` restores the step's checkpoint
    and recomputes the step: loss, gradient norm and every state leaf
    bit-equal to the uninterrupted step."""
    cfg = configs.get_smoke_config('chipmunk-ctc').replace(
        lstm_backend='cuda_seq_fused')
    opt = make_optimizer(cfg.optimizer, cosine_schedule(1e-2, 1, 4))
    step_fn = ttrain.make_train_step(
        functools.partial(chipmunk_net.loss_fn, cfg), opt)
    state = ttrain.init_train_state(cfg, opt, 'cpu')
    shape = configs.ShapeConfig('t', 'train', 12, 2)
    src = SyntheticCTC(cfg, shape)
    batches = [{k: torch.from_numpy(v) for k, v in
                src.host_batch(k, 0, 2).items()} for k in range(2)]
    state, _ = step_fn(state, batches[0])
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, state, blocking=True)
    want_state, want = step_fn(state, batches[1])
    runner = FaultTolerantRunner(
        step_fn, ckpt_manager=ckpt,
        cfg=FaultConfig(backoff_s=0.0,
                        heartbeat_path=str(tmp_path / 'heartbeat.json')),
        restore_fn=lambda: ckpt.restore(state),
        fail_schedule=lambda s: s == 1)
    got_state, got = runner.run_step(1, state, batches[1])
    assert [e['kind'] for e in runner.events] == ['fault', 'restore']
    assert torch.equal(got['loss'], want['loss'])
    assert torch.equal(got['grad_norm'], want['grad_norm'])
    for a, b in zip(leaves(got_state), leaves(want_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert (tmp_path / 'heartbeat.json').exists()


def test_train_cli_writes_heartbeat(tmp_path, capsys):
    ttrain.main(['--device', 'cpu', '--smoke', '--steps', '3', '--batch',
                 '2', '--seq', '12', '--ckpt-dir', str(tmp_path)])
    assert 'done; events: []' in capsys.readouterr().out
    beat = (tmp_path / 'heartbeat.json').read_text()
    assert '"step": 2' in beat and '"fault_domain": null' in beat


# ------------------------------------------------------------- serve CLI
@pytest.mark.parametrize('flags,check', [
    (['--fail-at-step', '1'], lambda st: st['event_counts']['degrade'] == 1),
    (['--fail-engines', '2@1'],
     lambda st: st['backend'] == 'torch_scan'),
    (['--poison-slot', '0@1'],
     lambda st: st['event_counts']['quarantine'] == 1),
    (['--fail-engines', '1@1', '--recover-at-step', '1@2',
      '--promote-hysteresis', '1'],
     lambda st: st['event_counts'].get('promote') == 1
     and st['backend'] == 'cuda_seq_fused'),
    (['--fail-engines', '1@1', '--recover-at-step', '1@2',
      '--promote-hysteresis', '1', '--no-canary'],
     lambda st: st['event_counts'].get('promote') == 1
     and 'promote_canary' not in st['event_counts']),
    (['--stream-ckpt-dir', 'CKPT'], lambda st: st['heartbeat'] is not None),
    (['--deadline-factor', '1e-9'],
     lambda st: st['deadline_misses'] == st['steps'] > 0),
])
def test_serve_cli_fault_flags(tmp_path, capsys, flags, check):
    flags = [str(tmp_path) if f == 'CKPT' else f for f in flags]
    stats = serve.main(['--device', 'cpu', '--smoke', '--requests', '4',
                        '--slots', '2', '--chunk', '4', '--lstm-backend',
                        'cuda_seq_fused'] + flags)
    assert stats['streams'] == 4 - stats['event_counts'].get('quarantine', 0)
    assert check(stats), stats
    assert 'fault summary: backend=' in capsys.readouterr().out
