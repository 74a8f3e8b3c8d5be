"""The port's recovery runtime (DESIGN.md §14) against the JAX reference:
the fault runner, the health tracker, the rung ladder under CUDA names,
and the engine's degrade / heal / canary / promote round trips, at the
smoke size on the CPU.

The runner and the tracker are pure control-plane code: fed the same
schedules (the runner on a fake clock, so its durations are the schedule's
own) they must give the reference's event trails, verdicts and state
exactly.  The ladder maps the reference's names through
``pallas_seq_fused`` -> ``cuda_seq_fused``, ``pallas_seq`` -> ``cuda_seq``,
``pallas_step`` -> ``cuda_step``, ``xla_scan`` -> ``torch_scan``; the
reference's systolic top rung has no counterpart yet (its multi-device
scale-out is not ported), so its promotion to it reads as None.  The
engine schedules of the reference's ``tests/test_recovery.py`` (flat
ladder only) run on the reference's SYNC engine and on the port's: the
same events (wall times and ``straggler`` events dropped), every stream
allclose at rtol=1e-5, atol=1e-6.  Inside the port, async == sync bit for
bit on the strategies' recovery schedules, and a round trip on the CPU,
where all three rungs give the same bits, is bit-equal to an
uninterrupted run.
"""
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings

import _serving_strategies as ss

jax = pytest.importorskip('jax')

import _torch_fault_parity as fp  # noqa: E402
from repro.core import lstm as jlstm  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import recovery as jrecovery  # noqa: E402
from repro.runtime import serving_faults as jsf  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.runtime import fault as tfault  # noqa: E402
from repro_torch.runtime import recovery as trecovery  # noqa: E402
from repro_torch.runtime import serving_faults as tsf  # noqa: E402
from repro_torch.runtime import ServingFaultConfig  # noqa: E402
from repro_torch.serving import StreamingEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

case = fp.case
TO_REF = {v: k for k, v in fp.NAME_MAP.items()}

# The flat-ladder schedules of the reference's tests/test_recovery.py, and
# the fused home's two-rung climbs.
CASES = {
    'promote_roundtrip': case('pallas_seq', ('flat', 2, 100),
                              fail_at={1: 1}, recover_at={4: 1},
                              promote_hysteresis=2, backoff_s=0.0),
    'promote_payload': case('pallas_seq', ('flat', 2, 80), fail_at={1: 1},
                            recover_at={4: 1}, promote_hysteresis=2,
                            backoff_s=0.0),
    'heal_before_window': case('pallas_seq', ('flat', 2, 100),
                               fail_at={1: 1}, recover_at={2: 1},
                               promote_hysteresis=6, backoff_s=0.0),
    'flapping': case('pallas_seq', ('flat', 2, 100),
                     fail_at={1: 1, 4: 1, 9: 1},
                     recover_at={3: 1, 6: 1, 11: 1},
                     promote_hysteresis=2, backoff_s=0.0),
    'rejected_canary': case('pallas_seq', ('flat', 2, 100), fail_at={1: 1},
                            recover_at={4: 1}, promote_hysteresis=2,
                            backoff_s=0.0, reject_canary=True),
    'no_canary': case('pallas_seq', ('flat', 2, 100), fail_at={1: 1},
                      recover_at={4: 1}, promote_hysteresis=2, canary=False,
                      backoff_s=0.0),
    'fused_two_rungs_at_once': case('pallas_seq_fused', ('flat', 2, 100),
                                    fail_at={1: 2},
                                    recover_at={4: 1, 7: 1},
                                    promote_hysteresis=2, backoff_s=0.0),
    'fused_canary_rtol': case('pallas_seq_fused', ('flat', 2, 80),
                              fail_at={2: 1}, recover_at={5: 1},
                              promote_hysteresis=2, canary_rtol=1e-4,
                              backoff_s=0.0),
}


@pytest.fixture(scope='module')
def reference():
    """The reference's sync engine per schedule, each run once."""
    return fp.reference_cache()


# ------------------------------------------------------------ the runner
# A program is a list of calls; each call drives ``run`` (or ``run_step``)
# once.  Attempts: ('ok', dt), ('error', dt) a RuntimeError, ('transient',
# dt) / ('permanent', dt, domain) an EngineFailure; dt advances the fake
# clock.  ``inject`` maps step -> True or ('ef', n_dead, transient, domain).
PROGRAMS = {
    'straggler_and_deadline': dict(
        cfg=dict(deadline_s=2.5),
        calls=[dict(step=k, attempts=[('ok', dt)])
               for k, dt in enumerate([1, 1, 1, 4, 1, 3, 0.5, 1])]),
    'transient_retries': dict(
        cfg={}, calls=[
            dict(step=0, attempts=[('transient', 1), ('ok', 1)]),
            dict(step=1, attempts=[('error', 0.5), ('error', 0.5),
                                   ('ok', 1)]),
            dict(step=2, attempts=[('ok', 1)])]),
    'transient_over_budget': dict(
        cfg={}, calls=[dict(step=0, attempts=[('ok', 1)]),
                       dict(step=1, attempts=[('error', 1)] * 4)]),
    'permanent_hook_and_cap': dict(
        cfg=dict(max_permanent=3), calls=[
            dict(step=0, attempts=[('permanent', 1, 0), ('permanent', 1, None),
                                   ('ok', 1)], hook=True),
            dict(step=1, attempts=[('permanent', 1, 1)] * 5, hook=True)]),
    'mixed_taxonomy': dict(
        cfg={}, calls=[
            dict(step=0, attempts=[('permanent', 1, 2), ('transient', 1),
                                   ('permanent', 1, None), ('error', 1),
                                   ('ok', 2)], hook=True)]),
    'injected_first_attempt_only': dict(
        cfg={}, inject={1: True, 2: ('ef', 1, False, 1),
                        3: ('ef', 2, True, None)},
        calls=[dict(step=k, attempts=[('ok', 1)], hook=True)
               for k in range(5)]),
    'launched_at_and_retry_fn': dict(
        cfg=dict(deadline_s=2.5), calls=[
            dict(step=0, attempts=[('ok', 1)], launched_at=2.0),
            dict(step=1, attempts=[('transient', 1)], launched_at=0.5,
                 retry=[('ok', 2)]),
            dict(step=2, attempts=[('ok', 1)], launched_at=0.0,
                 deadline_s=0.5)]),
    'bounded_log': dict(
        cfg=dict(event_log_cap=3, deadline_s=0.5),
        calls=[dict(step=k, attempts=[('error', 1), ('ok', 1)])
               for k in range(4)]),
    'run_step_restore': dict(
        cfg={}, inject={1: True},
        calls=[dict(step=k, attempts=[('ok', 1)], train=True)
               for k in range(3)]
        + [dict(step=3, attempts=[('error', 1), ('ok', 1)], train=True)]),
}


def _run_program(fault_mod, sf_mod, prog, monkeypatch):
    """Drive ``prog`` on ``fault_mod``'s runner with a fake clock; returns
    everything observable: per-call results, events, misses, stragglers,
    the heartbeat without its wall time, sleeps and hook calls."""
    now = {'t': 1000.0}
    sleeps = []
    monkeypatch.setattr(fault_mod, 'time', types.SimpleNamespace(
        time=lambda: now['t'], sleep=sleeps.append))
    EF = sf_mod.EngineFailure

    def exc(a):
        if a[0] == 'error':
            return RuntimeError('boom')
        if a[0] == 'transient':
            return EF(1, transient=True)
        return EF(1, domain=a[2])

    inject = {}
    for k, v in prog.get('inject', {}).items():
        inject[k] = v if v is True else EF(v[1], transient=v[2],
                                          domain=v[3])
    hooks, results = [], []
    queue = []

    def attempt(*_):
        a = queue.pop(0)
        now['t'] += a[1]
        if a[0] != 'ok':
            raise exc(a)
        return ('state', now['t']) if _ else now['t']

    runner = fault_mod.FaultTolerantRunner(
        step_fn=lambda state, batch: attempt(state, batch),
        cfg=fault_mod.FaultConfig(max_retries=2, backoff_s=0.5,
                                  **prog['cfg']),
        restore_fn=lambda: 'restored', fail_schedule=inject.get)
    for call in prog['calls']:
        queue[:] = list(call['attempts'])
        retry_q = list(call.get('retry', []))

        def retry():
            queue.insert(0, retry_q.pop(0))
            return attempt()

        try:
            if call.get('train'):
                out = runner.run_step(call['step'], 'state', 'batch')
            else:
                launched = (None if 'launched_at' not in call
                            else now['t'] - call['launched_at'])
                out = runner.run(
                    call['step'], attempt,
                    on_fault=(lambda e, n: hooks.append((type(e).__name__,
                                                         n)))
                    if call.get('hook') else None,
                    retry_fn=retry if retry_q else None,
                    launched_at=launched,
                    deadline_s=call.get('deadline_s'))
            results.append(('ok', out))
        except Exception as e:       # noqa: BLE001 — recorded, compared
            results.append(('raised', repr(e)))
    beat = dict(runner.last_heartbeat or {})
    beat.pop('time', None)
    return dict(results=results, events=list(runner.events),
                dropped=runner.events.dropped,
                misses=runner.deadline_misses,
                stragglers=runner.timer.stragglers, ewma=runner.timer.ewma,
                heartbeat=beat, sleeps=sleeps, hooks=hooks)


@pytest.mark.parametrize('name', sorted(PROGRAMS))
def test_runner_trail_equals_reference(name, monkeypatch):
    got = _run_program(tfault, tsf, PROGRAMS[name], monkeypatch)
    want = _run_program(jfault, jsf, PROGRAMS[name], monkeypatch)
    assert got == want
    assert got['events']


def test_runner_defaults_equal_reference():
    assert tfault.FaultConfig() == tfault.FaultConfig(
        **vars(jfault.FaultConfig()))
    a, b = tfault.FaultTolerantRunner(), tfault.FaultTolerantRunner()
    assert a.cfg is not b.cfg
    for dts in ([1, 1, 9, 1, 2, 30, 1], [0.5] * 5 + [10, 0.1]):
        t, j = tfault.StepTimer(0.2, 3.0), jfault.StepTimer(0.2, 3.0)
        assert [t.observe(k, d) for k, d in enumerate(dts)] == \
            [j.observe(k, d) for k, d in enumerate(dts)]
        assert t.stragglers == j.stragglers and t.ewma == j.ewma


# ------------------------------------------------------------ the tracker
def _tracker_ops(seed: int, n_ops: int = 40):
    rng = np.random.RandomState(seed)
    step, ops = 0, []
    for _ in range(n_ops):
        step += int(rng.randint(0, 3))
        kind = rng.choice(['fail', 'heal', 'note_promote', 'note_reject',
                           'can_promote', 'best_rung'])
        if kind == 'fail':
            dom = None if rng.rand() < 0.5 else int(rng.randint(0, 3))
            ops.append(('fail', step, dom, int(rng.randint(1, 3))))
        elif kind == 'heal':
            ops.append(('heal', step, int(rng.randint(1, 3))))
        elif kind == 'best_rung':
            ops.append(('best_rung', int(rng.randint(0, 3)),
                        None if rng.rand() < 0.3 else step))
        else:
            ops.append((kind, step))
    return ops


def _replay_tracker(mod, ops, hysteresis):
    tr = mod.MeshHealthTracker(n_domains=3, hysteresis=hysteresis,
                               max_backoff=16)
    rungs = tuple(mod.Rung(b, need=n) for b, n in
                  (('a', 2), ('b', 1), ('c', 0)))
    trail = []
    for op in ops:
        if op[0] == 'fail':
            out = tr.fail(op[1], domain=op[2], n_dead=op[3])
        elif op[0] == 'heal':
            out = tr.heal(op[1], n_healed=op[2])
        elif op[0] == 'best_rung':
            out = tr.best_rung(rungs, current=op[1], step=op[2])
        else:
            out = getattr(tr, op[0])(op[1])
        trail.append((op, out, tr.healthy, tr.n_healthy, tr.backoff))
    return trail


@pytest.mark.parametrize('seed', range(6))
@pytest.mark.parametrize('hysteresis', [1, 3])
def test_tracker_trail_equals_reference(seed, hysteresis):
    ops = _tracker_ops(seed)
    assert _replay_tracker(trecovery, ops, hysteresis) == \
        _replay_tracker(jrecovery, ops, hysteresis)


def test_tracker_rejects_bad_arguments():
    with pytest.raises(ValueError):
        trecovery.MeshHealthTracker(n_domains=-1)
    with pytest.raises(ValueError):
        trecovery.MeshHealthTracker(n_domains=2, hysteresis=0)


# ------------------------------------------------------------- the ladder
@pytest.mark.parametrize('backend', tlstm.BACKENDS)
def test_ladder_moves_equal_reference(backend):
    ref = TO_REF[backend]
    down, up = jlstm.next_backend_down(ref), jlstm.next_backend_up(ref)
    assert tlstm.next_backend_down(backend) == fp.NAME_MAP.get(down)
    assert tlstm.next_backend_up(backend) == fp.NAME_MAP.get(up)


def test_ladder_is_the_reference_ladder_without_its_systolic_top():
    # named when the port lacked the systolic top rung; it now holds the
    # port to the reference's whole ladder, systolic top included
    assert tlstm.DEGRADATION_LADDER == tuple(
        fp.NAME_MAP[b] for b in jlstm.DEGRADATION_LADDER)
    for b in tlstm.DEGRADATION_LADDER[1:]:
        assert tlstm.next_backend_down(tlstm.next_backend_up(b)) == b
    assert tlstm.next_backend_up(tlstm.DEGRADATION_LADDER[0]) is None


@pytest.mark.parametrize('n_layers', [2, 3])
@pytest.mark.parametrize('backend', ['cuda_seq_fused_systolic',
                                     'cuda_seq_systolic', 'cuda_seq_fused',
                                     'cuda_seq', 'cuda_step', 'torch_scan'])
def test_build_rungs_equals_reference(backend, n_layers):
    got = trecovery.build_rungs(backend, n_layers=n_layers, n_h=32)
    want = jrecovery.build_rungs(TO_REF[backend], n_layers=n_layers, n_h=32)
    assert [(r.backend, r.n_dies, r.need, r.label()) for r in got] == \
        [(fp.NAME_MAP[r.backend], r.n_dies, r.need,
          fp.NAME_MAP[r.label()]) for r in want]
    with pytest.raises(ValueError):
        trecovery.build_rungs('auto', n_layers=n_layers, n_h=32)


# ---------------------------------------------- engine against reference
@pytest.mark.parametrize('name', sorted(CASES))
def test_engine_recovery_matches_reference_sync(reference, name):
    c = CASES[name]
    fp.assert_matches_reference(fp.run_port(c), reference(c))


def test_ring_bounds_engine_events_like_reference(reference):
    """A 2-event ring: the engine's log keeps the reference's newest two
    events and drops as many (the runner's ring holds wall-time
    ``straggler`` events, so only its bound is held)."""
    c = case('pallas_seq', ('flat', 2, 64), fail_at={1: 1},
             recover_at={3: 1}, promote_hysteresis=2, backoff_s=0.0,
             event_log_cap=2)
    eng = fp.make_engine(c)
    fp.drive(eng, c.make_utts(), ())
    jeng = fp.JEngine(fp.smoke()[0].replace(lstm_backend='pallas_seq'),
                      fp.smoke()[1], max_streams=2, chunk=8,
                      faults=fp.JFaultConfig(**dict(c.faults)))
    fp.drive(jeng, c.make_utts(), ())
    assert fp.normalize(eng.events) == fp.normalize(jeng.events)
    assert eng.events.dropped == jeng.events.dropped > 0
    assert eng.events[-1]['kind'] == 'promote'
    assert len(eng._runner.events) <= 2
    assert eng.stats()['events_dropped'] >= eng.events.dropped


# ----------------------------------------------------------- inside the port
@pytest.mark.parametrize('home', ['cuda_seq_fused', 'cuda_seq'])
def test_promote_roundtrip_bit_equal_sync_and_async(home):
    """fail -> degrade -> heal -> canary -> promote lands back on the home
    rung; on the CPU every rung gives the same bits, so every stream is
    bit-equal to an uninterrupted run, and async replays sync's trail."""
    c = CASES['promote_roundtrip']
    c = case(TO_REF[home], c.utts, **dict(c.faults))
    _, _, cfg, params = fp.smoke()
    base = StreamingEngine(cfg.replace(lstm_backend=home), params,
                           max_streams=2, chunk=8)
    ref, _ = fp.drive(base, c.make_utts(), ())
    runs = []
    for mode in (False, True):
        out, st = fp.run_port(c, async_dispatch=mode)
        for sid in ref:
            np.testing.assert_array_equal(ref[sid][0], out[sid][0])
        assert st['backend'] == home and st['rung'] == home
        trail = [k for k in fp.kinds(st['events'])
                 if k in ('degrade', 'heal', 'promote_canary', 'promote')]
        assert trail == ['degrade', 'heal', 'promote_canary', 'promote']
        runs.append((out, st))
    fp.assert_bit_equal(*runs)


@pytest.mark.timeout(600)
@settings(max_examples=8, deadline=None)
@given(ss.recovery_schedules())
def test_async_matches_sync_on_recovery_schedules(sched):
    """Fail -> recover -> fail schedules on the K2 home: both dispatch
    modes replay the same degrade / heal / canary / promote trail, end on
    the same rung, and give the same bits."""
    _, _, cfg, params = fp.smoke()
    utts = ss.make_utts(sched['lens'], cfg.lstm_inputs)
    runs = []
    for mode in (False, True):
        eng = StreamingEngine(
            cfg.replace(lstm_backend='cuda_seq_fused'), params,
            max_streams=3, chunk=8, async_dispatch=mode,
            faults=ServingFaultConfig(
                fail_at=dict(sched['fail_at']),
                recover_at=dict(sched['recover_at']),
                promote_hysteresis=sched['promote_hysteresis'],
                backoff_s=0.0))
        out = ss.run_schedule(eng, utts, sched)
        runs.append((out, eng.stats()))
    fp.assert_bit_equal(*runs)
    assert runs[0][1]['rung'] == runs[1][1]['rung']


def test_promotion_never_lands_mid_flight():
    c = CASES['promote_roundtrip']
    eng = fp.make_engine(c, async_dispatch=True)
    seen = []
    orig = eng._record

    def checked(kind, **info):
        if kind in ('promote_canary', 'promote', 'promote_rejected'):
            assert eng._pending is None, f'{kind} fired mid-flight'
            seen.append(kind)
        orig(kind, **info)

    eng._record = checked
    fp.drive(eng, c.make_utts(), ())
    assert 'promote' in seen


def test_rejected_canary_leaves_engine_untouched():
    """A forced canary mismatch: the engine stays on its degraded rung,
    its chunk call and states untouched by the shadow, the backoff doubles
    on every rejection, and every stream completes."""
    c = CASES['rejected_canary']
    eng = fp.make_engine(c)
    snaps = []
    real = eng._maybe_promote

    def watched():
        before = (eng._fwd, eng.backend, [t.clone() for t in
                                          leaves(eng.states)])
        n = len(eng.events)
        real()
        if any(e['kind'] == 'promote_rejected' for e in eng.events[n:]):
            snaps.append((before, (eng._fwd, eng.backend,
                                   leaves(eng.states))))

    eng._maybe_promote = watched
    out, st = fp.drive(eng, c.make_utts(), ())
    assert len(out) == 2 and st['backend'] == 'torch_scan'
    rejects = [e['backoff'] for e in st['events']
               if e['kind'] == 'promote_rejected']
    assert rejects[0] == 4 and rejects == sorted(rejects)
    assert snaps
    for (fwd, backend, states), (fwd2, backend2, states2) in snaps:
        assert fwd is fwd2 and backend == backend2
        assert all(torch.equal(a, b) for a, b in zip(states, states2))


def test_checkpoint_resume_across_promotion_boundary(tmp_path):
    """Rows checkpointed while DEGRADED resume bit-equal in a fresh engine
    that never degraded (on the CPU the rungs share their bits)."""
    _, _, cfg, params = fp.smoke()
    c = CASES['promote_roundtrip']
    utts = c.make_utts()
    home = cfg.replace(lstm_backend='cuda_seq')
    ref, _ = fp.drive(StreamingEngine(home, params, max_streams=2, chunk=8),
                      utts, ())
    eng = fp.make_engine(c, faults=dict(c.faults,
                                        checkpoint_dir=str(tmp_path)))
    for i, u in enumerate(utts):
        eng.submit(u, sid=i)
    for _ in range(3):
        eng.step()
    assert eng.backend == 'torch_scan'
    cursor = eng.preempt(0, requeue=False).cursor
    eng.run()
    assert eng.backend == 'cuda_seq'
    np.testing.assert_array_equal(ref[1][0],
                                  eng.sched.done[0].full_log_probs())
    fresh = StreamingEngine(home, params, max_streams=2, chunk=8,
                            faults=ServingFaultConfig(
                                checkpoint_dir=str(tmp_path)))
    resumed = fresh.resume_from_checkpoint(utts[0], sid=0)
    assert resumed.cursor == cursor > 0
    fresh.run()
    np.testing.assert_array_equal(ref[0][0][cursor:],
                                  resumed.full_log_probs())


def test_manifest_validates_across_placement_change(tmp_path):
    """A ``CheckpointManager`` manifest of the packed cache written while
    degraded restores, checksums validated, after the promotion."""
    c = CASES['promote_roundtrip']
    eng = fp.make_engine(c)
    for i, u in enumerate(c.make_utts()):
        eng.submit(u, sid=i)
    for _ in range(3):
        eng.step()
    assert eng.backend == 'torch_scan'
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, eng.states, blocking=True)
    saved = [t.clone() for t in leaves(eng.states)]
    eng.run()
    assert eng.backend == 'cuda_seq'
    restored = mgr.restore(eng.states, step=3, validate=True)
    for a, b in zip(saved, leaves(restored)):
        assert torch.equal(a, b)
