"""The port's measured-schedule layer (``repro_torch.tune``) against the
reference's (``repro.tune``), on the CPU.

Ports of ``tests/test_tune.py``'s contracts for the kinds this port tunes
(``q_stack_backend``, ``serving_chunk``), plus cross-package checks: the
repository's ``tuned_schedules.json`` loads in both packages with
byte-identical canonical JSON; the same caches give the same dispatch and
ceiling answers in both where ``n_x = n_h``; the one difference, R3 (the
reference looks its int8 entry up under ``n_x = n_h``, the port under the
stack's real ``n_x``), is shown on one cache; ``tune_quantized_backend(
measure=False)`` gives the reference's entry field for field (``host``
aside).  Measured trials run at tiny shapes on the plain versions.  No
tolerance applies: cache answers are exact, and the trials assert their
candidates bit-equal.  Every test starts and ends with no cache installed
in either package.
"""
import dataclasses
import json
import pathlib
import re
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from repro.core import lstm as jlstm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro import tune as jtune  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.kernels.lstm_seq import stack_ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import chipmunk_net  # noqa: E402
from repro_torch.serving import tuned_chunk_ceiling  # noqa: E402
from repro_torch.tune import (ANY_MESH, ScheduleCache, ScheduleEntry,  # noqa
                              ShmooRecord, clear_schedule_cache,
                              current_schedule_cache,
                              enumerate_lb_candidates, install_schedule_cache,
                              mesh_signature, replay_check, serving_depths,
                              tune_quantized_backend, tune_serving_config,
                              using_schedule_cache, write_shmoo_csv)
from repro_torch.tune.__main__ import main as tune_main  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CTC = types.SimpleNamespace(lstm_inputs=123, lstm_hidden=421, n_layers=3)


@pytest.fixture(autouse=True)
def no_cache():
    """No schedule cache installed in either package, before or after."""
    clear_schedule_cache()
    jtune.clear_schedule_cache()
    yield
    clear_schedule_cache()
    jtune.clear_schedule_cache()


class _Props:
    multi_processor_count = 132


@pytest.fixture
def h100(monkeypatch):
    """A CUDA device of 132 SMs, as far as dispatch asks."""
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda dev: _Props())
    return 'cuda'


def _cache(*entries):
    return ScheduleCache(entries)


def _both(*entries):
    """The same entries as a port cache and a reference cache."""
    return (ScheduleCache(entries),
            jtune.ScheduleCache(jtune.ScheduleEntry(**dataclasses.asdict(e))
                                for e in entries))


# ------------------------------------------------------------ cache basics
def test_cache_roundtrip_is_byte_identical():
    c = _cache(
        ScheduleEntry(kind='q_stack_backend', n_x=96, n_h=96, n_layers=3,
                      backend='fused', source='measured', measured_us=1.5),
        ScheduleEntry(kind='stack_f32', n_x=123, n_h=421, n_layers=3, T=128,
                      B=8, mesh='stage:2,row:5,col:5', tc=16,
                      in_stage='sequential', source='measured'))
    j1 = c.to_json()
    assert ScheduleCache.from_json(j1).to_json() == j1
    doc = json.loads(j1)
    assert doc['version'] == 1 and len(doc['entries']) == 2
    assert j1 == ScheduleCache(reversed(c.entries())).to_json()
    # the reference writes the same bytes for the same entries
    assert _both(*c.entries())[1].to_json() == j1


def test_committed_cache_loads_in_both_packages_byte_identical(tmp_path):
    path = REPO / 'tuned_schedules.json'
    port, ref = ScheduleCache.load(path), jtune.ScheduleCache.load(path)
    assert len(port) == len(ref) >= 2
    assert port.to_json() == ref.to_json()
    # a port save is a file the reference loads to the same bytes
    saved = port.save(tmp_path / 'c.json')
    assert jtune.ScheduleCache.load(saved).to_json() == port.to_json()


def test_lookup_precedence_exact_beats_wildcards():
    sig = 'stage:2,row:5,col:5'
    c = _cache(
        ScheduleEntry(kind='stack_f32', n_x=1, n_h=2, n_layers=3, T=0, B=0,
                      mesh=ANY_MESH, tc=4),
        ScheduleEntry(kind='stack_f32', n_x=1, n_h=2, n_layers=3, T=0, B=0,
                      mesh=sig, tc=8),
        ScheduleEntry(kind='stack_f32', n_x=1, n_h=2, n_layers=3, T=128,
                      B=0, mesh=sig, tc=16),
        ScheduleEntry(kind='stack_f32', n_x=1, n_h=2, n_layers=3, T=128,
                      B=8, mesh=sig, tc=32))
    q = dict(n_x=1, n_h=2, n_layers=3)
    assert c.lookup('stack_f32', T=128, B=8, mesh=sig, **q).tc == 32
    assert c.lookup('stack_f32', T=128, B=9, mesh=sig, **q).tc == 16
    assert c.lookup('stack_f32', T=64, B=8, mesh=sig, **q).tc == 8
    assert c.lookup('stack_f32', T=64, B=8, mesh='other', **q).tc == 4
    assert c.lookup('stack_f32', T=64, B=8, **q).tc == 4
    assert c.lookup('stack_int8', T=128, B=8, mesh=sig, **q) is None


def test_mesh_signature_forms():
    assert mesh_signature(None) == ANY_MESH
    assert mesh_signature('stage:2,row:5,col:5') == 'stage:2,row:5,col:5'
    with pytest.raises(TypeError):
        mesh_signature(object())


def test_registry_install_current_clear_and_scoped(tmp_path):
    assert current_schedule_cache() is None
    c = _cache()
    with using_schedule_cache(c) as got:
        assert got is c and current_schedule_cache() is c
    assert current_schedule_cache() is None
    path = _cache(ScheduleEntry(kind='serving_chunk', tc=4)).save(
        tmp_path / 'c.json')
    assert len(install_schedule_cache(path)) == 1
    clear_schedule_cache()
    assert current_schedule_cache() is None


# ----------------------------------------- dispatch is cache-first (pinned)
def test_q_fused_min_nh_decision_is_cache_driven():
    """At 96 hidden the cold rule says layerwise; a measured entry flips it
    to fused, a miss falls back to the rule, and removing the cache
    restores it."""
    sel = lambda n_h: tlstm.select_quantized_stack_backend(n_h, 3, 32, 4,
                                                           device='cpu')
    assert sel(96) == 'layerwise'
    c = _cache(ScheduleEntry(kind='q_stack_backend', n_x=96, n_h=96,
                             n_layers=3, backend='fused', source='measured'))
    with using_schedule_cache(c):
        assert sel(96) == 'fused'
        assert sel(512) == 'fused'
        assert sel(128) == 'layerwise'
    assert sel(96) == 'layerwise'


def test_q_structural_guards_not_overridable():
    c = _cache(ScheduleEntry(kind='q_stack_backend', n_x=96, n_h=96,
                             n_layers=1, backend='fused'),
               ScheduleEntry(kind='q_stack_backend', n_x=96, n_h=96,
                             n_layers=3, T=2, backend='fused'))
    with using_schedule_cache(c):
        for L, T in ((1, 32), (3, 2)):
            assert tlstm.select_quantized_stack_backend(
                96, L, T, 4, device='cpu') == 'layerwise'


def test_q_cache_cannot_force_an_inadmissible_fused_launch(h100):
    """On the card a fused entry past K4's single launch (B = 97 at N_h 421,
    tile 96) is not admissible: the chain runs; at B = 8 a layerwise entry
    beats the cold rule's fused."""
    key = dict(kind='q_stack_backend', n_x=123, n_h=421, n_layers=3, T=16)
    c = _cache(ScheduleEntry(B=97, backend='fused', **key),
               ScheduleEntry(B=8, backend='layerwise', **key))
    sel = lambda B: tlstm.select_quantized_stack_backend(
        421, 3, 16, B, n_x=123, device=h100, tile=96)
    assert sel(8) == 'fused' and sel(97) == 'layerwise'
    with using_schedule_cache(c):
        assert sel(8) == 'layerwise' and sel(97) == 'layerwise'


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_stack_backend_cache_respects_admission(device, h100):
    """``auto``'s ``stack_backend`` consult: an entry naming a backend the
    port lacks (the reference's ``pallas_seq_fused``) is ignored; a kernel
    entry serves only on CUDA; ``cuda_step`` is no masked serving backend
    there; ``torch_scan`` is honoured everywhere."""
    cfg = configs.get_config('chipmunk-ctc')
    params = chipmunk_net.init(cfg, device='cpu')
    resolve = lambda: tlstm.resolve_serving_backend(params, 'auto', 16, 8,
                                                    device)
    base = resolve()
    assert base == ('cuda_seq_fused' if device == 'cuda' else 'torch_scan')
    entry = lambda b: ScheduleEntry(kind='stack_backend', n_x=123, n_h=421,
                                    n_layers=3, backend=b)
    for name, want in (('pallas_seq_fused', base), ('cuda_step', base),
                       ('torch_scan', 'torch_scan'),
                       ('cuda_seq', 'cuda_seq' if device == 'cuda'
                        else base)):
        with using_schedule_cache(_cache(entry(name))):
            assert resolve() == want, name
    # keyed by the stack's real n_x: an entry under n_x = n_h misses
    c = _cache(ScheduleEntry(kind='stack_backend', n_x=421, n_h=421,
                             n_layers=3, backend='torch_scan'))
    with using_schedule_cache(c):
        assert resolve() == base


def test_serving_chunk_ceiling_is_cache_driven():
    assert tuned_chunk_ceiling(CTC, 16, 4) == 16
    c = _cache(ScheduleEntry(kind='stack_f32', n_x=123, n_h=421,
                             n_layers=3, tc=4, source='measured'))
    with using_schedule_cache(c):
        assert tuned_chunk_ceiling(CTC, 16, 4) == 4
        assert tuned_chunk_ceiling(CTC, 2, 4) == 2      # never grows chunk
    assert tuned_chunk_ceiling(CTC, 16, 4) == 16
    both = _cache(
        ScheduleEntry(kind='stack_f32', n_x=123, n_h=421, n_layers=3,
                      tc=4, source='measured'),
        ScheduleEntry(kind='serving_chunk', n_x=123, n_h=421, n_layers=3,
                      T=16, B=4, tc=8, source='measured'))
    with using_schedule_cache(both):
        assert tuned_chunk_ceiling(CTC, 16, 4) == 8
    degenerate = _cache(
        ScheduleEntry(kind='stack_f32', n_x=123, n_h=421, n_layers=3,
                      tc=4, source='measured'),
        ScheduleEntry(kind='serving_chunk', n_x=123, n_h=421, n_layers=3,
                      T=16, B=4, tc=0, source='measured'))
    with using_schedule_cache(degenerate):
        assert tuned_chunk_ceiling(CTC, 16, 4) == 4


# ------------------------------------- the same answers in both packages
_KEY = dict(n_layers=3)
_CACHES = {
    'empty': (),
    'q exact': (ScheduleEntry(kind='q_stack_backend', n_x=96, n_h=96, T=32,
                              B=4, backend='fused', **_KEY),),
    'q wildcards': (
        ScheduleEntry(kind='q_stack_backend', n_x=421, n_h=421,
                      backend='layerwise', **_KEY),
        ScheduleEntry(kind='q_stack_backend', n_x=96, n_h=96, T=32,
                      backend='fused', **_KEY)),
    'ceilings': (
        ScheduleEntry(kind='stack_f32', n_x=123, n_h=421, tc=4, **_KEY),
        ScheduleEntry(kind='serving_chunk', n_x=123, n_h=421, T=16, B=8,
                      tc=8, **_KEY),
        ScheduleEntry(kind='serving_chunk', n_x=123, n_h=421, T=32, B=0,
                      tc=0, **_KEY)),
    'committed': None,
}


@pytest.mark.parametrize('name', sorted(_CACHES))
def test_same_cache_same_answers_in_both_packages(name):
    """Where ``n_x = n_h``, the port's int8 dispatch (on the CPU) and the
    ceiling agree with the reference's on the same cache."""
    if _CACHES[name] is None:
        path = REPO / 'tuned_schedules.json'
        port, ref = ScheduleCache.load(path), jtune.ScheduleCache.load(path)
    else:
        port, ref = _both(*_CACHES[name])
    shapes = [(n_h, L, T, B) for n_h in (32, 96, 128, 256, 421)
              for L in (1, 2, 3) for T in (2, 8, 16, 32, 128)
              for B in (3, 4, 8)]
    with using_schedule_cache(port), jtune.using_schedule_cache(ref):
        for n_h, L, T, B in shapes:
            assert (tlstm.select_quantized_stack_backend(n_h, L, T, B,
                                                         device='cpu')
                    == jlstm.select_quantized_stack_backend(n_h, L, T, B)), \
                (n_h, L, T, B)
        for chunk in (2, 8, 16, 32):
            for slots in (4, 8):
                assert (tuned_chunk_ceiling(CTC, chunk, slots)
                        == jengine.tuned_chunk_ceiling(CTC, chunk, slots))


def test_r3_reference_misses_port_hits():
    """R3: one cache holding a layerwise entry keyed by the stack's real
    ``n_x`` (what both tuners write).  The reference's dispatch looks it up
    under ``n_x = n_h`` and misses (its cold rule: fused); the port's hits
    (layerwise).  Without ``n_x`` the port keys as the reference does."""
    port, ref = _both(ScheduleEntry(kind='q_stack_backend', n_x=123,
                                    n_h=421, n_layers=3, T=16, B=8,
                                    backend='layerwise', source='measured'))
    with using_schedule_cache(port), jtune.using_schedule_cache(ref):
        assert jlstm.select_quantized_stack_backend(421, 3, 16, 8) == 'fused'
        assert tlstm.select_quantized_stack_backend(
            421, 3, 16, 8, device='cpu') == 'fused'
        assert tlstm.select_quantized_stack_backend(
            421, 3, 16, 8, n_x=123, device='cpu') == 'layerwise'


def test_int8_auto_consults_the_cache_under_the_real_n_x(monkeypatch):
    """``lstm_stack_seq_quantized_auto`` on ``auto`` passes its stack's
    ``n_x``: a fused entry at (n_x 8, n_h 16) flips the cold rule's chain to
    the fused stack, and the codes do not change."""
    from repro_torch.core import quant, systolic as tsys
    stack = tlstm.init_lstm_stack(8, 16, 2, None,
                                  torch.Generator().manual_seed(0))
    qps = [tsys.quantize_packed(tsys.pack_lstm(lp, tsys.SystolicPlan(
        lp.n_x, 16, 8))) for lp in stack.layers]
    xq = quant.quantize(torch.randn((8, 2, 8), generator=torch.Generator()
                                    .manual_seed(1)))
    calls = []
    fused = stack_ops.lstm_stack_seq_quantized
    monkeypatch.setattr(stack_ops, 'lstm_stack_seq_quantized',
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    cold = stack_ops.lstm_stack_seq_quantized_auto(qps, xq)
    assert not calls
    c = _cache(ScheduleEntry(kind='q_stack_backend', n_x=8, n_h=16,
                             n_layers=2, T=8, B=2, backend='fused'))
    with using_schedule_cache(c):
        tuned = stack_ops.lstm_stack_seq_quantized_auto(qps, xq)
    assert calls == [1] and torch.equal(cold, tuned)


# ------------------------------------------------- predicted and replay
@pytest.mark.parametrize('shape', [(48, 96, 3, 32, 4), (8, 16, 2, 8, 2),
                                   (13, 32, 2, 8, 3), (96, 256, 2, 16, 2),
                                   (96, 256, 1, 16, 2), (96, 256, 3, 4, 2)])
def test_predicted_entry_matches_reference_field_for_field(shape):
    """``measure=False``: the cold rule's entry, the reference's field for
    field (``host`` aside) wherever the reference's VMEM prune does not
    fire; and deterministic."""
    e1, r1 = tune_quantized_backend(*shape, measure=False, device='cpu')
    e2, _ = tune_quantized_backend(*shape, measure=False, device='cpu')
    ref, _ = jtune.tune_quantized_backend(*shape, measure=False)
    assert e1 == e2 and r1 == []
    got, want = dataclasses.asdict(e1), dataclasses.asdict(ref)
    got.pop('host'), want.pop('host')
    assert got == want


def test_predicted_entry_on_the_card_prunes_inadmissible_fused(h100):
    """On the card the admission prune replaces the VMEM estimate: fused is
    predicted at the serving shape and pruned past K4's single launch."""
    sel = lambda B: tune_quantized_backend(123, 421, 3, 16, B, tile=96,
                                           measure=False, device=h100)[0]
    assert sel(8).backend == 'fused' and sel(97).backend == 'layerwise'
    assert sel(97).source == 'predicted'


def test_replay_check_accepts_committed_cache_and_catches_drift():
    """The committed cache's entries replay, except three predictions the
    port's rules re-derive otherwise, and the check says so: the
    reference's int8 prediction at 421 hidden (pruned to layerwise by its
    TPU VMEM estimate; the port's rule gives fused), its staged
    prediction in the ``'batched'`` in-stage order (the port runs one
    order, shmoo deviation (b)), and its layer block at 123 -> 3x421 (lb
    1 by the TPU's VMEM; K2's candidates are [1, 3] on the card and on
    the CPU, shmoo deviation (d), ranking 3 first).  The measured geometry
    and staged entries lie in the port's spaces; entries no space
    re-derives (a staged entry for any mesh) are reported as not
    checkable, never passed."""
    committed = ScheduleCache.load(REPO / 'tuned_schedules.json')
    vmem = [e for e in committed.entries() if e.kind == 'q_stack_backend'
            and e.source == 'predicted']
    assert [(e.n_h, e.backend) for e in vmem] == [(421, 'layerwise')]
    with pytest.raises(AssertionError, match='drifted'):
        replay_check(committed, device='cpu')
    batched = [e for e in committed.entries() if e.in_stage == 'batched'
               and e.mesh != ANY_MESH]
    assert [(e.kind, e.mesh) for e in batched] == [
        ('stack_f32', 'stage:2,row:2,col:2')]
    with pytest.raises(AssertionError, match='one order'):
        replay_check(_cache(*batched), device='cpu')
    lb = [e for e in committed.entries() if e.kind == 'stack_lb']
    assert [(e.n_x, e.n_h, e.n_layers, e.lb, e.source) for e in lb] == [
        (123, 421, 3, 1, 'predicted')]
    assert enumerate_lb_candidates(123, 421, 3, 8, sms=132) == [1, 3]
    with pytest.raises(AssertionError, match='layer block drifted: lb=3'):
        replay_check(_cache(*lb), device='cpu')
    rest = ScheduleCache(e for e in committed.entries()
                         if e not in vmem + batched + lb)
    checked, unchecked = replay_check(rest, device='cpu')
    assert checked == 5
    assert sorted({(e.kind, e.mesh) for e in unchecked}) == [
        ('stack_f32', ANY_MESH)]
    assert len(unchecked) == len(rest) - checked
    for bad in (ScheduleEntry(kind='serving_chunk', n_x=1, n_h=2,
                              n_layers=3, T=16, B=4, tc=12),
                ScheduleEntry(kind='q_stack_backend', n_x=1, n_h=2,
                              n_layers=3, backend='pallas_seq_fused'),
                ScheduleEntry(kind='q_stack_backend', n_x=48, n_h=96,
                              n_layers=3, T=32, B=4, backend='fused')):
        with pytest.raises(AssertionError):
            replay_check(_cache(bad), device='cpu')


def test_serving_depths_are_the_trial_grid():
    assert serving_depths(16) == (4, 8, 16)
    assert serving_depths(12) == (4, 8, 12)
    assert serving_depths(4) == (4,) and serving_depths(2) == (2,)
    assert serving_depths(0) == (4, 8, 16, 32, 64)


# ------------------------------------------------- shmoo records
def test_shmoo_csv_shared_format_and_ragged_rejection(tmp_path):
    recs = [ShmooRecord(suite='s', params={'a': 1}, metrics={'m': 2.0}),
            ShmooRecord(suite='s', params={'a': 2}, metrics={'m': 3.0})]
    p = write_shmoo_csv(tmp_path / 'x.csv', recs)
    lines = p.read_text().splitlines()
    assert lines[0] == 'suite,a,m' and lines[1] == 's,1,2.0000'
    # the reference's writer gives the same file
    jrecs = [jtune.ShmooRecord(r.suite, r.params, r.metrics) for r in recs]
    assert jtune.write_shmoo_csv(tmp_path / 'j.csv', jrecs).read_text() \
        == p.read_text()
    with pytest.raises(ValueError):
        write_shmoo_csv(tmp_path / 'y.csv', recs + [
            ShmooRecord(suite='s', params={'b': 1}, metrics={'m': 1.0})])


# ------------------------------------------------- measured trials (tiny)
def test_measured_quantized_trial_smoke():
    """A real interleaved trial on the plain versions: both candidates
    recorded at the given tile, bit-equal (asserted inside), the winner
    one of them."""
    ent, recs = tune_quantized_backend(8, 16, 2, 8, 2, tile=8, measure=True,
                                       iters=1, warmup=0, device='cpu')
    assert ent.backend in ('fused', 'layerwise')
    assert ent.source == 'measured' and ent.measured_us > 0
    assert ent.host.endswith('/cpux1')
    assert {r.params['backend'] for r in recs} == {'fused', 'layerwise'}
    assert {r.params['tile'] for r in recs} == {8}
    assert ent.measured_us == min(r.metrics['measured_us'] for r in recs)


def test_measured_serving_config_drives_dispatch():
    """``tune_serving_config`` on the smoke configuration: a measured int8
    entry at (chunk, slots) under the real n_x and a measured serving
    depth from the trial grid, both recorded; installed, the int8 dispatch
    and the deadline policy's ceiling follow them."""
    cfg = configs.get_smoke_config('chipmunk-ctc')
    cache = ScheduleCache()
    entries, records = tune_serving_config(cfg, chunk=8, slots=2,
                                           cache=cache, iters=1,
                                           device='cpu')
    q, staged, sc = entries
    assert (q.kind, q.source, q.n_x, q.n_h, q.T, q.B) == (
        'q_stack_backend', 'measured', 13, 32, 8, 2)
    assert (staged.kind, staged.source, staged.mesh, staged.T, staged.B,
            staged.in_stage) == ('stack_f32', 'predicted', ANY_MESH, 0, 2,
                                 'sequential')
    assert (sc.kind, sc.source) == ('serving_chunk', 'measured')
    assert sc.tc in serving_depths(8) and sc.measured_us > 0
    assert [r.params['tc'] for r in records
            if r.suite == 'serving_chunk'] == [4, 8]
    assert {r.params['tile'] for r in records
            if r.suite == 'q_stack_backend'} == {96}
    assert len(cache) == 3 and replay_check(cache, device='cpu') == (
        2, [staged])
    with using_schedule_cache(cache):
        assert tlstm.select_quantized_stack_backend(
            32, 2, 8, 2, n_x=13, device='cpu') == q.backend
        assert tuned_chunk_ceiling(cfg, 8, 2) == sc.tc
        policy = tserve.deadline_policy(cfg, 8, 2, 1.0)
        assert policy.chunk_max == sc.tc
    predicted, _ = tune_serving_config(cfg, chunk=8, slots=2, measure=False,
                                       device='cpu')
    assert [e.source for e in predicted] == ['predicted', 'predicted']


# ------------------------------------------------- the CLIs, under tmp_path
def test_tune_cli_writes_under_tmp_path(tmp_path, capsys):
    out, csv = tmp_path / 'sched.json', tmp_path / 'trial.csv'
    tiny = ['--n-x', '8', '--n-h', '16', '--layers', '2', '--T', '8',
            '--B', '2', '--tile', '8', '--device', 'cpu', '--out', str(out)]
    assert tune_main(tiny + ['--measure', '--iters', '1',
                             '--csv', str(csv)]) == 0
    # the int8 entry, the layer block and the staged prediction of the
    # 2x(2x2) placement
    assert len(ScheduleCache.load(out)) == 3
    assert csv.with_suffix('.q.csv').read_text().splitlines()[0] == (
        'suite,B,T,backend,n_h,n_layers,n_x,tile,measured_us,predicted_us')
    assert csv.read_text().splitlines()[0].startswith('suite,B,T,bk,bn,')
    # a second run at another shape refines the file, never forgets
    assert tune_main(tiny[:-2] + ['--out', str(out), '--T', '16']) == 0
    assert len(ScheduleCache.load(out)) == 6
    text = capsys.readouterr().out
    assert 'q_stack_backend -> ' in text and 'replay check: 6 entries' in text
    assert re.search(r'stack_lb -> lb=[12] \(measured; medians: lb=2 '
                     r'[0-9.]+ us, lb=1 [0-9.]+ us\)', text)
    assert 'stack_lb -> lb=2 (predicted)' in text
    with pytest.raises(SystemExit):
        tune_main(['--device', 'cpu', '--out',
                   str(REPO / 'tuned_schedules.json')])


def test_serve_cli_tunes_and_saves_the_schedule_cache(tmp_path, capsys):
    path = tmp_path / 'serve.json'
    argv = ['--device', 'cpu', '--smoke', '--requests', '3', '--slots', '2',
            '--chunk', '8', '--deadline-slo', '1.0',
            '--schedule-cache', str(path)]
    tserve.main(argv + ['--tune'])
    cache = ScheduleCache.load(path)
    sc = cache.lookup('serving_chunk', n_x=13, n_h=32, n_layers=2, T=8,
                      B=2)
    assert sc is not None and sc.source == 'measured'
    assert cache.lookup('q_stack_backend', n_x=13, n_h=32, n_layers=2, T=8,
                        B=2).source == 'measured'
    text = capsys.readouterr().out
    assert f'deadline slo: chunk_max={sc.tc} ' in text
    # a second run loads the saved cache and serves under it, no tuning
    clear_schedule_cache()
    tserve.main(argv)
    text = capsys.readouterr().out
    assert 'installed schedule cache: 3 entries' in text
    assert 'tuned ' not in text and f'chunk_max={sc.tc} ' in text
