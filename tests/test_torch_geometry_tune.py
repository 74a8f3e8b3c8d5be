"""The staged half of the port's tuner (``repro_torch.tune``: the staged
and geometry shmoo spaces, ``tune_staged_stack``, ``tune_geometry``, their
replay and CLI flags) against the reference's, on the CPU.

Enumerations, predicted us and rankings are pure functions, compared
exactly at the same per-engine budget (the reference's ``vmem_budget``;
the port's ``budget`` is the card's, shared by a candidate's engines,
shmoo deviation (a)) and filtered to the reference's ``'sequential'``
in-stage order (deviation (b)).  Deviation (c), the port's arithmetic
class ``(n_h_p, bk, bn)``, is shown on the geometries it splits.  Measured
trials run at tiny shapes with CPU engines and assert their class members
``torch.equal`` inside; the CLIs write under ``tmp_path``.  Every test
starts and ends with no cache installed in either package.
"""
import dataclasses
import types

import pytest
import torch

jax = pytest.importorskip('jax')

from repro import tune as jtune  # noqa: E402
from repro.tune import shmoo as jshmoo  # noqa: E402
from repro.tune.__main__ import main as jtune_main  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.core import systolic as tsys  # noqa: E402
from repro_torch.models import chipmunk_net  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.serving import StreamingEngine  # noqa: E402
from repro_torch.tune import (ScheduleCache, ScheduleEntry,  # noqa: E402
                              clear_schedule_cache, mesh_signature,
                              replay_check, tune_geometry, tune_serving_config,
                              tune_staged_stack, using_schedule_cache)
from repro_torch.tune import shmoo as tshmoo  # noqa: E402
from repro_torch.tune.__main__ import main as tune_main  # noqa: E402

BIG = 10 ** 18          # the reference's stand-in for an unbounded budget
# (n_x, n_h, L, T, B, stages, rows, cols) of the staged space
STAGED = ((48, 96, 3, 32, 4, 2, 2, 2), (123, 421, 3, 16, 8, 3, 5, 5),
          (16, 24, 5, 8, 2, 3, 1, 2), (8, 20, 2, 64, 2, 2, 3, 1))
# (n_x, n_h, L, T, B, devices) of the geometry space
GEOMETRY = ((48, 96, 3, 32, 4, 8), (123, 421, 3, 16, 8, 75),
            (16, 24, 4, 8, 2, 12))


@pytest.fixture(autouse=True)
def no_cache():
    clear_schedule_cache()
    jtune.clear_schedule_cache()
    yield
    clear_schedule_cache()
    jtune.clear_schedule_cache()


def _fields(c):
    return dataclasses.astuple(c)


def _sequential(cands):
    return [c for c in cands if c.in_stage == 'sequential']


def _stack(n_x, n_h, L, T, B, seed=7):
    stack = tlstm.init_lstm_stack(n_x, n_h, L, None,
                                  torch.Generator().manual_seed(seed))
    xs = torch.randn((T, B, n_x),
                     generator=torch.Generator().manual_seed(seed + 1)) * 0.5
    return stack, xs


# ------------------------------------------------------- the staged space
@pytest.mark.parametrize('shape', STAGED, ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('card', [None, 4 * 2 ** 20, 50 * 2 ** 20])
def test_staged_space_and_ranking_equal_reference(shape, card):
    n_x, n_h, L, T, B, S, R, C = shape
    got = tshmoo.enumerate_staged_candidates(n_x, n_h, L, T, B, stages=S,
                                             rows=R, cols=C, budget=card)
    per_engine = BIG if card is None else card // (S * R * C)
    want = _sequential(jshmoo.enumerate_staged_candidates(
        n_x, n_h, L, T, B, stages=S, rows=R, cols=C, vmem_budget=per_engine))
    assert [_fields(c) for c in got] == [_fields(c) for c in want]
    ranked = tshmoo.rank_staged_candidates(got, n_x, n_h, L, T)
    jranked = jshmoo.rank_staged_candidates(want, n_x, n_h, L, T)
    assert [(_fields(c), u) for c, u in ranked] == \
        [(_fields(c), u) for c, u in jranked]
    # the records: the reference's columns, ranked, sequential only
    recs = tshmoo.staged_shmoo_records(n_x, n_h, L, T, B, stages=S, rows=R,
                                       cols=C, budget=card)
    if card is None:
        jrecs = [r for r in jshmoo.staged_shmoo_records(
            n_x, n_h, L, T, B, stages=S, rows=R, cols=C)
            if r.params['in_stage'] == 'sequential']
        if len(jrecs) == len(recs):   # the reference's VMEM pruned nothing
            assert [(r.params, r.metrics) for r in recs] == \
                [(r.params, r.metrics) for r in jrecs]


def test_staged_space_prunes_past_stack_and_budget():
    assert tshmoo.enumerate_staged_candidates(8, 16, 2, 8, 2, stages=3,
                                              rows=1, cols=1) == []
    # 233,580 B a graves-75 engine: in at 75 x 233,580, out one byte less
    fits = 233580 * 75
    assert tshmoo.enumerate_staged_candidates(
        123, 421, 3, 16, 8, stages=3, rows=5, cols=5, budget=fits)
    assert not tshmoo.enumerate_staged_candidates(
        123, 421, 3, 16, 8, stages=3, rows=5, cols=5, budget=fits - 75)


# ------------------------------------------------------- the geometry space
@pytest.mark.parametrize('shape', GEOMETRY,
                         ids=lambda s: 'x'.join(map(str, s)))
def test_geometry_space_and_ranking_equal_reference(shape):
    n_x, n_h, L, T, B, dev = shape
    got = tshmoo.enumerate_geometry_candidates(n_x, n_h, L, T, B, devices=dev)
    want = _sequential(jshmoo.enumerate_geometry_candidates(
        n_x, n_h, L, T, B, devices=dev, vmem_budget=BIG))
    assert [_fields(c) for c in got] == [_fields(c) for c in want]
    ranked = tshmoo.rank_geometry_candidates(got, n_x, n_h, L, T)
    jranked = jshmoo.rank_geometry_candidates(want, n_x, n_h, L, T)
    assert [(_fields(c), u) for c, u in ranked] == \
        [(_fields(c), u) for c, u in jranked]
    assert [c.devices for c in got] == [c.devices for c in want]
    assert [c.lb for c in got] == [c.lb for c in want]


@pytest.mark.parametrize('card', [2 * 2 ** 20, 8 * 2 ** 20])
def test_geometry_space_at_a_card_budget_equals_reference_per_engines(card):
    """With a card's budget every candidate's engine gets ``card //
    engines``: per engine count, the port's space is the reference's at
    that per-engine ``vmem_budget``."""
    n_x, n_h, L, T, B, dev = 123, 421, 3, 16, 8, 75
    got = tshmoo.enumerate_geometry_candidates(n_x, n_h, L, T, B,
                                               devices=dev, budget=card)
    assert got != tshmoo.enumerate_geometry_candidates(n_x, n_h, L, T, B,
                                                       devices=dev)
    for n in sorted({c.devices for c in tshmoo.enumerate_geometry_candidates(
            n_x, n_h, L, T, B, devices=dev)}):
        want = [c for c in _sequential(jshmoo.enumerate_geometry_candidates(
            n_x, n_h, L, T, B, devices=dev, vmem_budget=card // n))
            if c.devices == n]
        assert [_fields(c) for c in got if c.devices == n] == \
            [_fields(c) for c in want]


@pytest.mark.parametrize('n_layers,n_stages', [(3, 2), (5, 3), (4, 4),
                                               (6, 1), (7, 3)])
def test_stage_splits_equal_reference(n_layers, n_stages):
    got = tshmoo._stage_splits(n_layers, n_stages)
    assert got == jshmoo._stage_splits(n_layers, n_stages)
    assert all(sum(s) == n_layers and min(s) >= 1 for s in got)
    assert tuple(hi - lo for lo, hi in tsys.stage_layer_blocks(
        n_layers, n_stages)) in got


def test_arith_signature_partitions_and_the_card_deviation():
    """The port's class is the reference's ``(n_h_p, bk)`` and ``bn``
    (deviation (c): on the card a row split changes the engines' product
    shape and the bits).  At 421 hidden in 75 engines the reference puts
    (S, 1, 5) with ``graves-75``'s (3, 5, 5); the port does not."""
    cands = tshmoo.enumerate_geometry_candidates(123, 421, 3, 16, 8,
                                                 devices=75)
    jcands = _sequential(jshmoo.enumerate_geometry_candidates(
        123, 421, 3, 16, 8, devices=75, vmem_budget=BIG))
    assert [c.arith_signature for c in cands] == \
        [j.arith_signature + (c.bn,) for c, j in zip(cands, jcands)]
    by = lambda s, r, c_: next(c for c in cands
                               if (c.stages, c.rows, c.cols) == (s, r, c_))
    graves = by(3, 5, 5)
    assert graves.arith_signature == (425, 85, 85)
    ref_class = {(c.stages, c.rows, c.cols) for c in cands
                 if c.arith_signature[:2] == graves.arith_signature[:2]}
    port_class = {(c.stages, c.rows, c.cols) for c in cands
                  if c.arith_signature == graves.arith_signature}
    assert ref_class == {(2, 1, 5), (3, 1, 5), (2, 5, 5), (3, 5, 5)}
    assert port_class == {(2, 5, 5), (3, 5, 5)}
    assert by(3, 1, 5).bn == 425


# ------------------------------------------------------- measured trials
def test_tune_staged_stack_measured_and_predicted():
    stack, xs = _stack(8, 16, 3, 16, 2)
    mesh = tsys.make_systolic_mesh(2, 2, stage=3, devices='cpu')
    cache = ScheduleCache()
    ent, recs = tune_staged_stack(stack, mesh, xs, cache=cache, iters=1,
                                  warmup=0)
    assert (ent.kind, ent.source, ent.mesh, ent.in_stage) == (
        'stack_f32', 'measured', 'stage:3,row:2,col:2', 'sequential')
    assert ent.tc in (4, 8, 16) and ent.measured_us > 0
    assert ent.host.endswith('/cpux1')
    assert [r.params['tc'] for r in recs] == [4, 8, 16]
    assert all(r.metrics['measured_us'] > 0 for r in recs)
    pred, precs = tune_staged_stack(stack, mesh, xs, measure=False)
    assert pred.source == 'predicted' and pred.tc == precs[0].params['tc']
    assert [r.params for r in precs] == [r.params for r in recs]
    with pytest.raises(ValueError):
        tune_staged_stack(stack, tsys.make_systolic_mesh(1, 1, stage=4,
                                                         devices='cpu'), xs)


def _geometry_trial(**kw):
    stack, xs = _stack(8, 20, 3, 8, 2)
    cache = ScheduleCache()
    ent, recs, base = tune_geometry(stack, xs, devices=8, ref=(2, 2, 2),
                                    cache=cache, iters=1, warmup=0, **kw)
    return stack, xs, cache, ent, recs, base


def test_tune_geometry_trials_the_reference_class_only():
    """The trial holds the balanced reference candidate and the predicted
    top of its class ``(20, 10, 10)``: (2, 1, 2) shares the reference's
    class (20, 10) but not the port's (its bn is 20), so it is timed only
    under ``allow_reassoc``."""
    _, _, cache, ent, recs, base = _geometry_trial()
    timed = {(r.params['stages'], r.params['rows'], r.params['cols'])
             for r in recs if r.metrics['measured_us'] > 0}
    assert timed and all((r, c) == (2, 2) for _, r, c in timed)
    assert base > 0 and ent.source == 'measured'
    assert ent.mesh == 'devices:8' and (ent.rows, ent.cols) == (2, 2)
    sub = cache.lookup('stack_f32', n_x=8, n_h=20, n_layers=3, T=8, B=2,
                       mesh=f'stage:{ent.stages},row:2,col:2')
    assert (sub.tc, sub.blocks, sub.source) == (ent.tc, ent.blocks,
                                                'measured')
    assert replay_check(cache, device='cpu') == (2, [])
    _, _, _, ent2, recs2, _ = _geometry_trial(allow_reassoc=True)
    timed2 = {(r.params['stages'], r.params['rows'], r.params['cols'])
              for r in recs2 if r.metrics['measured_us'] > 0}
    assert any((r, c) != (2, 2) for _, r, c in timed2)


def test_tuned_split_and_tc_reach_dispatch():
    """A measured geometry winner's schedule, installed, is what the
    winner's mesh runs: ``place_stack`` takes its split,
    ``resolve_staged_chunk`` its ``Tc``, and an engine on that mesh places
    the stack at that split."""
    stack, xs, cache, ent, _, _ = _geometry_trial()
    blocks = tuple(int(b) for b in ent.blocks.split(','))
    mesh = tsys.make_systolic_mesh(ent.rows, ent.cols, stage=ent.stages,
                                   devices='cpu')
    shape = dict(n_h=20, n_x=8, batch=2, mesh=mesh)
    with using_schedule_cache(cache):
        assert tsys.place_stack(stack, mesh, staged=True, T=8,
                                batch=2).split == blocks
        assert tsys.resolve_staged_chunk(3, 8, ent.stages, **shape) == ent.tc
        assert tsys.resolve_staged_blocks(3, 8, ent.stages, **shape) == blocks
    # a doctored split or depth is caught by the replay
    for bad in (dataclasses.replace(ent, stages=9),
                dataclasses.replace(ent, kind='stack_f32', tc=5,
                                    mesh=mesh_signature(mesh)),
                dataclasses.replace(ent, kind='stack_f32', in_stage='batched',
                                    mesh=mesh_signature(mesh))):
        with pytest.raises(AssertionError):
            replay_check(ScheduleCache([bad]), device='cpu')


def test_engine_takes_the_tuned_split_and_depth():
    cfg = configs.get_smoke_config('chipmunk-ctc').replace(
        n_layers=3, lstm_backend='auto')
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(0), 'cpu')
    mesh = tsys.make_systolic_mesh(2, 2, stage=2, devices='cpu')
    entry = ScheduleEntry(kind='stack_f32', n_x=cfg.lstm_inputs,
                          n_h=cfg.lstm_hidden, n_layers=3, T=8, B=2,
                          mesh=mesh_signature(mesh), tc=2, blocks='1,2',
                          in_stage='sequential', source='measured')
    tsys.install_mesh(mesh)
    try:
        with using_schedule_cache(ScheduleCache([entry])):
            eng = StreamingEngine(cfg, params, max_streams=2, chunk=8)
            assert eng.backend == 'cuda_seq_fused_systolic'
            assert eng.placement.split == (1, 2)
            assert tsys.resolve_staged_chunk(
                3, 8, 2, n_h=cfg.lstm_hidden, n_x=cfg.lstm_inputs, batch=2,
                mesh=mesh) == 2
    finally:
        tsys.clear_mesh()


def test_serving_config_staged_entry_equals_reference():
    """``tune_serving_config``'s predicted staged ``stack_f32`` entry is the
    reference's in the sequential order (the reference's winner may be
    ``'batched'``; then the port's is its best sequential candidate)."""
    cfg = configs.get_smoke_config('chipmunk-ctc')
    entries, _ = tune_serving_config(cfg, chunk=16, slots=2, measure=False,
                                     device='cpu')
    staged = entries[1]
    jc = _sequential(jshmoo.enumerate_staged_candidates(
        13, 32, 2, 16, 2, stages=2, rows=5, cols=5, vmem_budget=BIG))
    win, us = jshmoo.rank_staged_candidates(jc, 13, 32, 2, 16)[0]
    assert (staged.tc, staged.in_stage, staged.predicted_us, staged.T,
            staged.B, staged.mesh) == (win.tc, 'sequential', us, 0, 2, 'any')


# ------------------------------------------------------- the CLIs
def _csv_rows(path):
    lines = path.read_text().splitlines()
    col = lines[0].split(',').index('in_stage')
    return lines[0], [l for l in lines[1:]
                      if l.split(',')[col] == 'sequential']


@pytest.mark.parametrize('extra', [[], ['--geometry', '--devices', '12'],
                                   ['--n-h', '421', '--n-x', '123', '--T',
                                    '16', '--B', '8', '--stages', '3',
                                    '--rows', '5', '--cols', '5']],
                         ids=['staged', 'geometry', 'graves-75'])
def test_predicted_cli_replays_and_equals_reference(tmp_path, extra, capsys):
    """Predicted-only CLI runs: byte-identical files twice, and the shmoo
    CSV and the staged or geometry entry equal the reference CLI's (its
    CSV rows filtered to ``'sequential'``)."""
    outs = []
    for i in range(2):
        out, csv = tmp_path / f'p{i}.json', tmp_path / f'p{i}.csv'
        assert tune_main(['--device', 'cpu', '--out', str(out), '--csv',
                          str(csv)] + extra) == 0
        outs.append((out.read_bytes(), csv.read_bytes()))
    assert outs[0] == outs[1]
    jout, jcsv = tmp_path / 'j.json', tmp_path / 'j.csv'
    assert jtune_main(['--out', str(jout), '--csv', str(jcsv)] + extra) == 0
    assert _csv_rows(tmp_path / 'p0.csv') == _csv_rows(jcsv)
    kind = 'geometry' if '--geometry' in extra else 'stack_f32'
    port = [e for e in ScheduleCache.load(tmp_path / 'p0.json').entries()
            if e.kind == kind]
    ref = [e for e in jtune.ScheduleCache.load(jout).entries()
           if e.kind == kind]
    assert len(port) == len(ref) == 1
    if ref[0].in_stage == 'sequential':
        assert dataclasses.asdict(port[0]) == dataclasses.asdict(ref[0])
    capsys.readouterr()


def test_cli_over_budget_fails_fast_and_placements_skip(tmp_path, capsys):
    out = str(tmp_path / 'b.json')
    tiny = ['--device', 'cpu', '--out', out, '--n-x', '8', '--n-h', '16',
            '--T', '8', '--B', '2', '--iters', '1']
    with pytest.raises(SystemExit, match='needs 8 engines'):
        tune_main(tiny + ['--staged-devices', '4'])
    with pytest.raises(SystemExit, match='exceeds'):
        tune_main(tiny + ['--staged-devices', '4', '--geometry',
                          '--devices', '8'])
    with pytest.raises(SystemExit, match='reference placement over budget'):
        tune_main(tiny + ['--staged-devices', '6', '--geometry'])
    assert not (tmp_path / 'b.json').exists()
    assert tune_main(tiny + ['--staged-devices', '8', '--placements',
                             '2x2x2,3x2x2,2x1x2,4x1x1']) == 0
    captured = capsys.readouterr()
    assert 'skipping 3x(2x2)' in captured.err
    assert 'skipping 4x(1x1)' in captured.err
    cache = ScheduleCache.load(out)
    assert {e.mesh for e in cache.entries() if e.kind == 'stack_f32'} == {
        'stage:2,row:2,col:2', 'stage:2,row:1,col:2'}
    assert all(e.source == 'measured' for e in cache.entries()
               if e.kind == 'stack_f32')


def test_cli_measured_geometry_on_cpu_engines(tmp_path, capsys):
    out = tmp_path / 'g.json'
    assert tune_main(['--device', 'cpu', '--out', str(out), '--n-x', '8',
                      '--n-h', '20', '--T', '8', '--B', '2', '--iters', '1',
                      '--staged-devices', '8', '--geometry']) == 0
    text = capsys.readouterr().out
    assert 'balanced ref 2x(2x2)' in text and '(measured, ' in text
    kinds = sorted(e.kind for e in ScheduleCache.load(out).entries())
    assert kinds == ['geometry', 'q_stack_backend', 'stack_f32', 'stack_lb']
    assert replay_check(ScheduleCache.load(out), device='cpu')[1] == []


def test_card_budget_is_the_l2_on_cuda_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda d=None: types.SimpleNamespace(
                            L2_cache_size=50 * 2 ** 20))
    assert tshmoo.card_budget('cpu') is None
    assert tshmoo.card_budget('cuda') == 50 * 2 ** 20
