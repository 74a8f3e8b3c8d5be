"""Parity of the port's die fault domains (``launch.mesh.DieMesh`` and its
presets, ``runtime.build_rungs``' die rungs, the serving engine's die
ladder and ``serve --die-topology``) with the JAX reference.

The reference's die meshes need several JAX devices, so every reference
case of this file runs in ONE subprocess with 4 host devices: the rung
lists of ``die-3x1x1`` and ``die-2x1x2``, and the two chaos schedules of
``tests/test_recovery.py`` on its SYNC engine (3 layers of the smoke
width, chunk 8, 2 streams of 88 and 96 frames).  The port's engines are
CPU devices and get the reference's weights through
``repro_torch.convert``.  Events are compared whole after the fault
harness's ``normalize``; streams allclose to the reference's engine at
rtol 1e-5, atol 1e-5 (R1: the reference's own engine differs from its
``forward`` by up to 2.4e-7).  Within the port, async == sync and a
schedule whose every rung keeps the 1x1 blocks is ``torch.equal`` to an
unfaulted drain.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import _torch_fault_parity as fp  # noqa: E402
from _subproc import run_with_devices  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import chipmunk_net as jnet  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.core import systolic as tsys  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.runtime import ServingFaultConfig, build_rungs  # noqa: E402
from repro_torch.serving import StreamingEngine  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5
CHUNK, SLOTS = 8, 2
# name -> (die preset, utterance seed, frames, faults): the reference's
# tests/test_recovery.py :404 (a die lost and healed: 3 -> 2 -> 3 dies)
# and :471 (the one-die rung is layerwise: the canary rejects, twice)
SCHEDULES = {
    'lose_heal_promote': ('die-3x1x1', 0, 88, dict(
        fail_at={2: {'n_dead': 1, 'domain': 2}}, recover_at={5: 1},
        promote_hysteresis=2, backoff_s=0.0)),
    'cross_class_reject': ('die-2x1x2', 1, 96, dict(
        fail_at={2: {'n_dead': 1, 'domain': 1}}, recover_at={5: 1},
        promote_hysteresis=2, backoff_s=0.0)),
}

REFERENCE = '''
import json
import numpy as np, jax
from repro import configs
from repro.launch import mesh as lmesh
from repro.models import chipmunk_net
from repro.runtime import ServingFaultConfig, build_rungs
from repro.serving import StreamingEngine

SCHEDULES = {schedules!r}
out, arrays = {{}}, {{}}
cfg = configs.get_smoke_config('chipmunk-ctc').replace(
    n_layers=3, lstm_backend='pallas_seq_fused_systolic')
params, _ = chipmunk_net.init(cfg, jax.random.PRNGKey(0))
for name in ('die-3x1x1', 'die-2x1x2'):
    dm = lmesh.make_die_topology(name)
    rungs = build_rungs(cfg.lstm_backend, n_layers=3, n_h=cfg.lstm_hidden,
                        die_mesh=dm, n_x=cfg.lstm_inputs, T={chunk},
                        batch={slots})
    full = dm.full_mesh()
    sub = dm.submesh([dm.dies - 1])
    ids = {{d: i for i, d in enumerate(jax.devices())}}
    out['rungs.' + name] = [[r.label(), r.need] for r in rungs]
    out['geometry.' + name] = dict(
        engines_per_die=dm.engines_per_die, n_engines=dm.n_engines,
        die_devices=[[ids[d] for d in dm.die_devices(k)]
                     for k in range(dm.dies)],
        full_axes=list(full.axis_names), full_shape=dict(full.shape),
        sub_shape=dict(sub.shape),
        sub_devices=[ids[d] for d in sub.devices.flat])
try:
    lmesh.make_die_topology('graves-3x25')
except ValueError as e:
    out['too_few'] = str(e)
for key, (preset, seed, frames, faults) in SCHEDULES.items():
    rng = np.random.default_rng(seed)
    utts = [rng.standard_normal((frames, cfg.lstm_inputs)).astype(
        np.float32) * 0.5 for _ in range(2)]
    lmesh.install_die_topology(preset)
    eng = StreamingEngine(cfg, params, max_streams={slots}, chunk={chunk},
                          faults=ServingFaultConfig(**faults))
    for i, u in enumerate(utts):
        eng.submit(u, sid=i)
    for s in eng.run():
        arrays[key + '.' + str(s.sid)] = s.full_log_probs()
    st = eng.stats()
    out[key] = dict(events=[{{k: v for k, v in e.items() if k != 'dt'}}
                            for e in st['events']],
                    rung=st['rung'], healthy=st['healthy_domains'],
                    counts=st['event_counts'])
np.savez({npz!r}, **arrays)
print('REF|' + json.dumps(out))
'''


@pytest.fixture(scope='module')
def ref(tmp_path_factory):
    """Every reference case of the file from one 4-device subprocess:
    (JSON results, stream log-probs by ``<schedule>.<sid>``)."""
    npz = tmp_path_factory.mktemp('die') / 'ref.npz'
    stdout = run_with_devices(REFERENCE.format(
        schedules=SCHEDULES, chunk=CHUNK, slots=SLOTS, npz=str(npz)),
        n_devices=4, timeout=600)
    line = next(l for l in stdout.splitlines() if l.startswith('REF|'))
    with np.load(npz) as f:
        return json.loads(line[4:]), {k: f[k] for k in f.files}


@pytest.fixture(scope='module')
def model():
    """The reference's 3-layer smoke weights, carried to the port (CPU)."""
    jcfg = jconfigs.get_smoke_config('chipmunk-ctc').replace(n_layers=3)
    jparams, _ = jnet.init(jcfg, jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config('chipmunk-ctc').replace(
        n_layers=3, lstm_backend='cuda_seq_fused_systolic')
    return cfg, stack_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        'cpu')


@pytest.fixture(autouse=True)
def no_mesh():
    tsys.clear_mesh()
    tmesh.clear_die_mesh()
    yield
    tsys.clear_mesh()
    tmesh.clear_die_mesh()


def _port_label(label: str) -> str:
    """A reference rung label under the port's backend names."""
    backend, at, dies = label.partition('@')
    return fp.NAME_MAP[backend] + at + dies


def _utts(cfg, seed, frames):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((frames, cfg.lstm_inputs)).astype(
        np.float32) * 0.5 for _ in range(2)]


def _drain(model, name, faults=None, async_mode=False):
    """The port's engine on schedule ``name``'s die preset (CPU engines),
    with ``faults`` (None: unfaulted).  Returns (engine, ({sid: (log-probs,
    errored)}, stats))."""
    cfg, params = model
    preset, seed, frames, _ = SCHEDULES[name]
    tmesh.install_die_topology(preset, devices='cpu')
    eng = StreamingEngine(cfg, params, max_streams=SLOTS, chunk=CHUNK,
                          async_dispatch=async_mode,
                          faults=None if faults is None
                          else ServingFaultConfig(**faults))
    return eng, fp.drive(eng, _utts(cfg, seed, frames), ())


# ------------------------------------------------------------ topology
@pytest.mark.parametrize('name', ['die-3x1x1', 'die-2x1x2'])
def test_die_mesh_geometry_equals_reference(ref, name):
    cpus = [torch.device('cpu', i) for i in range(4)]
    dm = tmesh.make_die_topology(name, devices=cpus)
    want = ref[0][f'geometry.{name}']
    full, sub = dm.full_mesh(), dm.submesh([dm.dies - 1])
    got = dict(engines_per_die=dm.engines_per_die, n_engines=dm.n_engines,
               die_devices=[[d.index for d in dm.die_devices(k)]
                            for k in range(dm.dies)],
               full_axes=list(full.axis_names), full_shape=full.shape,
               sub_shape=sub.shape, sub_devices=[d.index
                                                 for d in sub.devices])
    assert got == want
    assert tsys.seq_scaleout_admissible(32, full, n_layers=3) == \
        tsys.seq_scaleout_admissible(32, dm.submesh(range(dm.dies)),
                                     n_layers=3)
    with pytest.raises(ValueError):
        dm.submesh([])
    with pytest.raises(ValueError):
        dm.submesh([dm.dies])


def test_die_topology_needs_enough_devices(ref):
    with pytest.raises(ValueError) as e:
        tmesh.make_die_topology('graves-3x25', devices=['cpu'] * 4)
    assert str(e.value) == ref[0]['too_few']
    # None puts every engine on the card, one device puts them all there
    assert {d.type for d in tmesh.make_die_topology('graves-3x25')
            .devices} == {'cuda'}
    assert tmesh.make_die_topology('graves-3x25', devices='cpu').devices \
        == (torch.device('cpu'),) * 75


def test_install_current_clear_die_mesh():
    assert tmesh.current_die_mesh() is None
    dm = tmesh.install_die_topology('die-2x1x2', devices='cpu')
    assert tmesh.current_die_mesh() is dm
    assert tsys.current_mesh() == dm.submesh([0, 1])
    assert tsys.current_mesh().shape == {'stage': 2, 'row': 1, 'col': 2}
    tmesh.clear_die_mesh()
    assert tmesh.current_die_mesh() is None


@pytest.fixture
def h100_l2(monkeypatch):
    """A faked H100's 50 MiB L2 behind ``torch.cuda.get_device_properties``
    (engines on ``cuda`` are device objects only; nothing runs)."""
    class Props:
        L2_cache_size = 50 * 2 ** 20
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda d=None: Props())
    return Props.L2_cache_size


def test_graves_3x25_rungs_and_view_budget_at_full_width(h100_l2):
    """At 421 hidden every engine of ``graves-3x25`` on the card: the 4-axis
    view counts its engines per card as a ``SystolicMesh`` does (L2 / 75),
    and the ladder is 3d, 2d, the layerwise 1d rung, then the flat tail:
    233,580 B a 3d engine against 699,050, 467,160 (two layers) against
    1,048,576, and 117,980 (one layer) against 2,097,152."""
    dm = tmesh.make_die_topology('graves-3x25')
    full = dm.full_mesh()
    assert tsys.engine_budget(full) == h100_l2 // 75 == \
        tsys.engine_budget(dm.submesh(range(3))) == 699050
    assert tsys.engine_budget(dm.submesh([0, 2])) == 1048576
    assert tsys.seq_scaleout_admissible(421, full, n_layers=3, n_x=123,
                                        T=16, batch=8)
    assert not tsys.seq_scaleout_admissible(421, full, n_layers=3,
                                            budget=233579)
    rungs = build_rungs('cuda_seq_fused_systolic', n_layers=3, n_h=421,
                        die_mesh=dm, n_x=123, T=16, batch=8)
    assert [r.label() for r in rungs] == [
        'cuda_seq_fused_systolic@3d', 'cuda_seq_fused_systolic@2d',
        'cuda_seq_systolic@1d', 'cuda_seq_fused', 'cuda_seq', 'torch_scan']
    assert [r.need for r in rungs] == [3, 2, 1, 0, 0, 0]
    assert not tsys.seq_scaleout_admissible(421, dm.submesh([0, 1]),
                                            n_layers=3, budget=467159)
    assert not tsys.seq_scaleout_admissible(421, dm.submesh([0]),
                                            budget=117979)


# ------------------------------------------------------------ the ladder
@pytest.mark.parametrize('name', ['die-3x1x1', 'die-2x1x2'])
def test_build_rungs_die_presets_equal_reference(ref, model, name):
    cfg, _ = model
    dm = tmesh.make_die_topology(name, devices='cpu')
    rungs = build_rungs('cuda_seq_fused_systolic', n_layers=3,
                        n_h=cfg.lstm_hidden, die_mesh=dm, n_x=cfg.lstm_inputs,
                        T=CHUNK, batch=SLOTS)
    assert [[r.label(), r.need] for r in rungs] == [
        [_port_label(l), n] for l, n in ref[0][f'rungs.{name}']]
    # a flat home ignores the die mesh
    assert build_rungs('cuda_seq_fused', n_layers=3, n_h=cfg.lstm_hidden,
                       die_mesh=dm) == build_rungs(
        'cuda_seq_fused', n_layers=3, n_h=cfg.lstm_hidden)


# ------------------------------------------------------------ chaos schedules
@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_die_chaos_equals_reference(ref, model, name):
    """The port's sync engine under the reference's chaos schedule: the
    same events (backoffs included), rung and healthy dies, streams
    allclose to the reference's; on ``lose_heal_promote`` every stream is
    ``torch.equal`` to an unfaulted drain (every rung keeps the blocks),
    and on ``cross_class_reject`` the chunks before the fault are."""
    faults = SCHEDULES[name][3]
    eng, (out, stats) = _drain(model, name, faults)
    want = ref[0][name]
    assert fp.normalize(stats['events']) == fp.normalize(want['events'])
    assert stats['rung'] == _port_label(want['rung'])
    assert stats['healthy_domains'] == want['healthy']
    assert fp.untimed_counts(stats['event_counts']) == \
        fp.untimed_counts(want['counts'])
    _, (clean, _) = _drain(model, name)
    for sid, (lp, err) in out.items():
        assert not err
        np.testing.assert_allclose(lp, ref[1][f'{name}.{sid}'], rtol=RTOL,
                                   atol=ATOL)
        if name == 'lose_heal_promote':
            np.testing.assert_array_equal(lp, clean[sid][0])
        else:
            np.testing.assert_array_equal(lp[:2 * CHUNK],
                                          clean[sid][0][:2 * CHUNK])
    kinds = fp.kinds(stats['events'], skip=('fault',))
    if name == 'lose_heal_promote':
        assert kinds == ['degrade', 'heal', 'promote_canary', 'promote']
        deg = stats['events'][0]
        assert (deg['domain'], deg['to_backend']) == (
            2, 'cuda_seq_fused_systolic')
    else:
        assert stats['backend'] == 'cuda_seq_systolic'
        assert [e['backoff'] for e in stats['events']
                if e['kind'] == 'promote_rejected'] == [4, 8]


def _assert_async_equals_sync(sync, asyn):
    """Bit-equal streams and the same event trail and counts, the async
    engine's ``squash`` events and the timing-only ``straggler`` events
    aside (``fp.untimed_counts``)."""
    fp.assert_bit_equal(sync, asyn)
    assert fp.untimed_counts(sync[1]['event_counts'], ('squash',)) == \
        fp.untimed_counts(asyn[1]['event_counts'], ('squash',))


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_die_chaos_async_equals_sync(model, name):
    faults = SCHEDULES[name][3]
    _, sync = _drain(model, name, faults)
    _, asyn = _drain(model, name, faults, async_mode=True)
    _assert_async_equals_sync(sync, asyn)


def test_die_chaos_async_equals_sync_on_a_loaded_host(model, monkeypatch):
    """What a loaded host does to ``cross_class_reject``: a clock that
    jumps 10 s in the middle of the async drain makes one chunk 10 s long,
    and the runner logs a ``straggler`` in that run (so the counts,
    compared whole, would differ from sync's).  The streams, the trail and
    every other count are the same as sync's."""
    import time
    faults = SCHEDULES['cross_class_reject'][3]
    _, sync = _drain(model, 'cross_class_reject', faults)
    real, calls = time.time, [0]

    def counted():
        calls[0] += 1
        return real()

    monkeypatch.setattr(time, 'time', counted)
    _drain(model, 'cross_class_reject', faults, async_mode=True)
    jump_at, calls[0] = calls[0] // 2, 0

    def jumping():
        calls[0] += 1
        return real() + (10.0 if calls[0] > jump_at else 0.0)

    monkeypatch.setattr(time, 'time', jumping)
    _, asyn = _drain(model, 'cross_class_reject', faults, async_mode=True)
    monkeypatch.setattr(time, 'time', real)
    assert asyn[1]['event_counts'].get('straggler', 0) >= 1
    _assert_async_equals_sync(sync, asyn)


def test_die_rung_placement_built_once(model, monkeypatch):
    """Each die rung's placement is built the first time the rung runs and
    kept (keyed by backend and healthy dies); the home rung reuses the
    engine's own placement, so the 3 -> 2 -> 3 schedule places the stack
    twice, however many chunks and canary replays run."""
    built = []
    place = tengine.place_stack

    def counted(params, mesh, **kw):
        built.append((mesh.stage, kw['staged']))
        return place(params, mesh, **kw)

    monkeypatch.setattr(tengine, 'place_stack', counted)
    eng, (out, stats) = _drain(model, 'lose_heal_promote',
                               SCHEDULES['lose_heal_promote'][3])
    assert built == [(3, True), (2, True)]
    assert set(eng._placements) == {('cuda_seq_fused_systolic', (0, 1, 2)),
                                    ('cuda_seq_fused_systolic', (0, 1))}
    assert eng._placements[('cuda_seq_fused_systolic', (0, 1, 2))] \
        is eng.placement
    assert eng._placements[('cuda_seq_fused_systolic', (0, 1))].mesh.stage \
        == 2
    assert tsys.current_mesh() == tmesh.current_die_mesh().submesh(range(3))


def test_rejected_canary_keeps_the_incumbent_rung(model):
    """A rejected canary re-installs the incumbent's mesh (the one-die
    submesh) and leaves its placement in use; the candidate's placement is
    kept for the next attempt."""
    eng, (out, stats) = _drain(model, 'cross_class_reject',
                               SCHEDULES['cross_class_reject'][3])
    dm = tmesh.current_die_mesh()
    assert tsys.current_mesh() == dm.submesh([0])
    assert set(eng._placements) == {('cuda_seq_fused_systolic', (0, 1)),
                                    ('cuda_seq_systolic', (0,))}
    assert eng._placements[('cuda_seq_systolic', (0,))].split is None


def test_flat_home_under_a_die_mesh_keeps_the_flat_ladder(model):
    """A die mesh whose rungs do not start at the engine's backend (a K2
    home) leaves the ladder flat, as the reference rebuilds it."""
    cfg, params = model
    tmesh.install_die_topology('die-3x1x1', devices='cpu')
    eng = StreamingEngine(cfg.replace(lstm_backend='cuda_seq_fused'), params,
                          max_streams=SLOTS, chunk=CHUNK,
                          faults=ServingFaultConfig(backoff_s=0.0))
    assert [r.label() for r in eng._rungs] == ['cuda_seq_fused', 'cuda_seq',
                                               'torch_scan']
    assert eng.stats()['healthy_domains'] == [0, 1]


def test_serve_cli_die_topology(capsys):
    """``serve --die-topology`` on CPU engines with the fault flags: the
    reference's install line, a degrade onto the one-die rung's flat tail
    (``die-2x1x1``'s one-die mesh is an all-1 grid) and the canary-checked
    climb back to both dies."""
    stats = tserve.main(['--device', 'cpu', '--smoke', '--requests', '6',
                         '--slots', '2', '--chunk', '8', '--die-topology',
                         'die-2x1x1', '--fail-engines', '1@2',
                         '--recover-at-step', '1@5', '--promote-hysteresis',
                         '2'])
    text = capsys.readouterr().out
    assert 'installed die topology die-2x1x1: 2 dies x 1 engines ' \
           '(2x1x1x1)' in text
    assert 'degrade @step 2: cuda_seq_fused_systolic -> cuda_seq_fused' \
        in text
    assert stats['rung'] == 'cuda_seq_fused_systolic@2d'
    assert stats['event_counts'].get('promote') == 1
    assert stats['healthy_domains'] == [0, 1]
