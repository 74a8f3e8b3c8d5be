"""Parity of the port's staged systolic scale-out (``core.systolic
.systolic_lstm_stack_seq``, its int8 form, the geometry and schedule
helpers) and of ``core.pipeline`` with the JAX reference, and the staged
form's own bit-equality contracts.

The port's engines are CPU devices; the reference's staged scale-outs run
on the same (stage, row, col) shapes over 6 forced host devices, every case
in one subprocess (``tests/_torch_systolic_ref.py``).  The layerwise
composition (``lstm_stack_apply(backend='xla_scan')``) and the silicon
chain (``systolic_layer_quantized`` per layer) run in process.  Weights are
seeded numpy, carried by ``repro_torch.convert``.  Tolerances: f32 rtol
1e-5, atol 1e-6; gradients a relative Frobenius error of 1e-4; int8,
chunk depths, chunked == monolithic, masked == unmasked, uneven ==
balanced blocks and a placed stack == one placed per call ``torch.equal``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from _torch_systolic_ref import (jax_stack, port_stack, put_stack,  # noqa: E402
                                 run_reference)
from repro.core import lstm as jlstm  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import systolic as jsys  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.convert import quantized_packed_from_numpy  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import systolic as tsys  # noqa: E402
from repro_torch.kernels.lstm_seq import (lstm_stack_seq,  # noqa: E402
                                          lstm_stack_seq_quantized)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.tune import (ScheduleCache, ScheduleEntry,  # noqa: E402
                              using_schedule_cache)
from repro_torch.tune.schedule import mesh_signature  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
STAGED = ((2, 1, 2), (3, 2, 1))   # (stage, rows, cols); N_h 25 pads to 26
Q_STAGED = ((2, 1, 2), (3, 2, 1))              # divide the 2x2 grid
LENS = np.array([9, 5])
F_CHUNKS = ((0, 3), (3, 6), (6, 9))
Q_LENS = np.array([6, 3])
Q_CHUNKS = ((0, 2), (2, 4), (4, 6))

REFERENCE = '''
st = stack('a', 3); xs = jnp.asarray(IN['a.xs'])
for s, r, c in STAGED:
    ys, fin = systolic.systolic_lstm_stack_seq(st, mesh(r, c, s), xs,
                                               chunk=2)
    OUT[f'a.{s}{r}{c}.ys'] = ys
    OUT[f'a.{s}{r}{c}.c'] = jnp.stack([f[1] for f in fin])
st = stack('d', 3); xs = jnp.asarray(IN['d.xs']); m = mesh(1, 1, 2)
def loss(q):
    ys, fin = systolic.systolic_lstm_stack_seq(q, m, xs, chunk=2)
    return jnp.sum(ys ** 2) + sum(jnp.sum(h * c) for h, c in fin)
g = jax.grad(loss)(st)
for l, lg in enumerate(g.layers):
    for f, v in zip(lg._fields, lg):
        OUT[f'd.grad.{l}.{f}'] = v
st = stack('g', 5)
OUT['g.ys'] = systolic.systolic_lstm_stack_seq(
    st, mesh(2, 1, 3), jnp.asarray(IN['g.xs']), chunk=2)[0]
st = stack('a', 3)
systolic.install_mesh(mesh(1, 1, 2))
OUT['c.ys'], fin = lstm.lstm_stack_chunk(
    st, jnp.asarray(IN['c.xs']), None, valid_len=jnp.asarray(LENS),
    backend='pallas_seq_fused_systolic')
OUT['c.h'] = jnp.stack([f[0] for f in fin])
systolic.clear_mesh()
qps = qstack('q', 3, 16)
xs_q = quant.quantize(jnp.asarray(IN['q.xs']), quant.STATE_FMT)
OUT['q.xs_q'] = xs_q
OUT['q.212'] = systolic.systolic_lstm_stack_seq_quantized(
    qps, mesh(1, 2, 2), xs_q, chunk=2)
OUT['q.masked'], (OUT['q.h_q'], OUT['q.c_q']) = \
    systolic.systolic_lstm_stack_seq_quantized(
        qps, mesh(2, 1, 3), xs_q, valid_len=jnp.asarray(Q_LENS),
        return_state=True, chunk=1)
from repro.core import pipeline
layers = [layer('pp.' + str(l)) for l in range(3)]
packed, plan = pipeline.pack_pipeline(layers, 16)
OUT['pp.hs'] = pipeline.systolic_pipeline(packed, mesh(1, 2, 3),
                                          jnp.asarray(IN['pp.xs']))
'''


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cpu_mesh(rows, cols, stage=1):
    return tsys.make_systolic_mesh(rows, cols, stage=stage, devices='cpu')


def _key(shape):
    return ''.join(str(v) for v in shape)


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    """Inputs, the port's stacks, and every multi-device reference output
    from one subprocess."""
    rng = np.random.RandomState(1)
    inp = {}
    put_stack(inp, 'a', rng, 16, 25, 3)
    inp['a.xs'] = (rng.randn(7, 2, 16) * 0.5).astype(np.float32)
    put_stack(inp, 'd', rng, 16, 24, 3)
    inp['d.xs'] = (rng.randn(7, 2, 16) * 0.5).astype(np.float32)
    put_stack(inp, 'g', rng, 16, 24, 5)
    inp['g.xs'] = (rng.randn(8, 2, 16) * 0.5).astype(np.float32)
    inp['c.xs'] = (rng.randn(9, 2, 16) * 0.5).astype(np.float32)
    put_stack(inp, 'q', rng, 24, 32, 3)
    inp['q.xs'] = (rng.randn(6, 2, 24) * 0.5).astype(np.float32)
    put_stack(inp, 'pp', rng, 16, 16, 3)
    inp['pp.xs'] = (rng.randn(5, 2, 16) * 0.5).astype(np.float32)
    body = (f'STAGED = {STAGED!r}\nLENS = np.array({LENS.tolist()!r})\n'
            f'Q_LENS = np.array({Q_LENS.tolist()!r})\n' + REFERENCE)
    ref = run_reference(body, inp, tmp_path_factory.mktemp('staged'), 6)
    port = dict(a=port_stack(inp, 'a', 3), d=port_stack(inp, 'd', 3),
                g=port_stack(inp, 'g', 5), pp=port_stack(inp, 'pp', 3))
    jqps = [jsys.quantize_packed(jsys.pack_lstm(
        lp, jsys.SystolicPlan(lp.n_x, lp.n_h, 16)))
        for lp in jax_stack(inp, 'q', 3).layers]
    qps = [quantized_packed_from_numpy(jax.tree.map(np.asarray, q), 'cpu')
           for q in jqps]
    return inp, port, ref, jqps, qps


@pytest.fixture(autouse=True)
def no_mesh():
    tsys.clear_mesh()
    jsys.clear_mesh()
    yield
    tsys.clear_mesh()
    jsys.clear_mesh()


def _finals_equal(a, b):
    return all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
               for x, y in zip(a, b))


# --------------------------------------------------------------- f32 parity
@pytest.mark.parametrize('shape', STAGED, ids=_key)
def test_staged_matches_reference_and_layerwise(case, shape):
    inp, port, ref, _, _ = case
    s, r, c = shape
    xs = _t(inp['a.xs'])
    ys, fin = tsys.systolic_lstm_stack_seq(port['a'], _cpu_mesh(r, c, s),
                                           xs, chunk=2)
    _close(ys, ref[f'a.{_key(shape)}.ys'])
    _close(torch.stack([f[1] for f in fin]), ref[f'a.{_key(shape)}.c'])
    ys_ref, fin_ref = jlstm.lstm_stack_apply(
        jax_stack(inp, 'a', 3), jnp.asarray(inp['a.xs']), backend='xla_scan')
    _close(ys, ys_ref)
    for (h, c_), (jh, jc) in zip(fin, fin_ref):
        _close(h, jh)
        _close(c_, jc)


def test_staged_grads_match_reference(case):
    """The cross-layer gate-recompute backward through the stage boundary
    (``systolic_stack_seq_fused``) against the reference's ``jax.grad``."""
    inp, port, ref, _, _ = case
    xs = _t(inp['d.xs'])
    got = _grads(port['d'], lambda q: tsys.systolic_lstm_stack_seq(
        q, _cpu_mesh(1, 1, 2), xs, chunk=2))
    scan = _grads(port['d'], lambda q: tlstm.lstm_stack_apply(
        q, xs, backend='torch_scan'))
    for l, layer in enumerate(got):
        for f, g in layer.items():
            assert _rel(g, ref[f'd.grad.{l}.{f}']) <= GRAD_TOL, (l, f)
            assert _rel(g, scan[l][f]) <= GRAD_TOL, (l, f)


def _grads(params, fn):
    q = tlstm.LSTMStackParams(tuple(tlstm.LSTMParams(*(
        t.clone().requires_grad_(True) for t in (l.w_x, l.w_h, l.w_peep, l.b)))
        for l in params.layers), None, None)
    ys, fin = fn(q)
    loss = (ys ** 2).sum() + sum((h * c).sum() for h, c in fin)
    loss.backward()
    return [{f: getattr(l, f).grad.numpy() for f in ('w_x', 'w_h', 'w_peep',
                                                     'b')}
            for l in q.layers]


def test_graves75_scaled_uneven_blocks_match_reference(case):
    """5 layers over 3 stages of 2x1 grids: (2, 2, 1) blocks, so the
    pipeline runs a 2-layer and a 1-layer block."""
    inp, port, ref, _, _ = case
    assert tsys.stage_layer_blocks(5, 3) == ((0, 2), (2, 4), (4, 5))
    mesh = _cpu_mesh(2, 1, 3)
    xs = _t(inp['g.xs'])
    ys, _ = tsys.systolic_lstm_stack_seq(port['g'], mesh, xs, chunk=2)
    _close(ys, ref['g.ys'])
    _close(ys, jlstm.lstm_stack_apply(jax_stack(inp, 'g', 5),
                                      jnp.asarray(inp['g.xs']),
                                      backend='xla_scan')[0])


def test_staged_chunk_carry_matches_reference(case):
    """Chunked serving through ``lstm_stack_chunk`` on the staged backend:
    the chunks against the reference's masked call (allclose) and the
    port's (bit for bit)."""
    inp, port, ref, _, _ = case
    tsys.install_mesh(_cpu_mesh(1, 1, 2))
    xs, stt, outs = _t(inp['c.xs']), None, []
    for lo, hi in F_CHUNKS:
        vl = torch.from_numpy(np.clip(LENS - lo, 0, hi - lo))
        o, stt = tlstm.lstm_stack_chunk(port['a'], xs[lo:hi], stt,
                                        valid_len=vl,
                                        backend='cuda_seq_fused_systolic')
        outs.append(o)
    _close(torch.cat(outs), ref['c.ys'])
    _close(torch.stack([f[0] for f in stt]), ref['c.h'])
    mono, mono_fin = tlstm.lstm_stack_chunk(
        port['a'], xs, None, valid_len=torch.from_numpy(LENS),
        backend='cuda_seq_fused_systolic')
    assert torch.equal(torch.cat(outs), mono)
    assert _finals_equal(stt, mono_fin)


# ------------------------------------------------------------- int8 parity
@pytest.mark.parametrize('shape', Q_STAGED, ids=_key)
def test_staged_quantized_bit_identical(case, shape):
    """Against the silicon chain and K4 on live row and col axes (the
    reference's unmasked output on 2x(1x2))."""
    inp, _, ref, jqps, qps = case
    s, r, c = shape
    xs_q = _t(ref['q.xs_q'])
    h = jnp.asarray(ref['q.xs_q'])
    for q in jqps:
        h = jsys.systolic_layer_quantized(q, h)
    out = tsys.systolic_lstm_stack_seq_quantized(
        qps, _cpu_mesh(r, c, s), xs_q, chunk=2)
    assert out.dtype == torch.int8
    if shape == (2, 1, 2):
        np.testing.assert_array_equal(out.numpy(), ref['q.212'])
    np.testing.assert_array_equal(out.numpy(), np.asarray(h))
    # == K4 (its plain version here) on the same codes
    assert torch.equal(out, lstm_stack_seq_quantized(qps, xs_q))


def test_staged_quantized_chunk_carry_and_handoff(case):
    inp, _, ref, _, qps = case
    xs_q, mesh = _t(ref['q.xs_q']), _cpu_mesh(2, 1, 3)
    stt, outs = None, []
    for lo, hi in Q_CHUNKS:
        vl = torch.from_numpy(np.clip(Q_LENS - lo, 0, hi - lo))
        o, stt = tsys.systolic_lstm_stack_seq_quantized(
            qps, mesh, xs_q[lo:hi], state=stt, valid_len=vl,
            return_state=True, chunk=1)
        outs.append(o)
    np.testing.assert_array_equal(torch.cat(outs).numpy(), ref['q.masked'])
    np.testing.assert_array_equal(stt[0].numpy(), ref['q.h_q'])
    np.testing.assert_array_equal(stt[1].numpy(), ref['q.c_q'])
    # the staged state hands over to K4 mid-sequence
    whole = tsys.systolic_lstm_stack_seq_quantized(qps, mesh, xs_q)
    o1, st1 = tsys.systolic_lstm_stack_seq_quantized(
        qps, mesh, xs_q[:3], return_state=True, chunk=1)
    o2 = lstm_stack_seq_quantized(qps, xs_q[3:], state=st1)
    assert torch.equal(torch.cat([o1, o2]), whole)


# --------------------------------------------------------------- pipeline
def test_pipeline_matches_reference(case):
    inp, port, ref, _, _ = case
    packed, plan = tpipe.pack_pipeline(port['pp'].layers, 16)
    jpacked, jplan = jpipe.pack_pipeline(jax_stack(inp, 'pp', 3).layers, 16)
    assert (plan.n_x, plan.n_h, plan.tile) == (jplan.n_x, jplan.n_h,
                                               jplan.tile)
    np.testing.assert_array_equal(packed.tiles.numpy(),
                                  np.asarray(jpacked.tiles))
    mesh = _cpu_mesh(1, 2, 3)
    hs = tpipe.systolic_pipeline(packed, mesh, _t(inp['pp.xs']))
    _close(hs, ref['pp.hs'])
    placed = tpipe.shard_pipeline(packed, mesh)
    assert torch.equal(tpipe.systolic_pipeline(placed, mesh,
                                               _t(inp['pp.xs'])), hs)
    want = _t(inp['pp.xs'])
    for lp in port['pp'].layers:
        want = tlstm.lstm_layer(lp, want)[0]
    _close(hs, want.numpy())


# -------------------------------------------------- port-internal contracts
@pytest.mark.parametrize('chunk', [1, 2, 4])
def test_chunk_depths_bit_equal(case, chunk):
    """Forward, finals and gradients at chunks that divide T = 9 and chunks
    that leave a short last one, bit for bit against the one-chunk call,
    and allclose to the layerwise scan."""
    _, port, _, _, _ = case
    xs = torch.from_numpy(
        (np.random.RandomState(4).randn(9, 2, 16) * 0.5).astype(np.float32))
    mesh = _cpu_mesh(1, 1, 2)
    want, wfin = tsys.systolic_lstm_stack_seq(port['a'], mesh, xs, chunk=9)
    got, gfin = tsys.systolic_lstm_stack_seq(port['a'], mesh, xs,
                                             chunk=chunk)
    assert torch.equal(got, want) and _finals_equal(gfin, wfin)
    _close(got, tlstm.lstm_stack_apply(port['a'], xs,
                                       backend='torch_scan')[0].numpy())
    if chunk == 2:
        gw = _grads(port['a'], lambda q: tsys.systolic_lstm_stack_seq(
            q, mesh, xs, chunk=9))
        gc = _grads(port['a'], lambda q: tsys.systolic_lstm_stack_seq(
            q, mesh, xs, chunk=2))
        for a, b in zip(gw, gc):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f])


@pytest.mark.parametrize('backend', ['cuda_seq_fused_systolic',
                                     'cuda_seq_systolic'])
def test_placed_stack_serves_bit_equal_and_binds_its_mesh(case, backend,
                                                          monkeypatch):
    """A stack placed once (``place_stack``) serves masked chunks through
    ``lstm_stack_chunk`` bit for bit as calls that place per call, places
    nothing more, and runs on its own mesh with the registry cleared."""
    _, port, _, _, _ = case
    staged = backend == 'cuda_seq_fused_systolic'
    mesh = _cpu_mesh(1, 2, 2) if staged else _cpu_mesh(2, 2)
    xs = _t(case[0]['c.xs'])

    def serve(placement):
        stt, outs = None, []
        for lo, hi in F_CHUNKS:
            vl = torch.from_numpy(np.clip(LENS - lo, 0, hi - lo))
            o, stt = tlstm.lstm_stack_chunk(port['a'], xs[lo:hi], stt,
                                            valid_len=vl, backend=backend,
                                            placement=placement)
            outs.append(o)
        return torch.cat(outs), stt

    tsys.install_mesh(mesh)
    want, wfin = serve(None)
    placement = tsys.place_stack(port['a'], mesh, staged=staged)
    assert placement.split == ((2, 1) if staged else None)
    tsys.clear_mesh()
    placed, steps = [], []
    monkeypatch.setattr(tsys, '_place_layer',
                        lambda *a: placed.append(a) or None)
    real = tsys._f32_step
    monkeypatch.setattr(tsys, '_f32_step',
                        lambda *a: steps.append(a[1]) or real(*a))
    got, gfin = serve(placement)
    assert torch.equal(got, want) and _finals_equal(gfin, wfin)
    assert not placed and steps
    _close(got, tlstm.lstm_stack_chunk(
        port['a'], xs, None, valid_len=torch.from_numpy(LENS),
        backend='torch_scan')[0].numpy())
    with pytest.raises(ValueError):
        tsys.systolic_lstm_stack_seq(port['a'], _cpu_mesh(1, 2, 2), xs,
                                     placement=placement)


def test_chunk_depth_masks_and_blocks_are_schedule_only(case):
    """Chunk depths, an all-ones mask and an uneven stage split change
    nothing: bit for bit against the balanced unmasked call."""
    _, port, _, _, _ = case
    xs = torch.from_numpy(
        (np.random.RandomState(5).randn(9, 2, 16) * 0.5).astype(np.float32))
    mesh = _cpu_mesh(2, 1, 2)
    want, fin = tsys.systolic_lstm_stack_seq(port['a'], mesh, xs, chunk=2)
    for kw in (dict(chunk=9), dict(chunk=4), dict(chunk=2, blocks=(1, 2)),
               dict(chunk=3, blocks=(2, 1)),
               dict(chunk=2, valid_len=torch.full((2,), 9))):
        got, gfin = tsys.systolic_lstm_stack_seq(port['a'], mesh, xs, **kw)
        assert torch.equal(got, want) and _finals_equal(gfin, fin), kw
    # an empty trailing stage hands its chunk through
    got, _ = tsys.systolic_lstm_stack_seq(port['a'], _cpu_mesh(2, 1, 4), xs,
                                          chunk=2)
    assert torch.equal(got, want)


def test_none_mesh_runs_the_fused_stack(case):
    inp, port, _, _, _ = case
    xs = _t(inp['a.xs'])
    for mesh in (None, _cpu_mesh(1, 1)):
        ys, _ = tsys.systolic_lstm_stack_seq(port['a'], mesh, xs)
        assert torch.equal(ys, lstm_stack_seq(port['a'], xs)[0])
    with pytest.raises(ValueError):
        tsys.systolic_lstm_stack_seq(tlstm.LSTMStackParams(
            (port['a'].layers[0], port['d'].layers[1]), None, None),
            _cpu_mesh(1, 1, 2), xs)


def test_staged_admission_blocks_and_schedule():
    assert tsys.stage_layer_blocks(3, 3) == ((0, 1), (1, 2), (2, 3))
    assert tsys.stage_layer_blocks(3, 2) == ((0, 2), (2, 3))
    assert tsys.stage_layer_blocks(2, 3) == ((0, 1), (1, 2), (2, 2))
    assert tsys.stage_layer_blocks(3, 2, (1, 2)) == ((0, 1), (1, 3))
    for bad in ((3, 0), (0, 2)):
        with pytest.raises(ValueError):
            tsys.stage_layer_blocks(*bad)
    for blocks in ((1, 1), (2, -1, 2), (4, -1)):
        with pytest.raises(ValueError):
            tsys.stage_layer_blocks(3, len(blocks), blocks)
    for args in ((3, 16, 2, None), (3, 9, 3, 2), (5, 7, 3, 1), (3, 4, 2, 9)):
        assert tsys._staged_schedule(*args) == jsys._staged_schedule(*args)
    mesh = _cpu_mesh(1, 1, 2)
    assert tsys.seq_scaleout_admissible(24, mesh, n_layers=3)
    assert not tsys.seq_scaleout_admissible(24, mesh)          # layer form
    assert not tsys.seq_scaleout_admissible(24, mesh, n_layers=1)  # S > L
    assert not tsys.seq_scaleout_admissible(1 << 13, mesh, n_layers=3,
                                            budget=1 << 20)
    assert not tsys.seq_scaleout_admissible(421, None, n_layers=3)
    assert not tsys.seq_scaleout_admissible(421, _cpu_mesh(1, 1),
                                            n_layers=3)


def test_staged_schedule_consults_the_cache_by_mesh():
    mesh = _cpu_mesh(1, 1, 2)
    sig = mesh_signature(mesh)
    assert sig == 'stage:2,row:1,col:1'
    key = dict(n_x=16, n_h=24, n_layers=3, T=16, B=2)
    cache = ScheduleCache([ScheduleEntry('stack_f32', mesh=sig, tc=3,
                                         in_stage='sequential',
                                         blocks='1,2', **key)])
    kw = dict(n_h=24, n_x=16, batch=2, mesh=mesh)
    assert tsys.resolve_staged_chunk(3, 16, 2, **kw) == 2       # cold
    with using_schedule_cache(cache):
        assert tsys.resolve_staged_chunk(3, 16, 2, **kw) == 3
        assert tsys.resolve_staged_blocks(3, 16, 2, **kw) == (1, 2)
        other = _cpu_mesh(1, 2, 2)
        assert tsys.resolve_staged_chunk(3, 16, 2, n_h=24, n_x=16, batch=2,
                                         mesh=other) == 2
        assert tsys.resolve_staged_blocks(3, 16, 3, **kw) is None
    # a tuned uneven split sizes the bottleneck stage: on 3 stages the
    # balanced block is one layer, the cached (2, 1, 0) two
    three = _cpu_mesh(1, 1, 3)
    one_layer = 2 * 4 * 24 * 24 * 4 + 7 * 24 * 4
    adm = dict(n_layers=3, n_x=16, T=16, batch=2, budget=one_layer)
    assert tsys.seq_scaleout_admissible(24, three, **adm)
    split = ScheduleCache([ScheduleEntry(
        'stack_f32', mesh=mesh_signature(three), blocks='2,1,0', **key)])
    with using_schedule_cache(split):
        assert tsys.resolve_staged_blocks(3, 16, 3, n_h=24, n_x=16, batch=2,
                                          mesh=three) == (2, 1, 0)
        assert not tsys.seq_scaleout_admissible(24, three, **adm)


@pytest.mark.parametrize('name', sorted(tmesh.SYSTOLIC_TOPOLOGIES))
def test_topology_preset_geometry(name):
    assert tmesh.SYSTOLIC_TOPOLOGIES[name] == jmesh.SYSTOLIC_TOPOLOGIES[name]
    stage, rows, cols = tmesh.SYSTOLIC_TOPOLOGIES[name]
    mesh = tmesh.make_systolic_topology(name, devices='cpu')
    assert mesh.shape == {'stage': stage, 'row': rows, 'col': cols}
    assert len(mesh.devices) == stage * rows * cols
    # the CTC layer plan at tile 96 is the 5x7 grid; graves-75 is 3x(5x5)
    plan = tsys.SystolicPlan(123, 421, 96)
    assert tmesh.SYSTOLIC_TOPOLOGIES['5x7'] == (1, plan.rows, plan.cols)
    assert tmesh.SYSTOLIC_TOPOLOGIES['graves-75'] == (3, 5, 5)
    # at the paper's width every preset is admitted on unbounded engines,
    # but the all-1 one (rule 2), in the form its stage axis calls for
    admitted = (tsys.seq_scaleout_admissible(421, mesh, n_layers=3)
                if stage > 1 else tsys.seq_scaleout_admissible(421, mesh))
    assert admitted == (name != 'single')


def test_staged_auto_dispatch_under_an_installed_mesh(case):
    _, port, _, _, _ = case
    tsys.install_mesh(_cpu_mesh(1, 1, 2))
    assert tlstm.resolve_serving_backend(port['a'], 'auto', 16, 2, 'cpu') \
        == 'cuda_seq_fused_systolic'
    assert tlstm.resolve_serving_backend(port['a'], 'auto', 4, 2, 'cpu') \
        == 'torch_scan'
    xs = torch.from_numpy(
        (np.random.RandomState(6).randn(16, 2, 16) * 0.5).astype(np.float32))
    ys_a, _ = tlstm.lstm_stack_apply(port['a'], xs, backend='auto')
    ys_x, _ = tlstm.lstm_stack_apply(port['a'], xs, backend='torch_scan')
    _close(ys_a, ys_x.numpy())
    assert torch.equal(ys_a, tsys.systolic_lstm_stack_seq(
        port['a'], tsys.current_mesh(), xs)[0])
