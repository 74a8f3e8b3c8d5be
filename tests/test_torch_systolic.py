"""Parity of the port's layerwise systolic scale-out (``core.systolic
.systolic_lstm_seq`` and its int8 form, the per-step baseline
``systolic_lstm_shard_map``), its mesh and admission, its dispatch and the
serving engine over a mesh, with the JAX reference.

The port's engines are CPU devices (``make_systolic_mesh(..., devices=
'cpu')``, one process driving them all); the reference's scale-outs run on
the same mesh shapes over 6 forced host devices, every case in one
subprocess (``tests/_torch_systolic_ref.py``).  Single-device references
(``lstm_layer``, ``systolic_layer_tiled``, ``systolic_layer_quantized``)
run in process.  Weights are seeded numpy, carried by ``repro_torch
.convert``.  Tolerances: f32 rtol 1e-5, atol 1e-6 (the reference's own);
gradients a relative Frobenius error of 1e-4; int8 and the port's own
bit-equality contracts ``torch.equal``; the engine 1e-4.
"""
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from _torch_fault_parity import NAME_MAP  # noqa: E402
from _torch_systolic_ref import (jax_stack, port_stack, put_stack,  # noqa: E402
                                 run_reference)
from repro import configs as jconfigs  # noqa: E402
from repro.core import lstm as jlstm  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import systolic as jsys  # noqa: E402
from repro.models import chipmunk_net as jnet  # noqa: E402
from repro.models import get_bundle  # noqa: E402
from repro.tune import schedule as jschedule  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (quantized_packed_from_numpy,  # noqa: E402
                                 stack_params_from_numpy)
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.core import systolic as tsys  # noqa: E402
from repro_torch.launch.mesh import (SYSTOLIC_TOPOLOGIES,  # noqa: E402
                                     install_systolic_topology,
                                     make_systolic_topology)
from repro_torch.models import chipmunk_net  # noqa: E402
from repro_torch.runtime import ServingFaultConfig  # noqa: E402
from repro_torch.serving import StreamingEngine  # noqa: E402
from repro_torch.tune.schedule import mesh_signature  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4
ENGINE_TOL = 1e-4
MESHES = ((2, 1), (1, 2), (2, 3))      # (rows, cols); 37 pads to 42 on 2x3
Q_MESHES = ((2, 1), (1, 2), (2, 2))    # divide the 4x4 int8 h-region grid
VALID = np.array([9, 4, 6])
Q_CHUNKS = ((0, 2), (2, 4), (4, 6))
Q_VALID = np.array([6, 3, 5])

REFERENCE = '''
p = layer('f.0'); xs = jnp.asarray(IN['f.xs'])
for rows, cols in MESHES:
    hs, (h_T, c_T) = systolic.systolic_lstm_seq(p, mesh(rows, cols), xs)
    OUT[f'f.{rows}x{cols}.hs'], OUT[f'f.{rows}x{cols}.c_T'] = hs, c_T
p = layer('w.0')
hs, (h_T, c_T) = systolic.systolic_lstm_seq(
    p, mesh(1, 2), jnp.asarray(IN['w.xs']), jnp.asarray(IN['w.h0']),
    jnp.asarray(IN['w.c0']))
OUT['w.hs'], OUT['w.c_T'] = hs, c_T
p = layer('g.0'); xs = jnp.asarray(IN['g.xs']); m = mesh(2, 1)
def loss(q):
    hs, (hT, cT) = systolic.systolic_lstm_seq(q, m, xs)
    return jnp.sum(hs ** 2) + jnp.sum(hT * cT)
for f, v in zip(p._fields, jax.grad(loss)(p)):
    OUT['g.' + f] = v
p = layer('f.0')
hs, (h_T, c_T) = systolic.systolic_lstm_seq(
    p, mesh(1, 2), jnp.asarray(IN['m.xs']), jnp.asarray(IN['m.h0']),
    jnp.asarray(IN['m.c0']), valid_len=jnp.asarray(IN['m.vl']))
OUT['m.hs'], OUT['m.h_T'], OUT['m.c_T'] = hs, h_T, c_T
qp = qstack('q', 1, 16)[0]
xs_q = quant.quantize(jnp.asarray(IN['q.xs']), quant.STATE_FMT)
OUT['q.xs_q'] = xs_q
for rows, cols in Q_MESHES:
    OUT[f'q.{rows}x{cols}'] = systolic.systolic_lstm_seq_quantized(
        qp, mesh(rows, cols), xs_q)
OUT['q.masked'], (OUT['q.h_q'], OUT['q.c_q']) = \
    systolic.systolic_lstm_seq_quantized(
        qp, mesh(2, 2), xs_q, valid_len=jnp.asarray(Q_VALID),
        return_state=True)
p = layer('s.0')
packed = systolic.pack_lstm(p, systolic.SystolicPlan(16, 32, 16))
OUT['s.hs'] = systolic.systolic_lstm_shard_map(packed, mesh(2, 3),
                                               jnp.asarray(IN['s.xs']))
'''


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _cpu_mesh(rows, cols, stage=1):
    return tsys.make_systolic_mesh(rows, cols, stage=stage, devices='cpu')


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    """Inputs, the port's weights, and every multi-device reference output
    from one subprocess."""
    rng = np.random.RandomState(0)
    inp = {}
    put_stack(inp, 'f', rng, 23, 37, 1)
    inp['f.xs'] = (rng.randn(7, 3, 23) * 0.5).astype(np.float32)
    put_stack(inp, 'w', rng, 123, 421, 1)
    inp['w.xs'] = (rng.randn(3, 2, 123) * 0.5).astype(np.float32)
    inp['w.h0'] = (rng.randn(2, 421) * 0.3).astype(np.float32)
    inp['w.c0'] = (rng.randn(2, 421) * 0.3).astype(np.float32)
    put_stack(inp, 'g', rng, 24, 32, 1)
    inp['g.xs'] = (rng.randn(5, 2, 24) * 0.5).astype(np.float32)
    inp['m.xs'] = (rng.randn(9, 3, 23) * 0.5).astype(np.float32)
    inp['m.h0'] = (rng.randn(3, 37) * 0.3).astype(np.float32)
    inp['m.c0'] = (rng.randn(3, 37) * 0.3).astype(np.float32)
    inp['m.vl'] = VALID.astype(np.int32)
    put_stack(inp, 'q', rng, 48, 64, 1)
    inp['q.xs'] = (rng.randn(6, 3, 48) * 0.5).astype(np.float32)
    put_stack(inp, 's', rng, 16, 32, 1)
    xs = np.zeros((4, 2, 48), np.float32)
    xs[..., :16] = rng.randn(4, 2, 16) * 0.5
    inp['s.xs'] = xs
    body = (f'MESHES, Q_MESHES = {MESHES!r}, {Q_MESHES!r}\n'
            f'Q_VALID = np.array({Q_VALID.tolist()!r})\n' + REFERENCE)
    ref = run_reference(body, inp, tmp_path_factory.mktemp('systolic'), 6)
    port = {k: port_stack(inp, k, 1).layers[0] for k in 'fwgqs'}
    return inp, port, ref


@pytest.fixture(autouse=True)
def no_mesh():
    """Every test starts and ends with no mesh installed in either
    package."""
    tsys.clear_mesh()
    jsys.clear_mesh()
    yield
    tsys.clear_mesh()
    jsys.clear_mesh()


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- the layerwise scale-out
@pytest.mark.parametrize('shape', MESHES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_scaleout_float_matches_reference_tiled_and_dense(case, shape):
    inp, port, ref = case
    xs = _t(inp['f.xs'])
    hs, (h_T, c_T) = tsys.systolic_lstm_seq(port['f'], _cpu_mesh(*shape), xs)
    key = f'f.{shape[0]}x{shape[1]}'
    _close(hs, ref[key + '.hs'])
    _close(c_T, ref[key + '.c_T'])
    jp = jax_stack(inp, 'f', 1).layers[0]
    hs_ref, (hT_ref, cT_ref) = jlstm.lstm_layer(jp, jnp.asarray(xs.numpy()))
    tiled = jsys.systolic_layer_tiled(
        jsys.pack_lstm(jp, jsys.SystolicPlan(23, 37, 16)),
        jnp.asarray(xs.numpy()))
    _close(hs, tiled)
    _close(hs, hs_ref)
    _close(h_T, hT_ref)
    _close(c_T, cT_ref)


def test_scaleout_nonzero_state_at_paper_width(case):
    inp, port, ref = case
    args = [_t(inp[k]) for k in ('w.xs', 'w.h0', 'w.c0')]
    hs, (_, c_T) = tsys.systolic_lstm_seq(port['w'], _cpu_mesh(1, 2), *args)
    _close(hs, ref['w.hs'])
    _close(c_T, ref['w.c_T'])
    jp = jax_stack(inp, 'w', 1).layers[0]
    hs_ref, (_, cT_ref) = jlstm.lstm_layer(
        jp, *(jnp.asarray(a.numpy()) for a in args))
    _close(hs, hs_ref)
    _close(c_T, cT_ref)


def test_scaleout_grad_matches_reference_and_scan(case):
    """The scale-out's gate-recompute backward (``systolic_seq_fused``)
    against the reference's ``jax.grad`` of its scale-out and the port's
    scan Function."""
    inp, port, ref = case
    xs = _t(inp['g.xs'])

    def grads(fn):
        q = tlstm.LSTMParams(*(t.clone().requires_grad_(True) for t in (
            port['g'].w_x, port['g'].w_h, port['g'].w_peep, port['g'].b)))
        hs, (h_T, c_T) = fn(q)
        ((hs ** 2).sum() + (h_T * c_T).sum()).backward()
        return {f: getattr(q, f).grad.numpy()
                for f in ('w_x', 'w_h', 'w_peep', 'b')}

    got = grads(lambda q: tsys.systolic_lstm_seq(q, _cpu_mesh(2, 1), xs))
    scan = grads(lambda q: tlstm.lstm_layer_fused(q, xs,
                                                  backend='torch_scan'))
    for f, g in got.items():
        assert _rel(g, ref['g.' + f]) <= GRAD_TOL, f
        assert _rel(g, scan[f]) <= GRAD_TOL, f


def test_scaleout_masked_chunk_matches_reference_and_is_the_unmasked(case):
    inp, port, ref = case
    xs, h0, c0 = (_t(inp[k]) for k in ('m.xs', 'm.h0', 'm.c0'))
    mesh = _cpu_mesh(1, 2)
    vl = _t(VALID)
    hs, (h_T, c_T) = tsys.systolic_lstm_seq(port['f'], mesh, xs, h0, c0,
                                            valid_len=vl)
    for got, key in ((hs, 'm.hs'), (h_T, 'm.h_T'), (c_T, 'm.c_T')):
        _close(got, ref[key])
    # an all-ones mask is the unmasked chain, bit for bit
    full = torch.full((3,), 9)
    a = tsys.systolic_lstm_seq(port['f'], mesh, xs, h0, c0, valid_len=full)
    b = tsys.systolic_lstm_seq(port['f'], mesh, xs, h0, c0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
    # chunked == monolithic on the masked path, bit for bit
    st, outs = (h0, c0), []
    for lo, hi in ((0, 4), (4, 7), (7, 9)):
        o, st = tsys.systolic_lstm_seq(
            port['f'], mesh, xs[lo:hi], *st,
            valid_len=torch.from_numpy(np.clip(VALID - lo, 0, hi - lo)))
        outs.append(o)
    for b_, n in enumerate(VALID):
        assert torch.equal(torch.cat(outs)[:n, b_], hs[:n, b_])
    assert torch.equal(st[0], h_T) and torch.equal(st[1], c_T)


@pytest.mark.parametrize('shape', Q_MESHES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_scaleout_quantized_bit_identical(case, shape):
    """int8 scale-out == the reference's scale-out == the silicon scan,
    bit for bit: the gathered hop replay keeps the chip's saturation
    order."""
    inp, _, ref = case
    jqp = jsys.quantize_packed(jsys.pack_lstm(
        jax_stack(inp, 'q', 1).layers[0], jsys.SystolicPlan(48, 64, 16)))
    qp = quantized_packed_from_numpy(jax.tree.map(np.asarray, jqp), 'cpu')
    xs_q = _t(ref['q.xs_q'])
    hs = tsys.systolic_lstm_seq_quantized(qp, _cpu_mesh(*shape), xs_q)
    assert hs.dtype == torch.int8
    np.testing.assert_array_equal(hs.numpy(), ref[f'q.{shape[0]}x{shape[1]}'])
    np.testing.assert_array_equal(hs.numpy(), np.asarray(
        jsys.systolic_layer_quantized(jqp, jnp.asarray(ref['q.xs_q']))))


def test_scaleout_quantized_chunk_carry_and_grid_rule(case):
    inp, _, ref = case
    jqp = jsys.quantize_packed(jsys.pack_lstm(
        jax_stack(inp, 'q', 1).layers[0], jsys.SystolicPlan(48, 64, 16)))
    qp = quantized_packed_from_numpy(jax.tree.map(np.asarray, jqp), 'cpu')
    xs_q, mesh, st, outs = _t(ref['q.xs_q']), _cpu_mesh(2, 2), None, []
    for lo, hi in Q_CHUNKS:
        vl = torch.from_numpy(np.clip(Q_VALID - lo, 0, hi - lo))
        o, st = tsys.systolic_lstm_seq_quantized(
            qp, mesh, xs_q[lo:hi], state=st, valid_len=vl, return_state=True)
        outs.append(o)
    np.testing.assert_array_equal(torch.cat(outs).numpy(), ref['q.masked'])
    np.testing.assert_array_equal(st[0].numpy(), ref['q.h_q'])
    np.testing.assert_array_equal(st[1].numpy(), ref['q.c_q'])
    # the staged state hands over to K3 (its plain version here)
    o1, st1 = tsys.systolic_lstm_seq_quantized(qp, mesh, xs_q[:3],
                                               return_state=True)
    o2 = tsys.systolic_lstm_seq_quantized(qp, None, xs_q[3:], state=st1)
    whole = tsys.systolic_lstm_seq_quantized(qp, mesh, xs_q)
    assert torch.equal(torch.cat([o1, o2]), whole)
    # an engine grid that does not divide the mesh is refused (R = 3 on 2)
    qp3 = tsys.quantize_packed(tsys.pack_lstm(
        port_stack(inp, 'f', 1).layers[0], tsys.SystolicPlan(23, 37, 16)))
    with pytest.raises(ValueError):
        tsys.systolic_lstm_seq_quantized(qp3, _cpu_mesh(2, 1),
                                         torch.zeros((3, 2, 23), dtype=torch.int8))


def test_per_step_baseline_matches_reference(case):
    inp, port, ref = case
    packed = tsys.pack_lstm(port['s'], tsys.SystolicPlan(16, 32, 16))
    mesh = _cpu_mesh(2, 3)
    hs = tsys.systolic_lstm_shard_map(packed, mesh, _t(inp['s.xs']))
    _close(hs, ref['s.hs'])
    placed = tsys.shard_packed_lstm(packed, mesh)
    assert torch.equal(tsys.systolic_lstm_shard_map(placed, mesh,
                                                    _t(inp['s.xs'])), hs)
    _close(hs, tsys.systolic_layer_tiled(packed, _t(inp['s.xs'][..., :16])))


def test_none_and_all_one_mesh_run_the_single_engine_kernels(case):
    inp, port, _ = case
    xs = _t(inp['g.xs'])
    want = tlstm.lstm_layer(port['g'], xs)
    for mesh in (None, _cpu_mesh(1, 1)):
        hs, (h_T, c_T) = tsys.systolic_lstm_seq(port['g'], mesh, xs)
        _close(hs, want[0].numpy())
        _close(c_T, want[1][1].numpy())
    jqp = jsys.quantize_packed(jsys.pack_lstm(
        jax_stack(inp, 'q', 1).layers[0], jsys.SystolicPlan(48, 64, 16)))
    qp = quantized_packed_from_numpy(jax.tree.map(np.asarray, jqp), 'cpu')
    xs_q = jquant.quantize(jnp.asarray(inp['q.xs']), jquant.STATE_FMT)
    got = tsys.systolic_lstm_seq_quantized(qp, None, _t(xs_q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jsys.systolic_layer_quantized(jqp, xs_q)))


# ------------------------------------------------------ mesh and admission
def test_mesh_construction_and_engine_order():
    m = tsys.make_systolic_mesh(2, 3, stage=2, devices='cpu')
    assert m.axis_names == ('stage', 'row', 'col')
    assert m.shape == {'stage': 2, 'row': 2, 'col': 3}
    assert list(m.shape) == ['stage', 'row', 'col']
    assert len(m.devices) == 12 and m.engine(1, 1, 2) == torch.device('cpu')
    devs = [torch.device('cpu')] * 7
    assert tsys.make_systolic_mesh(2, 3, devices=devs).devices == tuple(
        devs[:6])
    with pytest.raises(ValueError):
        tsys.make_systolic_mesh(2, 3, stage=2, devices=devs)
    # entry points default to the card: every engine on cuda
    assert all(d.type == 'cuda'
               for d in tsys.make_systolic_mesh(1, 2).devices)
    assert tsys.engine_budget(m) is None            # CPU engines: unbounded


def test_admission_rules():
    assert not tsys.seq_scaleout_admissible(421, None)
    # an all-1 mesh is the single-engine kernel's (rule 2)
    assert not tsys.seq_scaleout_admissible(421, _cpu_mesh(1, 1))
    mesh = _cpu_mesh(1, 2)
    assert tsys.seq_scaleout_admissible(421, mesh)
    # rule 3: a block that does not fit the budget is refused
    assert not tsys.seq_scaleout_admissible(1 << 14, mesh, budget=1 << 20)
    assert tsys.seq_scaleout_admissible(64, mesh, budget=1 << 20)
    # axis names must match; a live non-systolic axis is refused, and the
    # scale-out raises rather than misplace it
    other = types.SimpleNamespace(axis_names=('data', 'model'),
                                  shape={'data': 1, 'model': 2})
    assert not tsys.seq_scaleout_admissible(37, other)
    p = tlstm.init_lstm_params(23, 37, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        tsys.systolic_lstm_seq(p, other, torch.zeros((16, 3, 23)))
    # a live stage axis belongs to the staged rule
    assert not tsys.seq_scaleout_admissible(421, _cpu_mesh(1, 2, stage=2))


@pytest.mark.parametrize('name', sorted(SYSTOLIC_TOPOLOGIES))
def test_admission_equals_reference_on_each_preset(name):
    """Both forms of the rule against the reference's on a stand-in of the
    preset's mesh (its admission reads ``axis_names`` and ``shape`` only),
    at the paper's width and the smoke width, budget bounded and not."""
    s, r, c = SYSTOLIC_TOPOLOGIES[name]
    stand = types.SimpleNamespace(axis_names=('stage', 'row', 'col'),
                                  shape={'stage': s, 'row': r, 'col': c})
    mesh = make_systolic_topology(name, devices='cpu')
    for n_h in (32, 421, 1 << 12):
        for layers in (None, 2, 3):
            for budget in (None, 1 << 20):
                kw = dict(n_layers=layers, n_x=123, T=16, batch=8)
                want = jsys.seq_scaleout_admissible(
                    n_h, stand, vmem_budget=budget or (12 << 20), **kw)
                got = tsys.seq_scaleout_admissible(
                    n_h, mesh, budget=budget or (12 << 20), **kw)
                assert got == want, (n_h, layers, budget)


@pytest.mark.parametrize('name', sorted(SYSTOLIC_TOPOLOGIES))
def test_mesh_signature_equals_reference(name):
    s, r, c = SYSTOLIC_TOPOLOGIES[name]
    stand = types.SimpleNamespace(axis_names=('stage', 'row', 'col'),
                                  shape={'stage': s, 'row': r, 'col': c})
    assert mesh_signature(make_systolic_topology(name, devices='cpu')) == \
        jschedule.mesh_signature(stand) == f'stage:{s},row:{r},col:{c}'


# ---------------------------------------------------------------- dispatch
def _stacks():
    """(name, reference params, port params) of the stacks dispatch is
    held on: the smoke and full configs, a 3-layer homogeneous stack, and
    a heterogeneous one (the wavefront cannot take it)."""
    out = []
    for name, n_x, widths in (('smoke', 13, (32, 32)),
                              ('full', 123, (421, 421, 421)),
                              ('homog3', 32, (32, 32, 32)),
                              ('hetero', 13, (32, 24))):
        layers, n_in = [], n_x
        for n_h in widths:
            layers.append(jlstm.LSTMParams(
                jnp.zeros((4, n_h, n_in)), jnp.zeros((4, n_h, n_h)),
                jnp.zeros((3, n_h)), jnp.zeros((4, n_h))))
            n_in = n_h
        jp = jlstm.LSTMStackParams(tuple(layers), None, None)
        out.append((name, jp, stack_params_from_numpy(
            jax.tree.map(np.asarray, jp), 'cpu')))
    return out


@pytest.mark.parametrize('name', sorted(SYSTOLIC_TOPOLOGIES))
def test_auto_dispatch_names_the_reference_backend(name):
    s, r, c = SYSTOLIC_TOPOLOGIES[name]
    stand = types.SimpleNamespace(axis_names=('stage', 'row', 'col'),
                                  shape={'stage': s, 'row': r, 'col': c})
    install_systolic_topology(name, devices='cpu')
    jsys.install_mesh(stand)
    for label, jp, tp in _stacks():
        for T, B in ((4, 2), (8, 3), (16, 8)):
            want = NAME_MAP[jlstm.resolve_serving_backend(jp, 'auto', T, B)]
            got = tlstm.resolve_serving_backend(tp, 'auto', T, B, 'cpu')
            assert got == want, (label, T, B)


def test_layer_dispatch_follows_the_installed_mesh(case):
    inp, port, _ = case
    p = port['f']
    install_systolic_topology('1x2', devices='cpu')
    assert tlstm._layer_scales_out(37, 16)
    assert not tlstm._layer_scales_out(37, 4)        # T < _SEQ_MIN_T
    xs = torch.from_numpy(
        (np.random.RandomState(3).randn(16, 3, 23) * 0.5).astype(np.float32))
    hs, _ = tlstm.lstm_layer_fused(p, xs, backend='auto')
    want, _ = tlstm.lstm_layer_fused(p, xs, backend='torch_scan')
    _close(hs, want.numpy())
    # the staged backend on one layer is the layerwise scale-out here
    got = tlstm.lstm_layer_chunk(p, xs, valid_len=torch.full((3,), 16),
                                 backend='cuda_seq_fused_systolic')
    assert torch.equal(got[0], tsys.systolic_lstm_seq(
        p, tsys.current_mesh(), xs, valid_len=torch.full((3,), 16))[0])
    tsys.clear_mesh()
    assert tlstm._degrade_staged_single_layer(37) == 'cuda_seq'
    assert not tlstm._layer_scales_out(37, 16)


def test_ladder_from_the_systolic_top_is_the_reference_ladder():
    def walk(down, b):
        out = [b]
        while down(out[-1]) is not None:
            out.append(down(out[-1]))
        return out
    for ref in ('pallas_seq_fused_systolic', 'pallas_seq_systolic'):
        assert walk(tlstm.next_backend_down, NAME_MAP[ref]) == [
            NAME_MAP[b] for b in walk(jlstm.next_backend_down, ref)]


# ------------------------------------------------------- engine on a mesh
@pytest.fixture(scope='module')
def smoke():
    jcfg = jconfigs.get_smoke_config('chipmunk-ctc')
    jparams, _ = get_bundle(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = stack_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    rng = np.random.RandomState(2)
    utts = [(rng.randn(n, cfg.lstm_inputs) * 0.5).astype(np.float32)
            for n in (13, 7, 19, 4, 11)]
    return jcfg, jparams, cfg, params, utts


def _drain(cfg, params, utts, backend, **kw):
    eng = StreamingEngine(cfg.replace(lstm_backend=backend), params,
                          max_streams=3, chunk=8, **kw)
    sess = [eng.submit(u) for u in utts]
    eng.run()
    return eng, [s.full_log_probs() for s in sess]


def test_engine_on_a_staged_mesh_matches_scan_and_reference(smoke):
    jcfg, jparams, cfg, params, utts = smoke
    _, scan = _drain(cfg, params, utts, 'torch_scan')
    mesh = tsys.install_mesh(_cpu_mesh(1, 2, stage=2))
    eng, got = _drain(cfg, params, utts, 'auto')
    assert eng.backend == 'cuda_seq_fused_systolic'
    assert eng._home_mesh is mesh
    for g, s, u in zip(got, scan, utts):
        want = np.asarray(jnet.forward(jcfg, jparams,
                                       jnp.asarray(u[None])))[:, 0]
        np.testing.assert_allclose(g, s, rtol=ENGINE_TOL, atol=ENGINE_TOL)
        np.testing.assert_allclose(g, want, rtol=ENGINE_TOL, atol=ENGINE_TOL)


def test_engine_ladder_step_reinstalls_the_home_mesh(smoke, monkeypatch):
    """A permanent fault steps the systolic rung down to K2 (its plain
    version here) with the mesh cleared; the heal climbs back with the
    home mesh re-installed; every stream still matches the scan."""
    jcfg, jparams, cfg, params, utts = smoke
    _, scan = _drain(cfg, params, utts, 'torch_scan')
    mesh = tsys.install_mesh(_cpu_mesh(1, 2, stage=2))
    calls = []
    real = chipmunk_net.stream_forward

    def logged(c, *a, **k):
        calls.append((c.lstm_backend, tsys.current_mesh()))
        return real(c, *a, **k)

    monkeypatch.setattr(chipmunk_net, 'stream_forward', logged)
    faults = ServingFaultConfig(fail_at={1: 1}, recover_at={2: 1},
                                promote_hysteresis=1, canary=False,
                                backoff_s=0.0)
    eng, got = _drain(cfg, params, utts, 'auto', faults=faults)
    kinds = [(e['kind'], e.get('to_backend')) for e in eng.events
             if e['kind'] in ('degrade', 'promote')]
    assert kinds == [('degrade', 'cuda_seq_fused'),
                     ('promote', 'cuda_seq_fused_systolic')]
    assert ('cuda_seq_fused', None) in calls
    assert calls[-1] == ('cuda_seq_fused_systolic', mesh)
    assert all(m is mesh for b, m in calls if b.endswith('_systolic'))
    assert tsys.current_mesh() is mesh
    for g, s in zip(got, scan):
        np.testing.assert_allclose(g, s, rtol=ENGINE_TOL, atol=ENGINE_TOL)


def test_engine_chunk_calls_are_bound_to_the_home_placement(smoke,
                                                            monkeypatch):
    """The engine places its stack on the home mesh once: with the process
    registry cleared after construction (another engine's degrade, a
    caller's ``clear_mesh``) its chunks still run the staged scale-out on
    that placement, bit for bit as with the mesh installed, and place
    nothing per chunk."""
    jcfg, jparams, cfg, params, utts = smoke
    tsys.install_mesh(_cpu_mesh(1, 2, stage=2))
    _, want = _drain(cfg, params, utts, 'auto')
    eng = StreamingEngine(cfg.replace(lstm_backend='auto'), params,
                          max_streams=3, chunk=8)
    assert eng.backend == 'cuda_seq_fused_systolic'
    assert eng.placement.mesh is eng._home_mesh
    assert eng.placement.split == (1, 1)
    tsys.clear_mesh()
    placed, steps = [], []
    monkeypatch.setattr(tsys, '_place_layer',
                        lambda *a: placed.append(a) or None)
    real = tsys._f32_step
    monkeypatch.setattr(tsys, '_f32_step',
                        lambda *a: steps.append(a[1]) or real(*a))
    sess = [eng.submit(u) for u in utts]
    eng.run()
    assert not placed and set(steps) == {0, 1}
    for s, w in zip(sess, want):
        np.testing.assert_array_equal(s.full_log_probs(), w)
