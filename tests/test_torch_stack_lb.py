"""K2's layer block ``lb`` (the fused stack in groups of ``lb`` layers, one
launch a group) against the JAX reference's, on the CPU.

Inputs and weights are made with numpy from a seed; weights cross into the
port through ``repro_torch.convert``.  The reference's ``lstm_stack_seq``
runs its Pallas kernel in interpret mode at each ``lb``, as its own tests
run it; the port's wrapper runs its plain version on CPU tensors.  Tolerance
of the parity checks: rtol=1e-5, atol=1e-6 (the two frameworks sum the same
products in other orders).  Across ``lb`` the port gives the same bits,
forward and gradients (``torch.equal``).  The tuner's pieces (``_tuned_lb``,
``rank_lb_candidates``, ``tune_stack_lb``'s records) equal the reference's;
the candidate space follows the card's rule (shmoo deviation (d)), checked
at a 132-SM H100's numbers.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.core import lstm as jlstm  # noqa: E402
from repro.kernels.lstm_seq import lstm_stack_seq as j_stack_seq  # noqa: E402
from repro.kernels.lstm_seq import stack_ops as j_stack_ops  # noqa: E402
from repro.tune import autotune as j_autotune  # noqa: E402
from repro.tune import shmoo as j_shmoo  # noqa: E402
from repro_torch import op_cost  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.core.lstm import LSTMParams, LSTMStackParams  # noqa: E402
from repro_torch.kernels.lstm_seq import (lstm_stack_seq,  # noqa: E402
                                          stack_geometry, stack_ops)
from repro_torch.kernels.lstm_seq.kernel import (  # noqa: E402
    largest_batch, seq_launch_cost, seq_smem_bytes, seq_threads)
from repro_torch.kernels.lstm_seq.stack_kernel import (  # noqa: E402
    stack_launch_costs, stack_splits)
from repro_torch.tune import (ScheduleCache, ScheduleEntry,  # noqa: E402
                              clear_schedule_cache, enumerate_lb_candidates,
                              rank_lb_candidates, tune_stack_lb,
                              using_schedule_cache)
from repro_torch.tune.__main__ import main as tune_main  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
N_X, N_H, L, T, B = 12, 16, 4, 7, 4
LBS = (1, 2, 4)


@pytest.fixture(autouse=True)
def no_cache():
    """No schedule cache installed in either package, before or after."""
    clear_schedule_cache()
    jtune.clear_schedule_cache()
    yield
    clear_schedule_cache()
    jtune.clear_schedule_cache()


def _np_stack(seed):
    """A reference ``LSTMStackParams`` of numpy arrays, drawn from a seed."""
    rng = np.random.RandomState(seed)
    u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(s[-1])).astype(np.float32)
    layers = tuple(jlstm.LSTMParams(
        w_x=u(4, N_H, N_X if l == 0 else N_H), w_h=u(4, N_H, N_H),
        w_peep=(rng.uniform(-1, 1, (3, N_H)) * 0.1).astype(np.float32),
        b=(rng.randn(4, N_H) * 0.1).astype(np.float32))
        for l in range(L))
    return jlstm.LSTMStackParams(layers, None, None)


def _x(seed, *shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(np.float32)


def _inputs():
    """The reference stack, its port copy, frames, per-layer carries and
    ragged lengths (a full stream, an empty one and two partial)."""
    ref = _np_stack(5)
    states = [(_x(20 + l, B, N_H), _x(30 + l, B, N_H)) for l in range(L)]
    return (ref, stack_params_from_numpy(ref, 'cpu'), _x(6, T, B, N_X),
            states, np.array([T, 0, 3, 5]))


def _port_states(states):
    return [tuple(map(torch.from_numpy, s)) for s in states]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------ parity with the reference
@pytest.mark.parametrize('masked', [True, False], ids=['masked', 'unmasked'])
@pytest.mark.parametrize('lb', LBS)
def test_lstm_stack_seq_at_lb_matches_reference(lb, masked):
    """The port's ``lstm_stack_seq(lb=...)`` against the reference's at the
    same ``lb`` (Pallas interpret mode), from carried per-layer states,
    masked by ragged lengths or not; and the port's result is the same
    bits at every ``lb``."""
    ref, port, xs, states, lens = _inputs()
    vl = torch.from_numpy(lens) if masked else None
    ys, finals = lstm_stack_seq(port, torch.from_numpy(xs),
                                _port_states(states), valid_len=vl, lb=lb)
    jys, jfinals = j_stack_seq(
        jax.tree.map(jnp.asarray, ref), jnp.asarray(xs), states,
        valid_len=jnp.asarray(lens) if masked else None, lb=lb,
        interpret=True)
    _close(ys, jys)
    for (h, c), (jh, jc) in zip(finals, jfinals):
        _close(h, jh)
        _close(c, jc)
    ys_L, finals_L = lstm_stack_seq(port, torch.from_numpy(xs),
                                    _port_states(states), valid_len=vl)
    assert torch.equal(ys, ys_L)
    assert all(torch.equal(a, b) for f, g in zip(finals, finals_L)
               for a, b in zip(f, g))


def _leaves(port):
    """The port stack with fresh leaves that require grad."""
    layers = tuple(LSTMParams(*(getattr(lp, f.name).clone().requires_grad_()
                                for f in dataclasses.fields(LSTMParams)))
                   for lp in port.layers)
    return LSTMStackParams(layers, None, None)


def test_gradients_bit_equal_across_lb():
    """The unmasked autograd path (K2 forward, the gate-recompute
    backward): every gradient the same bits at every ``lb``."""
    _, port, xs, states, _ = _inputs()
    g = torch.Generator().manual_seed(3)
    d_ys = torch.randn((T, B, N_H), generator=g)
    d_fin = [torch.randn((2, B, N_H), generator=g) for _ in range(L)]
    grads = []
    for lb in LBS:
        p = _leaves(port)
        x = torch.from_numpy(xs).requires_grad_()
        ys, finals = lstm_stack_seq(p, x, _port_states(states), lb=lb)
        loss = (ys * d_ys).sum() + sum((h * d[0]).sum() + (c * d[1]).sum()
                                       for (h, c), d in zip(finals, d_fin))
        leaves = [x] + [getattr(lp, f.name) for lp in p.layers
                        for f in dataclasses.fields(LSTMParams)]
        grads.append(torch.autograd.grad(loss, leaves))
    for other in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], other))


def test_illegal_layer_block_raises():
    _, port, xs, _, _ = _inputs()
    for lb in (0, 3, 5):
        with pytest.raises(ValueError, match='not a layer block'):
            lstm_stack_seq(port, torch.from_numpy(xs), lb=lb)


# ------------------------------------------------------------ the tuner
def test_tuned_lb_equals_reference_on_caches_from_one_json(tmp_path):
    """``_tuned_lb`` on caches loaded from the same JSON in both packages:
    a legal entry, illegal ones (not a divisor, 0, deeper than the stack),
    a miss, and no cache."""
    key = dict(kind='stack_lb', n_x=N_X, n_h=N_H, n_layers=L, mesh='any')
    entries = [ScheduleEntry(T=T, B=B, lb=2, source='measured', **key),
               ScheduleEntry(T=T, B=8, lb=3, **key),
               ScheduleEntry(T=16, B=B, lb=0, **key),
               ScheduleEntry(T=32, B=B, lb=8, **key),
               ScheduleEntry(T=0, B=0, lb=4, **dict(key, n_layers=8))]
    path = ScheduleCache(entries).save(tmp_path / 'lb.json')
    port, ref = ScheduleCache.load(path), jtune.ScheduleCache.load(path)
    shapes = [(N_X, N_H, L, T, B), (N_X, N_H, L, T, 8), (N_X, N_H, L, 16, B),
              (N_X, N_H, L, 32, B), (N_X, N_H, 8, 5, 5), (N_X, N_H, 2, T, B)]
    want = [2, None, None, None, 4, None]
    assert [stack_ops._tuned_lb(*s) for s in shapes] == [None] * 6
    with using_schedule_cache(port), jtune.using_schedule_cache(ref):
        got = [stack_ops._tuned_lb(*s) for s in shapes]
        assert got == [j_stack_ops._tuned_lb(*s) for s in shapes] == want


def test_tuned_lb_fills_lb_none():
    """``lb=None`` takes the installed entry: the cost model then charges
    the launches that run (one a group)."""
    cache = ScheduleCache([ScheduleEntry(kind='stack_lb', n_x=13, n_h=32,
                                         n_layers=4, T=16, B=4, lb=1)])
    launches = lambda: op_cost.stack_launch_cost(
        'cuda_seq_fused', 13, 32, 4, 16, 4).kernels[
            'lstm_stack_seq_kernel']['launches']
    cold = op_cost.stack_launch_cost('cuda_seq_fused', 13, 32, 4, 16, 4)
    assert launches() == 1
    with using_schedule_cache(cache):
        assert launches() == 4
        tuned = op_cost.stack_launch_cost('cuda_seq_fused', 13, 32, 4, 16, 4)
    k = lambda r: r.kernels['lstm_stack_seq_kernel']
    # the same products; the groups above layer 0 read the h planes of
    # the layer below them (T x B x N_h f32) and the mask (T x B) as well
    assert k(tuned)['flops'] == k(cold)['flops']
    assert k(tuned)['bytes'] == k(cold)['bytes'] + 3 * (4 * 16 * 4 * 32
                                                        + 16 * 4)


def test_rank_lb_candidates_equal_reference():
    for cands, n_layers in (([1, 2, 4], 4), ([1, 3], 3), ([1], 5),
                            ([1, 2, 3], 6), ([1, 2, 3, 6], 6), ([], 2)):
        assert rank_lb_candidates(cands, n_layers) == \
            j_shmoo.rank_lb_candidates(cands, n_layers)


def test_enumerate_lb_candidates_card_rule():
    """On a 132-SM H100 the layer blocks whose group geometry admits one
    stream; off the card every divisor, which is the reference's space
    wherever its VMEM budget does not prune."""
    sm = lambda n_layers: enumerate_lb_candidates(123, 421, n_layers, 8,
                                                  sms=132)
    assert sm(3) == [1, 3]
    assert sm(4) == [1, 2, 4]
    assert sm(5) == [1]
    assert sm(6) == [1, 2, 3]
    assert enumerate_lb_candidates(123, 512, 3, 8, sms=132) == [1]
    assert j_shmoo.enumerate_lb_candidates(123, 421, 3, 8) == [1]
    for n_layers in (1, 2, 4, 6):
        assert enumerate_lb_candidates(N_X, N_H, n_layers, B) == \
            enumerate_lb_candidates(N_X, N_H, n_layers, B, device='cpu') == \
            j_shmoo.enumerate_lb_candidates(N_X, N_H, n_layers, B)


def test_layer_group_geometry_at_full_width():
    """A group of fewer layers takes fewer rows a CTA at the stack's K
    splits: larger batch blocks, and groups of stacks the card refuses
    whole; the cost of a whole-stack launch is the single launch's."""
    g1 = stack_geometry(421, 3, 8, 132, lb=1)
    assert (g1.rows, g1.ctas) == (4, 106) and g1.admissible(132)
    assert stack_geometry(421, 3, 8, 132) == stack_geometry(421, 3, 8, 132,
                                                            lb=3)
    assert stack_splits(421, 3, 132) == 1 and stack_splits(421, 1, 132) == 2
    # one K split a row (the 3-layer stack's), not the 4-row geometry's 2
    assert g1.smem_bytes == seq_smem_bytes(8, 421, 4, 2, 1)
    assert seq_threads(g1.rows, 1) == 32 * (1 + 4)
    biggest = lambda n_layers, lb: largest_batch(
        lambda b: stack_geometry(421, n_layers, b, 132, lb=lb), 200, 132)
    assert (biggest(3, 1), biggest(3, 3)) == (48, 24)
    assert [biggest(6, lb) for lb in (1, 2, 3, 6)] == [48, 32, 24, 0]
    whole = seq_launch_cost(16, 8, 421, 3, 5 * 4 * 421 * 421)
    assert stack_launch_costs(16, 8, 421, 3, 3) == [whole[:2]]
    groups = stack_launch_costs(16, 8, 421, 3, 1)
    assert len(groups) == 3 and groups[0] == seq_launch_cost(
        16, 8, 421, 1, 4 * 421 * 421)[:2]


def test_tune_stack_lb_predicted_equals_reference():
    """``measure=False``: the reference's entry field for field and its
    records' keys, suite and passes, wherever the reference's VMEM prune
    does not fire; deterministic."""
    for shape in ((N_X, N_H, L, T, B), (8, 16, 2, 8, 2), (8, 16, 3, 8, 2)):
        ent, recs = tune_stack_lb(*shape, measure=False, device='cpu')
        again, _ = tune_stack_lb(*shape, measure=False, device='cpu')
        jent, jrecs = j_autotune.tune_stack_lb(*shape, measure=False)
        assert ent == again
        assert dataclasses.asdict(ent) == dataclasses.asdict(jent)
        assert [(r.suite, r.params, r.metrics) for r in recs] == \
            [(r.suite, r.params, r.metrics) for r in jrecs]


def test_tune_stack_lb_measured_on_plain_versions():
    """A real interleaved trial on the plain versions: every candidate
    timed (bit-equal, asserted inside), the winner one of them, recorded
    in the cache."""
    cache = ScheduleCache()
    ent, recs = tune_stack_lb(N_X, N_H, L, T, B, cache=cache, iters=1,
                              device='cpu')
    assert [r.params['lb'] for r in recs] == [4, 2, 1]
    assert all(r.metrics['measured_us'] > 0 for r in recs)
    assert ent.source == 'measured' and ent.lb in LBS and ent.host
    assert cache.lookup('stack_lb', n_x=N_X, n_h=N_H, n_layers=L, T=T,
                        B=B) == ent


def test_cli_prints_stack_lb(tmp_path, capsys):
    out = tmp_path / 'sched.json'
    assert tune_main(['--device', 'cpu', '--out', str(out), '--n-x', '12',
                      '--n-h', '16', '--layers', '4', '--T', '7', '--B',
                      '4']) == 0
    text = capsys.readouterr().out
    assert re.search(r'^stack_lb -> lb=4 \(predicted\)$', text, re.M)
    ent = ScheduleCache.load(out).lookup('stack_lb', n_x=12, n_h=16,
                                         n_layers=4, T=7, B=4)
    assert ent.lb == 4 and ent.source == 'predicted'
