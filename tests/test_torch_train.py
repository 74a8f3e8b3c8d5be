"""The port's training path against the JAX reference on the CPU.

Inputs and weights are made with numpy from a seed and cross into the port
through ``repro_torch.convert``; the port's kernel backends run their plain
PyTorch versions on CPU tensors.  Tolerances, each per leaf:
- gradients of every backend's autograd Function against the reference's
  ``xla_scan`` custom VJP, and the train step's losses and parameters
  against the reference's jitted ``make_train_step``: rtol 1e-4, atol 1e-5
  (float32 sums in another order, through T-step recurrences, a reverse
  scan and AdamW's normalisation);
- ``ctc_loss`` values against JAX rtol 1e-5, gradients atol 1e-6, and
  against ``torch.nn.functional.ctc_loss`` rtol 1e-5 (one forward
  recursion, other summation orders);
- the optimizer against JAX rtol 1e-5, atol 1e-7 (elementwise float32).
The synthetic batches and checkpoint round trips are bit-exact.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.core import ctc as jctc  # noqa: E402
from repro.core import lstm as jlstm  # noqa: E402
from repro.data.pipeline import SyntheticCTC as JSyntheticCTC  # noqa: E402
from repro.launch.train import make_train_step as j_make_train_step  # noqa: E402
from repro.models import get_bundle  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import (stack_params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.core import ctc as tctc  # noqa: E402
from repro_torch.core import lstm as tlstm  # noqa: E402
from repro_torch.data import SyntheticCTC, source_for  # noqa: E402
from repro_torch.kernels.lstm_seq import lstm_seq_fused  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import chipmunk_net  # noqa: E402
from repro_torch.optim import (adamw, apply_updates,  # noqa: E402
                               clip_by_global_norm, cosine_schedule)
from repro_torch.tree import flatten_with_paths, leaves  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
N_X, N_H = 13, 32
KERNEL_BACKENDS = ('torch_scan', 'cuda_seq', 'cuda_step', 'cuda_seq_fused')


def _np_stack(seed, n_layers=2, n_out=None, n_x=N_X, n_h=N_H):
    rng = np.random.RandomState(seed)
    u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(s[-1])).astype(np.float32)
    layers = tuple(jlstm.LSTMParams(
        w_x=u(4, n_h, n_x if l == 0 else n_h), w_h=u(4, n_h, n_h),
        w_peep=(rng.uniform(-1, 1, (3, n_h)) * 0.1).astype(np.float32),
        b=(rng.randn(4, n_h) * 0.1).astype(np.float32))
        for l in range(n_layers))
    w_out = None if n_out is None else u(n_out, n_h)
    b_out = None if n_out is None else (rng.randn(n_out) * 0.1).astype(
        np.float32)
    return jlstm.LSTMStackParams(layers, w_out, b_out)


def _x(seed, *shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _port_leaves(port):
    return [t.requires_grad_(True) for t in leaves(port)]


# --------------------------------------------- autograd Functions vs JAX
@pytest.mark.parametrize('backend', KERNEL_BACKENDS)
def test_layer_grads_match_reference_scan_vjp(backend):
    ref = _np_stack(1, n_layers=1)
    xs, h0, c0 = _x(2, 5, 2, N_X), _x(3, 2, N_H), _x(4, 2, N_H)

    def jloss(params, h0, c0):
        hs, (h_T, c_T) = jlstm.lstm_layer_fused(params, jnp.asarray(xs), h0,
                                                c0, backend='xla_scan')
        return jnp.sum(hs ** 2) + jnp.sum(h_T * c_T)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, ref.layers[0]), h0, c0)
    port = stack_params_from_numpy(ref, 'cpu').layers[0]
    ps = _port_leaves(port)
    th0, tc0 = (torch.from_numpy(a).requires_grad_(True) for a in (h0, c0))
    hs, (h_T, c_T) = tlstm.lstm_layer_fused(port, torch.from_numpy(xs), th0,
                                            tc0, backend=backend)
    loss = (hs ** 2).sum() + (h_T * c_T).sum()
    loss.backward()
    _close(loss, jl)
    for name, p, g in zip(ref.layers[0]._fields, ps, jg[0]):
        _close(p.grad, g, msg=name)
    _close(th0.grad, jg[1], msg='h0')
    _close(tc0.grad, jg[2], msg='c0')


@pytest.mark.parametrize('backend', KERNEL_BACKENDS)
def test_stack_grads_match_reference(backend):
    """``lstm_stack_apply`` on every backend (the fused one through K2's
    cross-layer recompute) against the reference's ``xla_scan`` stack, with
    carried states and the read-out."""
    ref = _np_stack(5, n_layers=3, n_out=6)
    xs = _x(6, 6, 2, N_X)
    states = [(_x(10 + l, 2, N_H), _x(20 + l, 2, N_H)) for l in range(3)]

    def jloss(params, states):
        ys, fin = jlstm.lstm_stack_apply(params, jnp.asarray(xs), states,
                                         backend='xla_scan')
        return (jnp.sum(ys ** 2)
                + sum(jnp.sum(h * c) for h, c in fin))

    jl, (jgp, jgs) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, ref), states)
    port = stack_params_from_numpy(ref, 'cpu')
    ps = _port_leaves(port)
    ts = [tuple(torch.from_numpy(a).requires_grad_(True) for a in s)
          for s in states]
    ys, fin = tlstm.lstm_stack_apply(port, torch.from_numpy(xs), ts,
                                     backend=backend)
    loss = (ys ** 2).sum() + sum((h * c).sum() for h, c in fin)
    loss.backward()
    _close(loss, jl)
    for (path, _), p, g in zip(flatten_with_paths(port), ps,
                               jax.tree.leaves(jgp)):
        _close(p.grad, g, msg=path)
    for (th, tc), (gh, gc) in zip(ts, jgs):
        _close(th.grad, gh)
        _close(tc.grad, gc)


def test_stack_recompute_backward_matches_reference():
    """The cross-layer recompute itself, on random cotangents: the port's
    stack layout has no zero ``w_in`` for layer 0."""
    L, T, B = 3, 4, 2
    rng = np.random.RandomState(7)
    f = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    w_in, w_h = f(L - 1, 4, N_H, N_H), f(L, 4, N_H, N_H)
    peep, b, pre = f(L, 3, N_H), f(L, 4, N_H), f(T, B, 4, N_H)
    h0s, c0s = f(L, B, N_H), f(L, B, N_H)
    hs, cs = np.tanh(f(L, T, B, N_H)), f(L, T, B, N_H)
    grads = (f(T, B, N_H), (f(L, B, N_H), f(L, B, N_H)))
    j_w_in = np.concatenate([np.zeros_like(w_in[:1]), w_in])
    want = jlstm.lstm_stack_bwd_recompute_gates(
        j_w_in, w_h, peep, b, pre, hs, cs, h0s, c0s, grads)
    t = torch.from_numpy
    got = tlstm.lstm_stack_bwd_recompute_gates(
        t(w_in), t(w_h), t(peep), t(b), t(pre), t(hs), t(cs), t(h0s),
        t(c0s), (t(grads[0]), (t(grads[1][0]), t(grads[1][1]))))
    _close(got[0], np.asarray(want[0])[1:], msg='dw_in')
    for name, g, w in zip(('dw_h', 'd_peep', 'db', 'd_pre_x0', 'dh0s',
                           'dc0s'), got[1:], want[1:]):
        _close(g, w, msg=name)


@pytest.mark.parametrize('backend', ['torch_scan', 'cuda_seq'])
def test_gradcheck_float64(backend):
    """``torch.autograd.gradcheck`` on a tiny layer: the scan Function
    (stored gates) and the gate-recompute Function over K1's plain
    version."""
    rng = np.random.RandomState(8)
    n_h, T, B = 3, 3, 2
    d = lambda *s: torch.from_numpy(rng.randn(*s) * 0.5).requires_grad_(True)
    args = (d(4, n_h, n_h), d(3, n_h), d(4, n_h), d(T, B, 4, n_h), d(B, n_h),
            d(B, n_h))
    fn = tlstm.lstm_scan_fused if backend == 'torch_scan' else lstm_seq_fused

    def flat(*a):
        hs, (h_T, c_T) = fn(*a)
        return hs, h_T, c_T

    assert torch.autograd.gradcheck(flat, args, eps=1e-6, atol=1e-5)


# --------------------------------------------------------------- ctc_loss
def _ctc_case(seed, T=12, B=4, K=7, L=4):
    rng = np.random.RandomState(seed)
    logits = rng.randn(T, B, K).astype(np.float32)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.randint(1, K, size=(B, L)).astype(np.int32)
    labels[0, 1] = labels[0, 0]               # a repeat needs a blank
    in_len = np.array([T, T - 3, 9, T], np.int32)[:B]
    lab_len = np.array([L, 2, 3, 1], np.int32)[:B]
    return lp.astype(np.float32), labels, in_len, lab_len


def test_ctc_loss_and_grads_match_reference():
    lp, labels, in_len, lab_len = _ctc_case(0)
    jf = lambda x: jnp.sum(jctc.ctc_loss(x, labels, in_len, lab_len)
                           * jnp.arange(1.0, 5.0))
    want = jctc.ctc_loss(lp, labels, in_len, lab_len)
    jgrad = jax.grad(jf)(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_(True)
    got = tctc.ctc_loss(x, torch.from_numpy(labels), torch.from_numpy(in_len),
                        torch.from_numpy(lab_len))
    (got * torch.arange(1.0, 5.0)).sum().backward()
    _close(got, want, rtol=1e-5, atol=0)
    _close(x.grad, jgrad, rtol=0, atol=1e-6)


def test_ctc_loss_matches_torch_on_feasible_cases():
    lp, labels, in_len, lab_len = _ctc_case(1)
    args = tuple(map(torch.from_numpy, (lp, labels, in_len, lab_len)))
    got = tctc.ctc_loss(*args)
    want = torch.nn.functional.ctc_loss(*args[:1], args[1].long(),
                                        args[2].long(), args[3].long(),
                                        reduction='none')
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_ctc_loss_empty_and_infeasible_sequences_have_finite_grads():
    lp, labels, in_len, lab_len = _ctc_case(2)
    lab_len = np.array([0, 4, 3, 1], np.int32)
    labels[1] = [3, 3, 3, 3]                  # needs 7 frames
    in_len = np.array([12, 5, 9, 12], np.int32)
    x = torch.from_numpy(lp).requires_grad_(True)
    got = tctc.ctc_loss(x, *map(torch.from_numpy, (labels, in_len, lab_len)))
    got.sum().backward()
    want = jctc.ctc_loss(lp, labels, in_len, lab_len)
    infeasible = float(np.float32(-tctc.NEG_INF))
    assert float(got[1].detach()) == infeasible == float(want[1])
    _close(got[[0, 2, 3]], np.asarray(want)[[0, 2, 3]], rtol=1e-5, atol=0)
    # label_len 0: the all-blank path
    _close(got[0], -lp[:, 0, 0].sum(), rtol=1e-5, atol=0)
    assert bool(torch.isfinite(x.grad).all())


# -------------------------------------------------------------- optimizer
def test_adamw_cosine_clip_match_reference_over_three_updates():
    ref = _np_stack(30, n_layers=2, n_out=5)
    lr = (1e-2, 2, 6)
    jo = jopt.adamw(jopt.cosine_schedule(*lr))
    to = adamw(cosine_schedule(*lr))
    jp = jax.tree.map(jnp.asarray, ref)
    tp = stack_params_from_numpy(ref, 'cpu')
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        g = jax.tree.map(lambda a: (np.random.RandomState(40 + k).randn(
            *a.shape) * (3.0 if k == 0 else 0.01)).astype(np.float32), ref)
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = clip_by_global_norm(stack_params_from_numpy(g, 'cpu'), 1.0)
        _close(tn, jn, rtol=1e-5, atol=0)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), apply_updates(tp, tu)
        assert int(ts.step) == int(js.step) == k + 1
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            _close(a, b, rtol=1e-5, atol=1e-7)
    for s in (0, 1, 2, 4, 6, 9):
        _close(cosine_schedule(*lr)(s), jopt.cosine_schedule(*lr)(s),
               rtol=1e-6, atol=0)


# ------------------------------------------------------------- train step
def _j_cfg():
    return jconfigs.get_smoke_config('chipmunk-ctc').replace(
        lstm_backend='xla_scan')


def test_synthetic_batches_are_bit_equal_to_reference():
    shape = configs.ShapeConfig('t', 'train', 24, 4)
    src = source_for(configs.get_smoke_config('chipmunk-ctc'), shape, seed=3)
    jsrc = JSyntheticCTC(_j_cfg(), jconfigs.ShapeConfig('t', 'train', 24, 4),
                         seed=3)
    assert isinstance(src, SyntheticCTC)
    for step in (0, 5):
        got, want = src.host_batch(step, 1, 3), jsrc.host_batch(step, 1, 3)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize('microbatches', [1, 2])
def test_train_step_matches_reference(microbatches):
    """Three steps of ``make_train_step`` on the smoke config from the same
    weights and batches as the reference's, jitted without a mesh."""
    jcfg = _j_cfg()
    bundle = get_bundle(jcfg)
    jo = jopt.make_optimizer('adamw', jopt.cosine_schedule(1e-2, 2, 6))
    jparams, _ = bundle.init(jax.random.PRNGKey(0))
    jstate = {'params': jparams, 'opt': jo.init(jparams),
              'step': jnp.zeros((), jnp.int32)}
    jstep = jax.jit(j_make_train_step(bundle, jo, microbatches=microbatches))
    cfg = configs.get_smoke_config('chipmunk-ctc').replace(
        lstm_backend='torch_scan')
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    step = ttrain.make_train_step(
        functools.partial(chipmunk_net.loss_fn, cfg),
        ttrain.make_optimizer(cfg.optimizer, cosine_schedule(1e-2, 2, 6)),
        microbatches=microbatches)
    shape = configs.ShapeConfig('t', 'train', 16, 4)
    src = SyntheticCTC(cfg, shape, seed=0)
    for k in range(3):
        host = src.host_batch(k, 0, 4)
        jstate, jm = jstep(jstate, {n: jnp.asarray(v)
                                    for n, v in host.items()})
        state, m = step(state, {n: torch.from_numpy(v)
                                for n, v in host.items()})
        _close(m['loss'], jm['loss'], msg=f'loss at step {k}')
        _close(m['grad_norm'], jm['grad_norm'], msg=f'gnorm at step {k}')
    assert int(state['step']) == int(jstate['step']) == 3
    for (path, a), b in zip(flatten_with_paths(state),
                            jax.tree.leaves(jstate)):
        _close(a, b, msg=path)


def test_train_step_agrees_across_kernel_backends():
    cfg = configs.get_smoke_config('chipmunk-ctc')
    shape = configs.ShapeConfig('t', 'train', 12, 2)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticCTC(cfg, shape).host_batch(0, 0, 2).items()}
    opt = adamw(cosine_schedule(1e-2, 1, 4))
    out = {}
    for backend in KERNEL_BACKENDS:
        c = cfg.replace(lstm_backend=backend)
        step = ttrain.make_train_step(
            functools.partial(chipmunk_net.loss_fn, c), opt)
        state = ttrain.init_train_state(c, opt, 'cpu')
        for _ in range(2):
            state, m = step(state, batch)
        out[backend] = (float(m['loss']), leaves(state['params']))
    for backend in KERNEL_BACKENDS[1:]:
        _close(out[backend][0], out['torch_scan'][0], msg=backend)
        for a, b in zip(out[backend][1], out['torch_scan'][1]):
            _close(a, b.detach().numpy(), msg=backend)


# ------------------------------------------------------------- checkpoints
def _small_state():
    opt = adamw(cosine_schedule(1e-3, 1, 4))
    return ttrain.init_train_state(configs.get_smoke_config('chipmunk-ctc'),
                                   opt, 'cpu', seed=5), opt


def test_checkpoint_round_trip(tmp_path):
    state, opt = _small_state()
    state['opt'] = state['opt']._replace(m=apply_updates(
        state['opt'].m, state['params']))        # nonzero moments
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    like, _ = _small_state()
    got = mgr.restore(like)
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    with pytest.raises(ValueError):
        mgr.restore({'params': like['params'], 'step': like['step']})


def test_checkpoints_are_shared_with_the_reference(tmp_path):
    """A state the reference's manager wrote restores into the port's,
    leaf for leaf, and the port's checkpoint restores into the
    reference's."""
    jcfg = _j_cfg()
    jparams, _ = get_bundle(jcfg).init(jax.random.PRNGKey(1))
    jo = jopt.adamw(jopt.cosine_schedule(1e-3, 1, 4))
    jstate = {'params': jparams,
              'opt': jo.init(jparams)._replace(
                  step=jnp.asarray(7, jnp.int32),
                  m=jax.tree.map(lambda p: p * 0.5, jparams)),
              'step': jnp.asarray(7, jnp.int32)}
    JCheckpointManager(tmp_path / 'ref').save(7, jstate, blocking=True)
    like, _ = _small_state()
    got = CheckpointManager(tmp_path / 'ref').restore(like)
    assert int(got['step']) == int(got['opt'].step) == 7
    for a, b in zip(leaves(got), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and back: the reference restores what the port wrote
    CheckpointManager(tmp_path / 'port').save(7, got, blocking=True)
    back = JCheckpointManager(tmp_path / 'port').restore(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # ``train_state_from_numpy`` carries the same state across
    conv = train_state_from_numpy(jax.tree.map(np.asarray, jstate), 'cpu')
    for a, b in zip(leaves(conv), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------------- CLI
def test_train_cli_end_to_end(tmp_path, capsys):
    """The train CLI in process, as ``tests/test_system.py`` runs the
    reference's: 8 steps with checkpoints, then a resume."""
    ttrain.main(['--device', 'cpu', '--smoke', '--steps', '8', '--batch',
                 '4', '--seq', '32', '--ckpt-every', '4', '--ckpt-dir',
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert 'done' in out and 'step     0 loss' in out
    ttrain.main(['--device', 'cpu', '--smoke', '--steps', '12', '--batch',
                 '4', '--seq', '32', '--ckpt-dir', str(tmp_path), '--resume',
                 '--lstm-backend', 'cuda_step'])
    out = capsys.readouterr().out
    assert 'resumed at step 8' in out and 'done' in out
    assert CheckpointManager(tmp_path).latest_step() == 12


def test_train_cli_defaults_to_the_card(tmp_path):
    """Without ``--device`` the train CLI puts the model on the card; on a
    machine without one it fails rather than train on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a CUDA device')
    with pytest.raises((AssertionError, RuntimeError), match='CUDA'):
        ttrain.main(['--smoke', '--steps', '1', '--ckpt-dir',
                     str(tmp_path)])
