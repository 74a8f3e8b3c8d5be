"""The port's lifecycle examples (``repro_torch.examples``) on the CPU.

``speech_ctc``'s int8 deploy (``deploy_int8``) is held against the
reference example's deploy (``examples/speech_ctc.py`` lines 75-95: the
``systolic_layer_quantized`` chain, the f32 read-out, ``log_softmax``) on
weights carried from the reference by ``convert.stack_params_from_numpy``:
the int8 codes ``torch.equal`` and the greedy decodes the same, on each
int8 backend (no tolerance: the datapath is bit-exact, and decodes are
symbols).  Both examples also run end to end at narrow widths
(``--small --steps 2``), where their plain versions run, and ``serve_lm``
serves the Qwen3 smoke configuration.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import ctc as jctc  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core import systolic as jsys  # noqa: E402
from repro.models import get_bundle  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.core.ctc import ctc_greedy_decode  # noqa: E402
from repro_torch.examples import quickstart, serve_lm, speech_ctc  # noqa: E402

T, B, N_H = 12, 3, 96


@pytest.fixture(scope='module')
def carried():
    """The reference's CTC net at 2 x 96 hidden (the example's --small)
    from its own init, the same weights in the port, and seeded frames."""
    cfg = jget_config('chipmunk-ctc').replace(n_layers=2, lstm_hidden=N_H,
                                              d_model=N_H)
    jparams, _ = get_bundle(cfg).init(jax.random.PRNGKey(0))
    params = stack_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device='cpu')
    frames = (np.random.RandomState(3).randn(B, T, cfg.lstm_inputs)
              ).astype(np.float32)
    return jparams, params, frames


def _reference_deploy(params, frames):
    """``examples/speech_ctc.py`` lines 75-95, as the reference runs them:
    (top-layer codes (T, B, n_h), log-probs (T, B, n_out))."""
    h = jnp.moveaxis(jnp.asarray(frames), 0, 1)
    x_q = jquant.quantize(h, jquant.STATE_FMT)
    for layer in params.layers:
        plan = jsys.SystolicPlan(layer.n_x, layer.n_h, jsys.N_LSTM_SILICON)
        qp = jsys.quantize_packed(jsys.pack_lstm(layer, plan))
        x_q = jsys.systolic_layer_quantized(qp, x_q)
    h_deq = jquant.dequantize(x_q, jquant.STATE_FMT)
    logits_q = jnp.einsum('oh,tbh->tbo', params.w_out, h_deq) + params.b_out
    return x_q, jax.nn.log_softmax(logits_q, axis=-1)


@pytest.mark.parametrize('backend', ['auto', 'fused', 'layerwise'])
def test_deploy_int8_matches_reference_chain(carried, backend):
    jparams, params, frames = carried
    want_codes, want_lp = _reference_deploy(jparams, frames)
    qps = speech_ctc.quantize_layers(params)
    codes, log_probs, ran = speech_ctc.deploy_int8(
        params, torch.from_numpy(frames), qps, backend=backend)
    assert ran == ('layerwise' if backend == 'auto' else backend)
    assert torch.equal(codes, torch.tensor(np.asarray(want_codes)))
    dec, lens = jctc.ctc_greedy_decode(want_lp)
    got, got_lens = ctc_greedy_decode(log_probs)
    for b in range(B):
        assert (got[b, :int(got_lens[b])].tolist()
                == np.asarray(dec[b][:int(lens[b])]).tolist())


def test_deploy_int8_follows_the_installed_cache(carried):
    """The deploy's ``auto``: the cold rule's chain at 96 hidden, the fused
    stack under a measured entry at its shape (keyed by n_x 123), the same
    codes either way."""
    _, params, frames = carried
    qps = speech_ctc.quantize_layers(params)
    x = torch.from_numpy(frames)
    cold, _, ran_cold = speech_ctc.deploy_int8(params, x, qps)
    c = tune.ScheduleCache([tune.ScheduleEntry(
        kind='q_stack_backend', n_x=123, n_h=N_H, n_layers=2, T=T, B=B,
        backend='fused', source='measured')])
    with tune.using_schedule_cache(c):
        tuned, _, ran = speech_ctc.deploy_int8(params, x, qps)
    assert (ran_cold, ran) == ('layerwise', 'fused')
    assert torch.equal(cold, tuned)
    assert torch.equal(tuned, speech_ctc.plain_chain(qps, x))


def test_speech_ctc_runs_small_on_cpu(capsys):
    res = speech_ctc.main(['--device', 'cpu', '--small', '--steps', '2',
                           '--batch', '2', '--frames', '16'])
    assert len(res['losses']) == 2
    assert all(math.isfinite(v) for v in res['losses'])
    assert res['chain_equal'] and res['backend'] == 'layerwise'
    assert res['stream_agree'] == res['n_stream'] == 2
    out = capsys.readouterr().out
    assert 'greedy decode agreement' in out and 'systolic 3x5x5' in out


def test_quickstart_runs_on_cpu(capsys):
    res = quickstart.main(['--device', 'cpu'])
    assert res['k3_equal'] and res['systolic_max_err'] < 1e-5
    assert res['int8_mean_err'] < 0.05
    assert abs(res['exec_time_ms'] - 0.09) < 0.001
    assert 'peak efficiency' in capsys.readouterr().out


def test_serve_lm_runs_smoke_on_cpu(capsys):
    res = serve_lm.main(['--smoke', '--device', 'cpu', '--requests', '3',
                         '--slots', '2', '--max-new', '3'])
    assert res['requests'] == 3 and res['tokens'] == 9
    assert all(len(r.out) == 3 for r in res['done'])
    out = capsys.readouterr().out
    assert 'served 3 requests, 9 tokens' in out and 'qwen3-smoke' in out
