"""Parity of the port's model and streaming engine with the JAX reference,
and the engine's own contracts inside the port.

Weights come from the reference's smoke config through
``repro_torch.convert``; utterances are numpy arrays from a seed.  Parity
checks state rtol=1e-5, atol=1e-6 on log-probs (f32, other summation
orders).  Inside the port, neighbour isolation, slot recycling and
preempt/resume are bit-equal (``np.testing.assert_array_equal``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import ctc as jctc  # noqa: E402
from repro.models import chipmunk_net as jnet  # noqa: E402
from repro.models import get_bundle  # noqa: E402
from repro.serving import StreamingEngine as JEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import stack_params_from_numpy  # noqa: E402
from repro_torch.core import ctc  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import chipmunk_net  # noqa: E402
from repro_torch.serving import (IncrementalCTCDecoder,  # noqa: E402
                                 StreamingEngine)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope='module')
def smoke():
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg = jconfigs.get_smoke_config('chipmunk-ctc')
    jparams, _ = get_bundle(jcfg).init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config('chipmunk-ctc')
    params = stack_params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    return jcfg, jparams, cfg, params


def _utts(seed, lens, n_in):
    rng = np.random.RandomState(seed)
    return [(rng.randn(L, n_in) * 0.5).astype(np.float32) for L in lens]


def test_smoke_config_matches_reference():
    j, t = jconfigs.get_smoke_config('chipmunk-ctc'), configs.get_smoke_config(
        'chipmunk-ctc')
    for name in ('n_layers', 'lstm_hidden', 'lstm_inputs', 'n_outputs'):
        assert getattr(j, name) == getattr(t, name)
    full = configs.get_config('chipmunk-ctc')
    assert (full.n_layers, full.lstm_inputs, full.lstm_hidden,
            full.n_outputs) == (3, 123, 421, 62)


# ------------------------------------------------------------ (d) model
@pytest.mark.parametrize('backend', ['torch_scan', 'cuda_seq_fused'])
def test_forward_and_stream_forward_match_reference(smoke, backend):
    jcfg, jparams, cfg, params = smoke
    cfg = cfg.replace(lstm_backend=backend)
    frames = np.stack(_utts(1, [9, 9, 9], cfg.lstm_inputs))     # (B, T, n)
    lp = chipmunk_net.forward(cfg, params, torch.from_numpy(frames))
    np.testing.assert_allclose(lp.numpy(), np.asarray(
        jnet.forward(jcfg, jparams, jnp.asarray(frames))), rtol=RTOL,
        atol=ATOL)
    valid = np.array([9, 4, 6])
    states = chipmunk_net.init_state(cfg, 3, 'cpu')
    jstates, _ = jnet.init_state(jcfg, 3)
    for lo in (0, 5):
        part = frames[:, lo:lo + 5]
        vl = np.clip(valid - lo, 0, part.shape[1])
        lp, states = chipmunk_net.stream_forward(
            cfg, params, states, torch.from_numpy(part),
            valid_len=torch.from_numpy(vl))
        jlp, jstates = jnet.stream_forward(jcfg, jparams, jstates,
                                           jnp.asarray(part),
                                           valid_len=jnp.asarray(vl))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=RTOL,
                                   atol=ATOL)
        for (h, c), (jh, jc) in zip(states, jstates):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=RTOL,
                                       atol=ATOL)


# ----------------------------------------------------------- (e) engine
@pytest.mark.parametrize('backend', ['torch_scan', 'cuda_seq',
                                     'cuda_seq_fused'])
def test_engine_matches_reference_engine(smoke, backend):
    jcfg, jparams, cfg, params = smoke
    utts = _utts(2, [13, 7, 19, 4, 11], cfg.lstm_inputs)
    jeng = JEngine(jcfg, jparams, max_streams=3, chunk=4)
    jsess = [jeng.submit(u) for u in utts]
    jeng.run()
    eng = StreamingEngine(cfg.replace(lstm_backend=backend), params,
                          max_streams=3, chunk=4)
    assert eng.backend == backend
    sess = [eng.submit(u) for u in utts]
    eng.run()
    assert len(eng.sched.done) == len(utts)
    assert eng.stats()['steps'] == jeng.stats()['steps']
    for s, js, u in zip(sess, jsess, utts):
        assert s.full_log_probs().shape == (len(u), cfg.n_outputs)
        np.testing.assert_allclose(s.full_log_probs(), js.full_log_probs(),
                                   rtol=RTOL, atol=ATOL)


# ------------------------------------------------ engine contracts (port)
def test_engine_neighbours_unperturbed_by_admission_eviction(smoke):
    _, _, cfg, params = smoke
    rng = np.random.RandomState(1)
    probe = (rng.randn(17, cfg.lstm_inputs) * 0.5).astype(np.float32)
    solo = StreamingEngine(cfg, params, max_streams=3, chunk=4)
    s_solo = solo.submit(probe)
    solo.run()
    shared = StreamingEngine(cfg, params, max_streams=3, chunk=4)
    s_probe = shared.submit(probe)
    noisy = shared.submit(rng.randn(6, cfg.lstm_inputs).astype(np.float32))
    shared.submit(rng.randn(9, cfg.lstm_inputs).astype(np.float32))
    shared.step()
    shared.evict(noisy.sid)
    shared.submit(rng.randn(5, cfg.lstm_inputs).astype(np.float32))
    shared.run()
    np.testing.assert_array_equal(s_probe.full_log_probs(),
                                  s_solo.full_log_probs())
    assert len(shared.sched.done) == 3 and noisy.remaining > 0


def test_engine_slot_recycling_zeroes_state(smoke):
    _, _, cfg, params = smoke
    first, second = _utts(2, [9, 8], cfg.lstm_inputs)
    eng = StreamingEngine(cfg, params, max_streams=1, chunk=4)
    eng.submit(first)
    s2 = eng.submit(second)
    eng.run()
    fresh = StreamingEngine(cfg, params, max_streams=1, chunk=4)
    s2_fresh = fresh.submit(second)
    fresh.run()
    np.testing.assert_array_equal(s2.full_log_probs(),
                                  s2_fresh.full_log_probs())


def test_engine_preempt_resume_bit_equal(smoke):
    _, _, cfg, params = smoke
    utt, other = _utts(3, [14, 6], cfg.lstm_inputs)
    ref = StreamingEngine(cfg, params, max_streams=2, chunk=4)
    s_ref = ref.submit(utt)
    ref.submit(other)
    ref.run()
    eng = StreamingEngine(cfg, params, max_streams=2, chunk=4)
    s = eng.submit(utt)
    eng.submit(other)
    eng.step()
    assert eng.preempt(s.sid, requeue=False) is s
    eng.step()
    eng.resume(s)
    eng.run()
    np.testing.assert_array_equal(s.full_log_probs(), s_ref.full_log_probs())


def test_incremental_ctc_equals_greedy_decode():
    rng = np.random.RandomState(3)
    lp = rng.randn(23, 7).astype(np.float32)
    out, lens = ctc.ctc_greedy_decode(torch.from_numpy(lp)[:, None, :])
    syms = out[0, :int(lens[0])].tolist()
    dec = IncrementalCTCDecoder()
    for lo in range(0, 23, 5):
        dec.feed(lp[lo:lo + 5])
    assert dec.symbols == syms


def test_ctc_greedy_decode_matches_reference():
    lp = np.random.RandomState(4).randn(11, 3, 6).astype(np.float32)
    lp[:, 1] = lp[:, 1, :1] + 1.0 * (np.arange(6) == 0)   # all blank
    out, lens = ctc.ctc_greedy_decode(torch.from_numpy(lp))
    jout, jlens = jctc.ctc_greedy_decode(jnp.asarray(lp))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


def test_serve_cli_on_cpu_smoke():
    stats = serve.main(['--device', 'cpu', '--smoke', '--requests', '4',
                        '--slots', '2', '--chunk', '4',
                        '--lstm-backend', 'cuda_seq_fused'])
    assert stats['streams'] == 4 and stats['backend'] == 'cuda_seq_fused'


def test_engine_builds_fused_stack_weights_once(smoke, monkeypatch):
    """The fused backend's stacked weights are built when the engine starts
    and reused by every chunk; other backends build none."""
    from repro_torch.kernels.lstm_seq import stack_ops
    from repro_torch.serving import engine as engine_mod
    _, _, cfg, params = smoke
    real, builds = stack_ops.stack_kernel_weights, []

    def counting(p):
        builds.append(p)
        return real(p)

    monkeypatch.setattr(stack_ops, 'stack_kernel_weights', counting)
    monkeypatch.setattr(engine_mod, 'stack_kernel_weights', counting)
    eng = StreamingEngine(cfg.replace(lstm_backend='cuda_seq_fused'), params,
                          max_streams=2, chunk=4)
    for u in _utts(4, [10, 7], cfg.lstm_inputs):
        eng.submit(u)
    eng.run()
    assert eng.stats()['steps'] == 3 and len(builds) == 1
    wts = eng.stack_weights
    for l, lp in enumerate(params.layers):
        assert torch.equal(wts.w_h[l], lp.w_h)
        assert torch.equal(wts.peep[l], lp.w_peep)
        assert torch.equal(wts.b[l], lp.b)
        if l:
            assert torch.equal(wts.w_in[l - 1], lp.w_x)
    assert StreamingEngine(cfg.replace(lstm_backend='cuda_seq'), params,
                           max_streams=2, chunk=4).stack_weights is None
