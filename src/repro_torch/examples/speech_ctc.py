"""End-to-end paper scenario on the port: train CTC-3L-421H-UNI, quantize,
deploy int8, stream.

The paper's real-world evaluation (Sec. 4.2) runs a 3-layer 421-hidden-unit
LSTM with CTC phoneme outputs on Chipmunk arrays.  This example covers the
whole lifecycle on synthetic MFCC data, as the reference's
``examples/speech_ctc.py`` does:

  1. train the full-precision network with CTC loss (AdamW, cosine 3e-3
     with 10 warm-up steps, global-norm clip 1);
  2. quantize each layer to the 8-bit systolic format on
     ``SystolicPlan(n_x, n_h, 96)``;
  3. deploy int8 through ``lstm_stack_seq_quantized_auto`` (an installed
     schedule cache, else the cold rule, picks K4 or the K3 chain; the
     codes must equal the plain chain ``systolic_layer_quantized`` bit for
     bit) and compare greedy decodes with fp32;
  4. stream ragged utterances through ``StreamingEngine`` with incremental
     CTC emission and count streamed == monolithic decodes;
  5. report deployment feasibility per Table 2 (10 ms frame deadline).

    python -m repro_torch.examples.speech_ctc --steps 60
    python -m repro_torch.examples.speech_ctc --device cpu --small --steps 2
"""
import argparse
import functools
import time

import numpy as np
import torch

from ..configs import ShapeConfig, get_config
from ..core import ctc, perf_model as pm, quant, systolic
from ..core.lstm import readout, select_quantized_stack_backend
from ..data import SyntheticCTC
from ..kernels.lstm_seq import (lstm_seq_quantized, lstm_stack_seq_kernel_q,
                                lstm_stack_seq_quantized_auto)
from ..launch.train import make_train_step
from ..models import chipmunk_net
from ..optim import adamw, cosine_schedule
from ..serving import StreamingEngine
from ..tree import leaves


def quantize_layers(params):
    """Every layer on the silicon's plan ``SystolicPlan(n_x, n_h, 96)``:
    ``pack_lstm`` then ``quantize_packed``, on the weights' device."""
    return [systolic.quantize_packed(systolic.pack_lstm(
        layer, systolic.SystolicPlan(layer.n_x, layer.n_h,
                                     systolic.N_LSTM_SILICON)))
            for layer in params.layers]


def deploy_int8(params, frames: torch.Tensor, qps, backend: str = 'auto'):
    """The int8 deploy of (B, T, n_in) ``frames``: quantize to Q2.5, run
    the whole quantized stack from zero state on ``backend``
    (``lstm_stack_seq_quantized_auto``), dequantize the top layer's codes
    and apply the f32 read-out and ``log_softmax``, as the reference's
    example does with its ``systolic_layer_quantized`` chain.  Returns
    ``(codes (T, B, n_h) int8, log-probs (T, B, n_out), backend run)``."""
    x_q = quant.quantize(frames.transpose(0, 1).contiguous(),
                         quant.STATE_FMT)
    T, B = x_q.shape[:2]
    p0 = qps[0].plan
    if backend == 'auto':
        backend = select_quantized_stack_backend(
            p0.n_h, len(qps), T, B, n_x=p0.n_x, device=x_q.device,
            tile=p0.tile)
    codes = lstm_stack_seq_quantized_auto(qps, x_q, backend=backend)
    h = quant.dequantize(codes, quant.STATE_FMT)
    log_probs = torch.log_softmax(readout(params.w_out, params.b_out, h),
                                  dim=-1)
    return codes, log_probs, backend


def plain_chain(qps, frames: torch.Tensor) -> torch.Tensor:
    """The reference chain: ``systolic_layer_quantized`` layer by layer
    over the Q2.5 codes of (B, T, n_in) ``frames`` (plain PyTorch)."""
    x_q = quant.quantize(frames.transpose(0, 1).contiguous(),
                         quant.STATE_FMT)
    for qp in qps:
        x_q = systolic.systolic_layer_quantized(qp, x_q)
    return x_q


def _symbols(log_probs: torch.Tensor):
    """Greedy-decoded symbol lists of (T, B, K) log-probs, one per row."""
    dec, lens = ctc.ctc_greedy_decode(log_probs)
    return [dec[b, :int(lens[b])].tolist() for b in range(dec.shape[0])]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=60)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--frames', type=int, default=64)
    ap.add_argument('--small', action='store_true',
                    help='reduced network for quick runs')
    ap.add_argument('--device', default='cuda',
                    help='torch device (cuda, cpu)')
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_config('chipmunk-ctc')
    if args.small:
        cfg = cfg.replace(n_layers=2, lstm_hidden=96)
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    n_weights = sum(a.numel() for a in leaves(params))
    print(f'CTC-{cfg.n_layers}L-{cfg.lstm_hidden}H: {n_weights:,} weights '
          f'(paper: ~3.8e6 for the full topology) on {dev}')

    # ------------------------------------------------------------- training
    shape = ShapeConfig('ctc', 'train', args.frames, args.batch)
    source = SyntheticCTC(cfg, shape, seed=0)
    opt = adamw(cosine_schedule(3e-3, warmup=10, total=args.steps))
    step = make_train_step(functools.partial(chipmunk_net.loss_fn, cfg), opt,
                           grad_clip=1.0)
    state = {'params': params, 'opt': opt.init(params),
             'step': torch.zeros((), dtype=torch.int32)}
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in source.host_batch(i, 0, args.batch).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics['loss']))
        if i % 10 == 0 or i == args.steps - 1:
            print(f'step {i:4d}  ctc loss {losses[-1]:8.3f}  '
                  f'({(time.time() - t0) / (i + 1):.2f}s/step)')
    params = state['params']

    # ------------------------------------------- quantize + int8 deploy
    host = source.host_batch(10_000, 0, args.batch)
    frames = torch.from_numpy(host['frames']).to(dev)
    log_probs_fp = chipmunk_net.forward(cfg, params, frames)
    qps = quantize_layers(params)
    lstm_seq_quantized.launches = 0
    lstm_stack_seq_kernel_q.launches = 0
    codes, log_probs_q, backend = deploy_int8(params, frames, qps)
    launches = dict(lstm_seq_quantized=lstm_seq_quantized.launches,
                    lstm_stack_seq_kernel_q=lstm_stack_seq_kernel_q.launches)
    chain_equal = torch.equal(codes, plain_chain(qps, frames))
    print(f'\nint8 deploy on {backend!r} '
          f'({"K4, the fused stack" if backend == "fused" else "K3 per layer"}'
          f'; launches {launches}): codes == plain chain '
          f'systolic_layer_quantized x{len(qps)}: {chain_equal}')
    if not chain_equal:
        raise SystemExit('the int8 deploy disagrees with the plain chain')
    sym_fp, sym_q = _symbols(log_probs_fp), _symbols(log_probs_q)
    agree = float(np.mean([a == b for a, b in zip(sym_fp, sym_q)]))
    print(f'int8 systolic deployment: greedy decode agreement '
          f'{agree * 100:.0f}% across {args.batch} utterances')
    print('engines per layer: ' + ', '.join(
        f'{qp.plan.rows}x{qp.plan.cols}' for qp in qps))

    # ------------------------------------- streaming serving (DESIGN.md §7)
    rng = np.random.RandomState(1)
    n_stream = min(4, args.batch)
    lens = [int(rng.randint(args.frames // 2, args.frames + 1))
            for _ in range(n_stream)]
    utts = [host['frames'][b, :n] for b, n in enumerate(lens)]
    engine = StreamingEngine(cfg, params, max_streams=max(2, n_stream // 2),
                             chunk=max(4, args.frames // 8), decode_ctc=True)
    sessions = [engine.submit(u) for u in utts]
    engine.run()
    stream_agree = sum(
        int(sess.decoder.symbols == _symbols(chipmunk_net.forward(
            cfg, params, torch.from_numpy(u)[None].to(dev)))[0])
        for sess, u in zip(sessions, utts))
    stats = engine.stats()
    print(f'\nstreaming engine [{stats["backend"]}]: {stats["streams"]} '
          f'ragged utterances ({stats["frames"]} frames) served in chunks of '
          f'{engine.chunk}; incremental CTC == monolithic decode for '
          f'{stream_agree}/{n_stream} streams '
          f'(p50 chunk {stats["p50_chunk_s"] * 1e3:.1f} ms)')
    first = sessions[0].decoder.symbols
    print(f'  stream 0 incremental phonemes: {first[:12]}'
          + (' ...' if len(first) > 12 else ''))

    # ----------------------------------------------------- Table 2 verdict
    print('\ndeployment feasibility (10 ms MFCC frame deadline):')
    for row in pm.table2():
        flag = 'MET ' if row['meets_deadline'] else 'MISS'
        print(f'  {row["config"]:>16} @{row["voltage"]}V: '
              f'{row["exec_time_ms"]:8.3f} ms  [{flag}]  '
              f'avg {row["avg_power_mw"]:7.2f} mW')
    return dict(losses=losses, backend=backend, launches=launches,
                chain_equal=chain_equal, decode_agreement=agree,
                stream_agree=stream_agree, n_stream=n_stream)


if __name__ == '__main__':
    main()
