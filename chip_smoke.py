#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Drives the port's serving and training paths at the full CTC-3L-421H-UNI
width (123 MFCC features -> 3x421 peephole LSTM -> 62 CTC outputs, random
weights from a seed) and checks them:

1. builds every CUDA kernel of the path from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together) and prints the build time;
2. holds K1 (``lstm_seq``) and K2 (``lstm_stack_seq_kernel``) against their
   plain PyTorch versions on the card at the serving shape (B = slots,
   T = chunk, ragged mask, nonzero h0/c0) and times both with CUDA events,
   with the one-off cost of stacking K2's weights (``stack_kernel_weights``);
3. checks chunked == monolithic bit for bit (``torch.equal``) on both kernel
   backends;
4. serves ragged utterances through ``launch.serve.StreamServer`` on
   ``cuda_seq``, ``cuda_seq_fused`` and ``torch_scan``: the streams must
   agree across backends and with the monolithic ``forward``, and the
   launch counters must show L K1 launches per engine step on ``cuda_seq``
   and one K2 launch per step on ``cuda_seq_fused``;

and then the int8 silicon path (the deployment of the reference's
``examples/speech_ctc.py``) on the same f32 weights, each layer quantized
on ``SystolicPlan(n_x, 421, 96)``:

5. holds K3 (``lstm_seq_quantized``, on both layer plans) and K4
   (``lstm_stack_seq_kernel_q``) against their plain versions at the serving
   shape, bit for bit (``torch.equal`` on the h and c codes), and times
   both, with the one-off cost of building both kernels' weight layouts
   (``stack_kernel_weights_q``);
6. checks int8 chunked == monolithic bit for bit over 3 ragged chunks on
   both ``lstm_stack_seq_quantized_auto`` backends, and fused == layerwise
   == the reference chain ``systolic_layer_quantized`` x L;
7. runs 8 utterances of 50-300 frames through the int8 stack in chunks of
   16 on ``auto`` (which must pick ``fused``) and on ``layerwise``: the
   codes must agree, and the launch counters must show one K4 launch per
   chunk and L K3 launches per chunk; times further passes of both,
   interleaved; then dequantizes, applies the f32 read-out and
   ``log_softmax``, greedy-decodes, and prints the decode agreement with
   the f32 ``forward`` (reported, not asserted: the weights are random).

and then the training path (the reference CLI's batch 8 and sequence 64,
the same f32 weights' configuration from seed 0):

8. holds K5 (``lstm_gates_rec``, one recurrent step) against its plain
   version at the training shape (B = 8, N_h = 421, nonzero h and c) and
   times it, its plain version, and the product alone (``torch.addmm``);
   checks ``lstm_layer_fused`` on ``cuda_step`` against ``cuda_seq`` over
   16 steps;
9. compares every leaf's gradient of ``loss_fn`` (T = 16, B = 8) on
   ``cuda_step``, ``cuda_seq`` and ``cuda_seq_fused`` with the
   ``torch_scan`` Function's on the card, by relative Frobenius error;
10. runs six ``make_train_step`` steps on each of the three kernel backends
    from the same weights and ``SyntheticCTC`` batches: every loss finite,
    the loss histories in agreement, the launch counters at T*L K5
    launches per step on ``cuda_step``, L K1 on ``cuda_seq`` and one K2 on
    ``cuda_seq_fused``; the median step time after the first; then
    restores the step-3 checkpoint into a fresh state and checks that the
    next step's loss equals the uninterrupted run's bit for bit;
11. runs the trainer's entry point (``launch.train.main``) on ``cuda_step``
    as a user does: six steps with checkpoints every three, then
    ``--resume`` for two more; the losses printed must be finite, the
    resume must start at step 6, and K5 must launch T*L times per step.

``--profile`` also traces one engine drain per f32 kernel backend, several
int8 deploy passes per int8 backend, and one train step per kernel backend
with ``torch.profiler``.

Any failed check raises (nonzero exit).  The line before the last is the
``kernels`` JSON; the last line is the device JSON.  Without a CUDA device,
or without the repository's ``src/repro_torch`` beside it, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 tensor cores, dense
KERNEL_ATOL = 1e-4            # kernel vs plain version, f32 state/outputs
ENGINE_ATOL = 1e-4            # log-probs across backends / vs forward
ENGINE_RTOL = 1e-4
SLOTS, CHUNK = 8, 16          # the serving shape: B = slots, T = chunk
REQUESTS, SEED = 12, 0        # utterances of 50-300 frames, weights seed
INT8_UTTERANCES = 8           # int8 deploy phase: utterances of 50-300 frames
INT8_REPEATS = 7              # timed int8 deploy passes per backend
INT8_PROFILE_PASSES = 10      # int8 deploy passes per traced window
TRAIN_BATCH, TRAIN_SEQ = 8, 64   # the reference train CLI's defaults
TRAIN_STEPS = 6               # train steps per kernel backend
TRAIN_CKPT_STEP = 3           # checkpoint taken after this many steps
TRAIN_RESUME_STEPS = 2        # train CLI steps after its --resume
TRAIN_BACKENDS = ('cuda_step', 'cuda_seq', 'cuda_seq_fused')
GRAD_T = 16                   # sequence of the on-card gradient check
GRAD_REL_TOL = 1e-4           # relative Frobenius error per gradient leaf
LOSS_RTOL = 1e-4              # loss histories across kernel backends


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` back-to-back calls,
    from CUDA events after ``warmup`` calls.  The stream is first held by
    ``torch.cuda._sleep`` for twice the host time of the ``reps`` calls, so
    every launch is queued before the first runs and the events see device
    time, not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * host_s * 2e9))   # <= 2 GHz SM clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean host time of ``fn`` in ms over ``reps`` calls that are issued
    without waiting for the device (the cost the calls add to the host's
    launch path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def bound(nbytes: float, flops: float, ops_per_s: float = F32_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of their type (f32 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def ragged_lens(rng, T: int, B: int) -> np.ndarray:
    """Valid lengths with a full, an empty and partial streams."""
    lens = rng.randint(1, T, size=B)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    return lens


def kernel_checks(cfg, params, B: int, T: int, rng, dev):
    """K1 and K2 against their plain versions at the serving shape."""
    from repro_torch.core.lstm import hoisted_input, valid_len_mask
    from repro_torch.kernels.lstm_seq import (lstm_seq, lstm_seq_ref,
                                              lstm_stack_seq_kernel,
                                              lstm_stack_seq_ref,
                                              stack_kernel_weights)
    N, L, NX = cfg.lstm_hidden, cfg.n_layers, cfg.lstm_inputs
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    xs = f32(rng.randn(T, B, NX) * 0.5)
    lens = torch.from_numpy(ragged_lens(rng, T, B)).to(dev)
    mask = valid_len_mask(T, lens, B)
    n_live = int(mask.sum())
    pre_x = hoisted_input(params.layers[0].w_x, xs)
    rows = []

    lp = params.layers[0]
    h0, c0 = f32(rng.randn(B, N) * 0.5), f32(rng.randn(B, N) * 0.5)
    args = (pre_x, lp.w_h, lp.w_peep, lp.b, h0, c0, mask)
    hs, cs = lstm_seq(*args)
    hs_r, cs_r = lstm_seq_ref(*args)
    err = max(float((hs - hs_r).abs().max()), float((cs - cs_r).abs().max()))
    nbytes = 4 * (pre_x.numel() + lp.w_h.numel() + 7 * N + 2 * B * N
                  + 2 * T * B * N) + mask.numel()
    flops = n_live * (2 * 4 * N * N + 30 * N)
    rows.append(dict(
        name='lstm_seq', route='cuda', source='src/repro_torch/csrc/lstm_seq.cu',
        replaces='src/repro/kernels/lstm_seq/kernel.py:113',
        max_abs_err=err, tol=KERNEL_ATOL,
        ms=cuda_ms(lambda: lstm_seq(*args), 50),
        plain_ms=cuda_ms(lambda: lstm_seq_ref(*args), 5, warmup=1),
        bytes=nbytes, flops=flops, library_ms=None))

    build = lambda: stack_kernel_weights(params)
    wts = build()
    stacking = dict(mbytes=4e-6 * sum(
        a.numel() for a in (wts.w_in, wts.w_h, wts.peep, wts.b)),
        device_ms=cuda_ms(build, 20), host_ms=host_ms(build, 20))
    print(f"stack_kernel_weights: {stacking['mbytes']:.2f} MB stacked once "
          f"per engine, device {stacking['device_ms']:.4f} ms, host "
          f"{stacking['host_ms']:.4f} ms per build", flush=True)
    h0s, c0s = f32(rng.randn(L, B, N) * 0.5), f32(rng.randn(L, B, N) * 0.5)
    args2 = (pre_x, wts.w_in, wts.w_h, wts.peep, wts.b, h0s, c0s, mask)
    hs, cs = lstm_stack_seq_kernel(*args2)
    hs_r, cs_r = lstm_stack_seq_ref(*args2)
    err = max(float((hs - hs_r).abs().max()), float((cs - cs_r).abs().max()))
    nbytes = 4 * (pre_x.numel() + wts.w_in.numel() + wts.w_h.numel()
                  + 7 * L * N + 2 * L * B * N + 2 * L * T * B * N
                  ) + mask.numel()
    flops = n_live * ((2 * L - 1) * 2 * 4 * N * N + L * 30 * N)
    rows.append(dict(
        name='lstm_stack_seq_kernel', route='cuda',
        source='src/repro_torch/csrc/lstm_stack_seq.cu',
        replaces='src/repro/kernels/lstm_seq/stack_kernel.py:185',
        max_abs_err=err, tol=KERNEL_ATOL,
        ms=cuda_ms(lambda: lstm_stack_seq_kernel(*args2), 50),
        plain_ms=cuda_ms(lambda: lstm_stack_seq_ref(*args2), 3, warmup=1),
        bytes=nbytes, flops=flops, library_ms=None))
    for r in rows:
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'])
        r['ok'] = r['max_abs_err'] <= KERNEL_ATOL
        print(f"{r['name']}: T={T} B={B} N_h={N} L={L} live steps {n_live}: "
              f"max_abs_err {r['max_abs_err']:.3e} (tol {KERNEL_ATOL}), "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})", flush=True)
        check(r['ok'], f"{r['name']} disagrees with its plain version")
    return rows, stacking


def chunked_checks(params, B: int, chunk: int, rng, dev):
    """Chunked == monolithic, bit for bit, on both kernel backends."""
    from repro_torch.core.lstm import lstm_stack_chunk
    T = 3 * chunk
    NX = params.layers[0].n_x
    xs = torch.from_numpy((rng.randn(T, B, NX) * 0.5).astype(np.float32)).to(dev)
    lens = ragged_lens(rng, T, B)
    for backend in ('cuda_seq', 'cuda_seq_fused'):
        mono, fin_m = lstm_stack_chunk(
            params, xs, None, valid_len=torch.from_numpy(lens).to(dev),
            backend=backend)
        states, outs = None, []
        for lo in range(0, T, chunk):
            vl = np.clip(lens - lo, 0, chunk)
            o, states = lstm_stack_chunk(params, xs[lo:lo + chunk], states,
                                         valid_len=torch.from_numpy(vl).to(dev),
                                         backend=backend)
            outs.append(o)
        got = torch.cat(outs)
        same = torch.equal(got, mono) and all(
            torch.equal(a, b) for (a, b) in
            zip(sum(map(list, states), []), sum(map(list, fin_m), [])))
        print(f'chunked == monolithic [{backend}] T={T} in {T // chunk} '
              f'chunks, B={B}: {same}', flush=True)
        check(same, f'chunked != monolithic on {backend}')


def engine_runs(cfg, params, slots: int, chunk: int, utts):
    """Serve the same utterances on the three backends; returns per-backend
    results with the launch counts of the run."""
    from repro_torch.kernels.lstm_seq import lstm_seq, lstm_stack_seq_kernel
    from repro_torch.launch.serve import StreamServer
    from repro_torch.models import chipmunk_net
    runs = {}
    for backend in ('cuda_seq', 'cuda_seq_fused', 'torch_scan'):
        server = StreamServer(cfg.replace(lstm_backend=backend), params,
                              num_slots=slots, chunk=chunk)
        check(server.engine.backend == backend, f'engine pinned '
              f'{server.engine.backend}, asked for {backend}')
        sessions = [server.submit(u) for u in utts]
        torch.cuda.synchronize()
        lstm_seq.launches = 0
        lstm_stack_seq_kernel.launches = 0
        t0 = time.perf_counter()
        server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(lstm_seq=lstm_seq.launches,
                        lstm_stack_seq_kernel=lstm_stack_seq_kernel.launches)
        stats = server.engine.stats()
        lps = [s.full_log_probs() for s in sessions]
        for s, u, lp in zip(sessions, utts, lps):
            check(lp.shape == (len(u), cfg.n_outputs) and
                  bool(np.isfinite(lp).all()), f'stream {s.sid} output')
        runs[backend] = dict(lps=lps, launches=launches, steps=stats['steps'],
                             frames=stats['frames'], wall_s=wall,
                             frames_per_s=stats['frames'] / wall,
                             p50_chunk_ms=stats['p50_chunk_s'] * 1e3)
        print(f'engine [{backend}]: {len(utts)} utterances, '
              f'{stats["frames"]} frames, {slots} slots, chunk {chunk}, '
              f'{stats["steps"]} steps in {wall:.3f} s: '
              f'{stats["frames"] / wall:.1f} frames/s, p50 chunk '
              f'{stats["p50_chunk_s"] * 1e3:.3f} ms, launches {launches}',
              flush=True)
    L, steps = cfg.n_layers, runs['cuda_seq']['steps']
    check(runs['cuda_seq']['launches'] == dict(
        lstm_seq=L * steps, lstm_stack_seq_kernel=0),
        'cuda_seq must launch K1 L times per engine step')
    steps = runs['cuda_seq_fused']['steps']
    check(runs['cuda_seq_fused']['launches'] == dict(
        lstm_seq=0, lstm_stack_seq_kernel=steps),
        'cuda_seq_fused must launch K2 once per engine step')
    check(runs['torch_scan']['launches'] == dict(
        lstm_seq=0, lstm_stack_seq_kernel=0), 'torch_scan launched a kernel')

    fwd_cfg = cfg.replace(lstm_backend='cuda_seq_fused')
    worst = {}
    for i, u in enumerate(utts):
        frames = torch.from_numpy(u)[None].to(params.layers[0].w_h.device)
        mono = chipmunk_net.forward(fwd_cfg, params, frames)[:, 0].cpu().numpy()
        ref = runs['cuda_seq_fused']['lps'][i]
        for name, other in (('forward', mono),
                            ('cuda_seq', runs['cuda_seq']['lps'][i]),
                            ('torch_scan', runs['torch_scan']['lps'][i])):
            worst[name] = max(worst.get(name, 0.0),
                              float(np.abs(ref - other).max()))
            check(np.allclose(ref, other, rtol=ENGINE_RTOL, atol=ENGINE_ATOL),
                  f'utterance {i}: cuda_seq_fused vs {name} differ')
    print('engine streams allclose (rtol/atol '
          f'{ENGINE_RTOL}/{ENGINE_ATOL}), max abs diff vs cuda_seq_fused: '
          + ', '.join(f'{k} {v:.3e}' for k, v in worst.items()), flush=True)
    for r in runs.values():
        del r['lps']
    return runs, worst


def trace(fn, label: str):
    """One traced call of ``fn`` (after a warm call): device busy time from
    ``torch.profiler`` over the host wall time of the traced call, device
    time by kernel name, and the host ms under each ``record_function``
    label (a train step's phases, ``launch.train.PHASES``).  The tracer's
    own cost inflates the wall time, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = lambda e: getattr(e, 'self_device_time_total',
                               getattr(e, 'self_cuda_time_total', 0.0))
    events = prof.key_averages()
    marked = lambda e: bool(getattr(e, 'is_user_annotation', False))
    # device-side entries only (kernels, copies, sets): a host op's entry
    # repeats the time of the kernels it launched, and a label's device-side
    # span covers kernels already counted
    by_name = sorted(((e.key, dev_us(e), e.count) for e in events
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                      and not marked(e)),
                     key=lambda r: -r[1])
    busy_us = sum(r[1] for r in by_name)
    res = dict(backend=label, wall_ms=wall_us / 1e3,
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / wall_us,
               device_ops=sum(r[2] for r in by_name),
               top=[dict(name=k[:80], device_ms=t / 1e3, count=n)
                    for k, t, n in by_name[:10]],
               phases_host_ms={e.key: e.cpu_time_total / 1e3 for e in events
                               if marked(e)
                               and e.device_type == DeviceType.CPU})
    print(f'profile [{label}]: wall {res["wall_ms"]:.2f} ms, device busy '
          f'{res["device_busy_ms"]:.2f} ms in {res["device_ops"]} device '
          f'ops, idle share {res["idle_share"]:.3f}; top: ' + '; '.join(
              f'{r["name"][:40]} {r["device_ms"]:.2f} ms x{r["count"]}'
              for r in res['top'][:5]), flush=True)
    if res['phases_host_ms']:
        print(f'profile [{label}]: host ms by phase: ' + ', '.join(
            f'{k} {v:.3f}' for k, v in res['phases_host_ms'].items()),
            flush=True)
    return res


def profile_engine(cfg, params, slots: int, chunk: int, utts, backend: str):
    """One traced engine drain on ``backend`` (``trace``)."""
    from repro_torch.launch.serve import StreamServer

    def drain():
        server = StreamServer(cfg.replace(lstm_backend=backend), params,
                              num_slots=slots, chunk=chunk)
        for u in utts:
            server.submit(u)
        server.drain()

    return trace(drain, backend)


def quantize_stack(params):
    """Every layer on its silicon plan ``SystolicPlan(n_x, N_h, 96)``:
    ``pack_lstm`` -> ``quantize_packed`` (the reference example's deploy
    step), on the weights' device."""
    from repro_torch.core import systolic as sy
    return [sy.quantize_packed(sy.pack_lstm(lp, sy.SystolicPlan(
        lp.n_x, lp.n_h, sy.N_LSTM_SILICON))) for lp in params.layers]


def int8_kernel_checks(qps, B: int, T: int, rng, dev):
    """K3 (on both layer plans) and K4 against their plain versions at the
    serving shape, bit for bit; times and bounds per launch (K3 on layer
    0's plan)."""
    from repro_torch.core import quant, systolic as sy
    from repro_torch.core.lstm import valid_len_mask
    from repro_torch.kernels.lstm_seq import (lstm_seq_quantized,
                                              lstm_seq_quantized_ref,
                                              lstm_stack_seq_kernel_q,
                                              lstm_stack_seq_quantized_ref,
                                              stack_kernel_weights_q)
    from repro_torch.kernels.lstm_seq.ops import _dense_from_tiles
    L, p0 = len(qps), qps[0].plan
    N, P_h = p0.n_h, p0.padded_h
    xq = quant.quantize(torch.from_numpy(
        (rng.randn(T, B, p0.n_x) * 0.5).astype(np.float32)).to(dev))
    mask = valid_len_mask(T, torch.from_numpy(ragged_lens(rng, T, B)).to(dev),
                          B)
    n_live = int(mask.sum())

    def codes(*shape):   # nonzero carried codes; padded rows stay zero
        c = torch.from_numpy(rng.randint(-64, 64, shape).astype(np.int8))
        c[..., N:] = 0
        return c.to(dev)

    def diff(got, want):
        return max(int((g.int() - w.int()).abs().max())
                   for g, w in zip(got, want))

    rows, k3_args = [], None
    for qp in qps[:2]:                       # layer 0's plan, an inner plan
        plan = qp.plan
        xs_pad = torch.zeros((T, B, plan.padded_x), dtype=torch.int8,
                             device=dev)
        xs_pad[..., :plan.n_x] = (xq if plan.n_x == p0.n_x else
                                  codes(T, B, plan.n_x))
        args = (xs_pad, *_dense_from_tiles(qp), qp.sig_lut, qp.tanh_lut,
                codes(B, P_h), codes(B, P_h), mask)
        kw = dict(tile=plan.tile, cols_x=plan.cols_x)
        got = lstm_seq_quantized(*args, **kw)
        want = lstm_seq_quantized_ref(*args, **kw)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f'lstm_seq_quantized [{plan}]: T={T} B={B} live steps '
              f'{n_live}: torch.equal to plain version {same}', flush=True)
        check(same, f'lstm_seq_quantized disagrees with its plain version '
                    f'on {plan}')
        if k3_args is None:
            k3_args, k3_kw, k3_err = args, kw, diff(got, want)
    # bytes the function needs: unpadded codes and weights, each input read
    # once and each output written once (padding is the kernels' choice)
    plan = qps[0].plan
    nbytes = (T * B * plan.n_x + 4 * N * (plan.n_x + N) + 3 * N + 2 * 4 * N
              + 512 + 2 * B * N + T * B + 2 * T * B * N)
    rows.append(dict(
        name='lstm_seq_quantized', route='cuda',
        source='src/repro_torch/csrc/lstm_seq_q.cu',
        replaces='src/repro/kernels/lstm_seq/kernel.py:258',
        max_abs_err=k3_err, tol=0,
        ms=cuda_ms(lambda: lstm_seq_quantized(*k3_args, **k3_kw), 50),
        plain_ms=cuda_ms(lambda: lstm_seq_quantized_ref(*k3_args, **k3_kw),
                         3, warmup=1),
        bytes=nbytes, flops=n_live * (8 * N * (plan.n_x + N) + 30 * N),
        ops_per_s=INT8_OPS_PER_S, library_ms=None))

    build = lambda: stack_kernel_weights_q(qps)
    wts = build()
    stacking = dict(mbytes=1e-6 * sum(
        a.numel() * a.element_size() for a in
        (wts.w_in, wts.w_h, wts.peep, wts.bias,
         *(a for lw in wts.layers for a in lw))),
                    device_ms=cuda_ms(build, 20), host_ms=host_ms(build, 20))
    print(f"stack_kernel_weights_q: {stacking['mbytes']:.2f} MB (K3 and K4 "
          f"layouts) built once per set of quantized layers, device "
          f"{stacking['device_ms']:.4f} ms, host {stacking['host_ms']:.4f} ms "
          f"per build", flush=True)
    acc_x = sy.quantized_x_prefix(qps[0], xq).contiguous()
    args = (acc_x, wts.w_in, wts.w_h, wts.peep, wts.bias, wts.sig_lut,
            wts.tanh_lut, codes(L, B, P_h), codes(L, B, P_h), mask)
    kw = dict(tile=p0.tile)
    got = lstm_stack_seq_kernel_q(*args, **kw)
    want = lstm_stack_seq_quantized_ref(*args, **kw)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f'lstm_stack_seq_kernel_q: T={T} B={B} L={L} live steps {n_live}: '
          f'torch.equal to plain version {same}', flush=True)
    check(same, 'lstm_stack_seq_kernel_q disagrees with its plain version')
    # unpadded: acc_x's N rows, layer 0's own-h weights, the inner layers'
    # below-h and own-h weights, codes and outputs
    nbytes = (4 * T * B * 4 * N + 4 * N * N * (2 * L - 1) + 3 * L * N
              + 8 * L * N + 512 + 2 * L * B * N + T * B + 2 * L * T * B * N)
    rows.append(dict(
        name='lstm_stack_seq_kernel_q', route='cuda',
        source='src/repro_torch/csrc/lstm_stack_seq_q.cu',
        replaces='src/repro/kernels/lstm_seq/stack_kernel.py:382',
        max_abs_err=diff(got, want), tol=0,
        ms=cuda_ms(lambda: lstm_stack_seq_kernel_q(*args, **kw), 50),
        plain_ms=cuda_ms(lambda: lstm_stack_seq_quantized_ref(*args, **kw),
                         3, warmup=1),
        bytes=nbytes, flops=n_live * ((2 * L - 1) * 8 * N * N + 30 * L * N),
        ops_per_s=INT8_OPS_PER_S, library_ms=None))
    for r in rows:
        r['bound_ms'], r['bound_by'] = bound(r['bytes'], r['flops'],
                                             r['ops_per_s'])
        r['ok'] = r['max_abs_err'] == 0
        print(f"{r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}; {r['bytes'] / 1e6:.3f} MB)", flush=True)
    return rows, stacking


def int8_chunks(qps, xq, lens, chunk: int, weights, backend: str):
    """The int8 stack over ``xq`` (T, B, n_x) in chunks of ``chunk`` frames
    with the stack-layout carry and per-chunk valid lengths from ``lens``.
    Returns (top-layer codes (T, B, n_h), final (h_q, c_q))."""
    from repro_torch.kernels.lstm_seq import lstm_stack_seq_quantized_auto
    state, outs = None, []
    for lo in range(0, xq.shape[0], chunk):
        vl = torch.from_numpy(np.clip(lens - lo, 0, chunk)).to(xq.device)
        o, state = lstm_stack_seq_quantized_auto(
            qps, xq[lo:lo + chunk], state=state, valid_len=vl,
            return_state=True, weights=weights, backend=backend)
        outs.append(o)
    return torch.cat(outs), state


def int8_chunked_checks(qps, B: int, chunk: int, rng, dev):
    """int8 chunked == monolithic over 3 ragged chunks on both backends,
    and fused == layerwise == the reference chain on the valid prefix."""
    from repro_torch.core import quant, systolic as sy
    from repro_torch.kernels.lstm_seq import (lstm_stack_seq_quantized_auto,
                                              stack_kernel_weights_q)
    T = 3 * chunk
    xq = quant.quantize(torch.from_numpy(
        (rng.randn(T, B, qps[0].plan.n_x) * 0.5).astype(np.float32)).to(dev))
    lens = ragged_lens(rng, T, B)
    weights = stack_kernel_weights_q(qps)
    monos = {}
    for backend in ('fused', 'layerwise'):
        mono, fin = lstm_stack_seq_quantized_auto(
            qps, xq, valid_len=torch.from_numpy(lens).to(dev),
            return_state=True, weights=weights, backend=backend)
        got, state = int8_chunks(qps, xq, lens, chunk, weights, backend)
        same = (torch.equal(got, mono)
                and torch.equal(state[0], fin[0])
                and torch.equal(state[1], fin[1]))
        print(f'int8 chunked == monolithic [{backend}] T={T} in '
              f'{T // chunk} chunks, B={B}: {same}', flush=True)
        check(same, f'int8 chunked != monolithic on {backend}')
        monos[backend] = (mono, fin)
    chain = xq
    for qp in qps:
        chain = sy.systolic_layer_quantized(qp, chain)
    (fu, fu_fin), (lw, lw_fin) = monos['fused'], monos['layerwise']
    same = (torch.equal(fu, lw) and torch.equal(fu_fin[0], lw_fin[0])
            and torch.equal(fu_fin[1], lw_fin[1])
            and all(torch.equal(fu[:n, b], chain[:n, b])
                    for b, n in enumerate(lens)))
    print(f'int8 fused == layerwise == systolic_layer_quantized x'
          f'{len(qps)}: {same}', flush=True)
    check(same, 'int8 fused, layerwise and the reference chain disagree')


def int8_deploy(cfg, params, qps, chunk: int, utts, dev,
                profile: bool = False):
    """The int8 main path: the utterances as one ragged batch, in chunks of
    ``chunk`` frames with the stack-layout carry, on ``auto`` (must resolve
    to ``fused``) and ``layerwise``; launch counts of each backend's first
    pass, the wall times of ``INT8_REPEATS`` more passes of each,
    interleaved, (with ``profile``) a trace of ``INT8_PROFILE_PASSES``
    passes of each, then the f32 read-out of the dequantized codes and
    greedy decode against the f32 ``forward``."""
    from repro_torch.core import quant
    from repro_torch.core.ctc import ctc_greedy_decode
    from repro_torch.core.lstm import readout
    from repro_torch.kernels.lstm_seq import (lstm_seq_quantized,
                                              lstm_stack_seq_kernel_q,
                                              stack_kernel_weights_q)
    from repro_torch.models import chipmunk_net
    B, L = len(utts), len(qps)
    lens = np.array([len(u) for u in utts])
    n_frames = int(lens.sum())
    T = -(-int(lens.max()) // chunk) * chunk
    frames = np.zeros((T, B, cfg.lstm_inputs), np.float32)
    for b, u in enumerate(utts):
        frames[:len(u), b] = u
    xq = quant.quantize(torch.from_numpy(frames).to(dev))
    weights = stack_kernel_weights_q(qps)
    n_chunks = T // chunk
    backends = ('auto', 'layerwise')

    def deploy(backend):
        return int8_chunks(qps, xq, lens, chunk, weights, backend)[0]

    def timed(backend):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = deploy(backend)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs, codes = {}, {}
    for backend in backends:
        lstm_seq_quantized.launches = 0
        lstm_stack_seq_kernel_q.launches = 0
        codes[backend], wall = timed(backend)
        launches = dict(lstm_seq_quantized=lstm_seq_quantized.launches,
                        lstm_stack_seq_kernel_q=lstm_stack_seq_kernel_q
                        .launches)
        runs[backend] = dict(launches=launches, chunks=n_chunks,
                             frames=n_frames, first_wall_s=wall, walls_s=[])
        print(f'int8 deploy [{backend}]: {B} utterances, {n_frames} frames, '
              f'{n_chunks} chunks of {chunk}: first pass {wall:.4f} s, '
              f'launches {launches}', flush=True)
    for _ in range(INT8_REPEATS):
        for backend in backends:
            runs[backend]['walls_s'].append(timed(backend)[1])
    for backend in backends:
        r = runs[backend]
        rates = sorted(n_frames / w for w in r['walls_s'])
        r.update(frames_per_s=float(np.median(rates)),
                 frames_per_s_min=rates[0], frames_per_s_max=rates[-1])
        print(f'int8 deploy [{backend}]: {INT8_REPEATS} timed passes, '
              f'interleaved: median {r["frames_per_s"]:.0f} frames/s '
              f'(min {rates[0]:.0f}, max {rates[-1]:.0f})', flush=True)
    profiles = [trace(lambda b=b: [deploy(b)
                                   for _ in range(INT8_PROFILE_PASSES)],
                      f'int8 {b} x{INT8_PROFILE_PASSES}')
                for b in (backends if profile else ())]
    check(runs['auto']['launches'] == dict(
        lstm_seq_quantized=0, lstm_stack_seq_kernel_q=n_chunks),
        'int8 auto must resolve to fused: one K4 launch per chunk')
    check(runs['layerwise']['launches'] == dict(
        lstm_seq_quantized=L * n_chunks, lstm_stack_seq_kernel_q=0),
        'int8 layerwise must launch K3 L times per chunk')
    check(torch.equal(codes['auto'], codes['layerwise']),
          'int8 fused and layerwise deploy codes differ')

    h = quant.dequantize(codes['auto'], quant.STATE_FMT)
    lp_q = torch.log_softmax(readout(params.w_out, params.b_out, h), dim=-1)
    check(bool(torch.isfinite(lp_q).all()) and lp_q.shape == (
        T, B, cfg.n_outputs), 'int8 log-probs not finite or misshapen')
    agree, frame_agree = [], []
    for b, u in enumerate(utts):
        n = len(u)
        lp_f = chipmunk_net.forward(cfg.replace(lstm_backend='cuda_seq_fused'),
                                    params, torch.from_numpy(u)[None].to(dev))
        dq, nq = ctc_greedy_decode(lp_q[:n, b:b + 1])
        df, nf = ctc_greedy_decode(lp_f)
        agree.append(torch.equal(dq[0, :int(nq[0])], df[0, :int(nf[0])]))
        frame_agree.append(float((lp_q[:n, b].argmax(-1)
                                  == lp_f[:, 0].argmax(-1)).float().mean()))
    res = dict(runs=runs, profiles=profiles,
               decode_agreement=float(np.mean(agree)),
               frame_argmax_agreement=float(np.mean(frame_agree)))
    print(f'int8 systolic deployment: greedy decode agreement with f32 '
          f'{res["decode_agreement"] * 100:.0f}% across {B} utterances '
          f'(frame argmax agreement {res["frame_argmax_agreement"]:.3f}; '
          f'random weights: reported, not asserted)', flush=True)
    return res


def gates_kernel_checks(cfg, params, B: int, T: int, rng, dev):
    """K5 against its plain version at the training shape (B streams, N_h
    hidden units, an inner layer's weights, nonzero h and c); times it, its
    plain version and the product alone; then ``cuda_step`` against
    ``cuda_seq`` over ``T`` steps."""
    from repro_torch.core.lstm import lstm_layer_fused
    from repro_torch.kernels.lstm_gates import (lstm_gates_rec,
                                                lstm_gates_rec_ref)
    f32 = lambda *s: torch.from_numpy(
        (rng.randn(*s) * 0.5).astype(np.float32)).to(dev)
    lp = params.layers[1]
    N = lp.n_h
    args = (f32(B, N), lp.w_h, f32(B, 4, N), lp.w_peep, lp.b, f32(B, N))
    got, want = lstm_gates_rec(*args), lstm_gates_rec_ref(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    h, w_h, pre = args[:3]
    w_rows = w_h.reshape(4 * N, N)
    pre_rows = pre.reshape(B, 4 * N)
    product = lambda: torch.addmm(pre_rows, h, w_rows.T)
    row = dict(
        name='lstm_gates_rec', route='cuda',
        source='src/repro_torch/csrc/lstm_gates_rec.cu',
        replaces='src/repro/kernels/lstm_gates/kernel.py:79',
        max_abs_err=err, tol=KERNEL_ATOL,
        ms=cuda_ms(lambda: lstm_gates_rec(*args), 200),
        plain_ms=cuda_ms(lambda: lstm_gates_rec_ref(*args), 50),
        product_only_ms=cuda_ms(product, 200),
        # inputs h, W_h, pre, peep, bias, c once; outputs h, c once
        bytes=4 * (4 * N * N + 7 * N + B * N + 4 * B * N + B * N
                   + 2 * B * N),
        flops=8 * B * N * N + 30 * B * N, library_ms=None)
    row['bound_ms'], row['bound_by'] = bound(row['bytes'], row['flops'])
    row['ok'] = err <= KERNEL_ATOL
    print(f"lstm_gates_rec: B={B} N_h={N}: max_abs_err {err:.3e} (tol "
          f"{KERNEL_ATOL}), kernel {row['ms']:.5f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']}; {row['bytes'] / 1e6:.3f} MB), library none "
          f"(product only, torch.addmm: {row['product_only_ms']:.5f} ms)",
          flush=True)
    check(row['ok'], 'lstm_gates_rec disagrees with its plain version')

    xs, h0, c0 = f32(T, B, lp.n_x), f32(B, N), f32(B, N)
    step, seq = (lstm_layer_fused(lp, xs, h0, c0, backend=b)
                 for b in ('cuda_step', 'cuda_seq'))
    err = max(float((a - b).abs().max()) for a, b in
              ((step[0], seq[0]), (step[1][0], seq[1][0]),
               (step[1][1], seq[1][1])))
    print(f'lstm_layer_fused cuda_step vs cuda_seq: T={T} B={B}: max abs '
          f'diff {err:.3e} (tol {KERNEL_ATOL})', flush=True)
    check(err <= KERNEL_ATOL, 'cuda_step and cuda_seq layers disagree')
    return row


def _train_batch(cfg, T: int, B: int, step: int, dev):
    """``SyntheticCTC``'s batch ``step`` at (T, B), on ``dev``."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticCTC
    host = SyntheticCTC(cfg, ShapeConfig('smoke', 'train', T, B)).host_batch(
        step, 0, B)
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def grad_checks(cfg, dev):
    """Every leaf's gradient of ``loss_fn`` on each kernel backend against
    the ``torch_scan`` Function's, by relative Frobenius error."""
    from repro_torch.launch.train import _grads_of, init_train_state
    from repro_torch.models import chipmunk_net
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.tree import flatten_with_paths
    params = init_train_state(cfg, adamw(cosine_schedule(1e-3, 1, 2)),
                              dev, seed=SEED)['params']
    batch = _train_batch(cfg, GRAD_T, TRAIN_BATCH, 0, dev)
    grads = {}
    for b in ('torch_scan',) + TRAIN_BACKENDS:
        loss_fn = lambda p, x, c=cfg.replace(lstm_backend=b): \
            chipmunk_net.loss_fn(c, p, x)
        grads[b] = flatten_with_paths(_grads_of(loss_fn, params, batch)[1])
    worst = {}
    for b in TRAIN_BACKENDS:
        rel = [float(torch.linalg.vector_norm(g - r)
                     / torch.linalg.vector_norm(r))
               for (_, g), (_, r) in zip(grads[b], grads['torch_scan'])]
        finite = all(bool(torch.isfinite(g).all()) for _, g in grads[b])
        worst[b] = max(rel)
        print(f'grads [{b}] vs torch_scan: T={GRAD_T} B={TRAIN_BATCH}, '
              f'{len(rel)} leaves: max relative Frobenius error '
              f'{worst[b]:.3e} (tol {GRAD_REL_TOL}), finite {finite}',
              flush=True)
        check(finite and worst[b] <= GRAD_REL_TOL,
              f'{b} gradients disagree with torch_scan')
    return worst


def train_runs(cfg, dev, profile: bool = False):
    """``TRAIN_STEPS`` train steps at (``TRAIN_SEQ``, ``TRAIN_BATCH``) on
    each kernel backend from the same weights and batches, with per-step
    launch counts and host-clock step times; the checkpoint round trip on
    ``cuda_step``; (with ``profile``) one traced step per backend."""
    import functools
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.lstm_gates import lstm_gates_rec
    from repro_torch.kernels.lstm_seq import lstm_seq, lstm_stack_seq_kernel
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models import chipmunk_net
    from repro_torch.optim import cosine_schedule, make_optimizer
    counters = (lstm_gates_rec, lstm_seq, lstm_stack_seq_kernel)
    L, T, B = cfg.n_layers, TRAIN_SEQ, TRAIN_BATCH
    want = dict(cuda_step=dict(lstm_gates_rec=T * L, lstm_seq=0,
                               lstm_stack_seq_kernel=0),
                cuda_seq=dict(lstm_gates_rec=0, lstm_seq=L,
                              lstm_stack_seq_kernel=0),
                cuda_seq_fused=dict(lstm_gates_rec=0, lstm_seq=0,
                                    lstm_stack_seq_kernel=1))
    batches = [_train_batch(cfg, T, B, k, dev) for k in range(TRAIN_STEPS)]
    runs, profiles = {}, []
    for backend in TRAIN_BACKENDS:
        c = cfg.replace(lstm_backend=backend)
        opt = make_optimizer(c.optimizer, cosine_schedule(1e-3, 10,
                                                          TRAIN_STEPS))
        step_fn = make_train_step(functools.partial(chipmunk_net.loss_fn, c),
                                  opt)
        state = init_train_state(c, opt, dev, seed=SEED)
        losses, walls, launches, ckpt = [], [], [], None
        tmp = tempfile.TemporaryDirectory()
        mgr = CheckpointManager(tmp.name)
        for k, batch in enumerate(batches):
            if k == TRAIN_CKPT_STEP:
                mgr.save(k, state, blocking=True)
            torch.cuda.synchronize()
            for f in counters:
                f.launches = 0
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append({f.__name__: f.launches for f in counters})
            losses.append(m['loss'])
        check(all(n == want[backend] for n in launches),
              f'{backend}: launches per train step {launches[-1]}, '
              f'expected {want[backend]}')
        check(all(bool(torch.isfinite(x)) for x in losses),
              f'{backend}: a loss is not finite')
        if backend == TRAIN_BACKENDS[0]:
            fresh = init_train_state(c, opt, dev, seed=SEED + 1)
            restored = mgr.restore(fresh)
            _, m = step_fn(restored, batches[TRAIN_CKPT_STEP])
            ckpt = bool(torch.equal(m['loss'], losses[TRAIN_CKPT_STEP]))
            print(f'train [{backend}]: restored step {TRAIN_CKPT_STEP} '
                  f'into a fresh state; next loss {float(m["loss"])!r} vs '
                  f'uninterrupted {float(losses[TRAIN_CKPT_STEP])!r}: '
                  f'bit-equal {ckpt}', flush=True)
            check(ckpt, 'resumed loss differs from the uninterrupted run')
        tmp.cleanup()
        if profile:
            profiles.append(trace(lambda: step_fn(state, batches[-1]),
                                  f'train {backend}'))
        step_ms = float(np.median(walls[1:])) * 1e3
        runs[backend] = dict(
            losses=[float(x) for x in losses], step_ms=step_ms,
            step_ms_all=[w * 1e3 for w in walls],
            frames_per_s=B * T / step_ms * 1e3, launches=launches[-1],
            checkpoint_bit_equal=ckpt)
        print(f'train [{backend}]: {TRAIN_STEPS} steps of B={B} T={T}: '
              f'losses {[round(x, 4) for x in runs[backend]["losses"]]}, '
              f'median step {step_ms:.3f} ms after the first '
              f'({B * T / step_ms * 1e3:.1f} frames/s), launches per step '
              f'{launches[-1]}', flush=True)
    ref = np.array(runs[TRAIN_BACKENDS[0]]['losses'])
    for backend in TRAIN_BACKENDS[1:]:
        got = np.array(runs[backend]['losses'])
        diff = float(np.max(np.abs(got - ref) / np.abs(ref)))
        runs[backend]['max_rel_loss_diff'] = diff
        print(f'train loss histories {backend} vs {TRAIN_BACKENDS[0]}: max '
              f'relative difference {diff:.3e} (rtol {LOSS_RTOL})',
              flush=True)
        check(diff <= LOSS_RTOL, f'{backend} loss history disagrees')
    return runs, profiles


def train_cli(cfg):
    """The trainer's entry point on the card, as a user runs it:
    ``launch.train.main`` on ``cuda_step`` for ``TRAIN_STEPS`` steps at its
    default batch and sequence with a checkpoint every ``TRAIN_CKPT_STEP``
    steps, then again with ``--resume`` for ``TRAIN_RESUME_STEPS`` more.
    Checks the printed losses are finite, the resume line, the final
    checkpoint's step, and K5's launches per step on both runs."""
    import contextlib
    import io
    import re
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.lstm_gates import lstm_gates_rec
    from repro_torch.launch import train
    per_step = TRAIN_SEQ * cfg.n_layers
    end = TRAIN_STEPS + TRAIN_RESUME_STEPS
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, steps, extra in (('fresh', TRAIN_STEPS, []),
                                   ('resume', end, ['--resume'])):
            argv = ['--lstm-backend', 'cuda_step', '--steps', str(steps),
                    '--ckpt-every', str(TRAIN_CKPT_STEP), '--ckpt-dir', tmp,
                    '--log-every', '1'] + extra
            out = io.StringIO()
            lstm_gates_rec.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                train.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = lstm_gates_rec.launches
            text = out.getvalue()
            losses = [float(x) for x in re.findall(r' loss +(\S+)', text)]
            ran = steps - (TRAIN_STEPS if extra else 0)
            res[name] = dict(argv=argv, wall_s=wall, losses=losses,
                             lstm_gates_rec=launches)
            print(f'train CLI [{name}]: {ran} steps in {wall:.2f} s, '
                  f'losses {losses}, K5 launches {launches}', flush=True)
            check('done' in text, f'train CLI [{name}] did not finish')
            check(len(losses) == ran and all(np.isfinite(losses)),
                  f'train CLI [{name}]: losses {losses}')
            check(launches == ran * per_step,
                  f'train CLI [{name}]: {launches} K5 launches, expected '
                  f'{ran * per_step}')
        check(f'resumed at step {TRAIN_STEPS}' in text,
              'train CLI did not resume from its checkpoint')
        check(CheckpointManager(tmp).latest_step() == end,
              'train CLI did not checkpoint its last step')
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description='chip smoke test of the port')
    ap.add_argument('--out', default=None,
                    help='also write the full results to this JSON file')
    ap.add_argument('--profile', action='store_true',
                    help='also trace one engine drain per f32 kernel '
                         'backend, int8 deploy passes per int8 backend and '
                         'one train step per kernel backend with '
                         'torch.profiler (device busy/idle share, time by '
                         'kernel)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / 'src'))
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import chipmunk_net

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)

    t0 = time.perf_counter()
    names = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f'build: {len(names)} kernels ({", ".join(names)}) in '
          f'{build_s:.1f} s', flush=True)

    cfg = configs.get_config('chipmunk-ctc')
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(SEED),
                               device=dev)
    rng = np.random.RandomState(SEED)
    rows, stacking = kernel_checks(cfg, params, SLOTS, CHUNK, rng, dev)
    chunked_checks(params, SLOTS, CHUNK, rng, dev)
    utts = [(rng.randn(rng.randint(50, 301), cfg.lstm_inputs) * 0.5
             ).astype(np.float32) for _ in range(REQUESTS)]
    runs, worst = engine_runs(cfg, params, SLOTS, CHUNK, utts)
    profiles = [profile_engine(cfg, params, SLOTS, CHUNK, utts, b)
                for b in (('cuda_seq_fused', 'cuda_seq') if args.profile
                          else ())]

    qps = quantize_stack(params)
    q_rows, q_stacking = int8_kernel_checks(qps, SLOTS, CHUNK, rng, dev)
    int8_chunked_checks(qps, SLOTS, CHUNK, rng, dev)
    q_utts = [(rng.randn(rng.randint(50, 301), cfg.lstm_inputs) * 0.5
               ).astype(np.float32) for _ in range(INT8_UTTERANCES)]
    deploy = int8_deploy(cfg, params, qps, CHUNK, q_utts, dev,
                         profile=args.profile)
    rows += q_rows

    train_cfg = configs.get_config('chipmunk-ctc')
    rows.append(gates_kernel_checks(train_cfg, params, TRAIN_BATCH, CHUNK,
                                    rng, dev))
    grad_err = grad_checks(train_cfg, dev)
    train, train_profiles = train_runs(train_cfg, dev, profile=args.profile)
    profiles += train_profiles
    cli = train_cli(train_cfg)

    launches = dict(lstm_seq=runs['cuda_seq']['launches']['lstm_seq'],
                    lstm_stack_seq_kernel=runs['cuda_seq_fused']['launches']
                    ['lstm_stack_seq_kernel'],
                    lstm_seq_quantized=deploy['runs']['layerwise']
                    ['launches']['lstm_seq_quantized'],
                    lstm_stack_seq_kernel_q=deploy['runs']['auto']
                    ['launches']['lstm_stack_seq_kernel_q'],
                    lstm_gates_rec=train['cuda_step']['launches']
                    ['lstm_gates_rec'])
    for r in rows:
        r['launches'] = launches[r['name']]
        check(r['launches'] > 0, f"{r['name']} never launched on the path")
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'tol',
            'ok')
    kernels = {'kernels': [{k: r[k] for k in keys} for r in rows]}
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            card=card, build_s=build_s, slots=SLOTS, chunk=CHUNK,
            torch=torch.__version__, cuda=torch.version.cuda,
            kernels=rows, stack_kernel_weights=stacking, engine=runs,
            engine_max_abs_diff=worst, profiles=profiles,
            stack_kernel_weights_q=q_stacking, int8_deploy=deploy,
            train_grad_rel_err=grad_err, train=train, train_cli=cli),
            indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
