#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile]

Drives the port's serving path at the full CTC-3L-421H-UNI width (123 MFCC
features -> 3x421 peephole LSTM -> 62 CTC outputs, random weights from a
seed) and checks it:

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
   and one K2 launch per step on ``cuda_seq_fused``.

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
KERNEL_ATOL = 1e-4            # kernel vs plain version, f32 state/outputs
ENGINE_ATOL = 1e-4            # log-probs across backends / vs forward
ENGINE_RTOL = 1e-4
SLOTS, CHUNK = 8, 16          # the serving shape: B = slots, T = chunk
REQUESTS, SEED = 12, 0        # utterances of 50-300 frames, weights seed


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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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


def profile_engine(cfg, params, slots: int, chunk: int, utts, backend: str):
    """One traced drain on ``backend`` (after a warm drain): device busy
    time from ``torch.profiler`` over the host wall time of the traced
    drain, and device time by kernel name.  The tracer's own cost inflates
    the wall time, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import StreamServer

    def drain():
        server = StreamServer(cfg.replace(lstm_backend=backend), params,
                              num_slots=slots, chunk=chunk)
        for u in utts:
            server.submit(u)
        server.drain()
        torch.cuda.synchronize()

    drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drain()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = lambda e: getattr(e, 'self_device_time_total',
                               getattr(e, 'self_cuda_time_total', 0.0))
    # device-side entries only (kernels, copies, sets): a host op's entry
    # repeats the time of the kernels it launched
    by_name = sorted(((e.key, dev_us(e), e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=lambda r: -r[1])
    busy_us = sum(r[1] for r in by_name)
    res = dict(backend=backend, wall_ms=wall_us / 1e3,
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / wall_us,
               top=[dict(name=k[:80], device_ms=t / 1e3, count=n)
                    for k, t, n in by_name[:10]])
    print(f'profile [{backend}]: wall {res["wall_ms"]:.2f} ms, device busy '
          f'{res["device_busy_ms"]:.2f} ms, idle share '
          f'{res["idle_share"]:.3f}; top: ' + '; '.join(
              f'{r["name"][:40]} {r["device_ms"]:.2f} ms x{r["count"]}'
              for r in res['top'][:5]), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description='chip smoke test of the port')
    ap.add_argument('--out', default=None,
                    help='also write the full results to this JSON file')
    ap.add_argument('--profile', action='store_true',
                    help='also trace one engine drain per kernel backend '
                         'with torch.profiler (device busy/idle share, '
                         'time by kernel)')
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

    launches = dict(lstm_seq=runs['cuda_seq']['launches']['lstm_seq'],
                    lstm_stack_seq_kernel=runs['cuda_seq_fused']['launches']
                    ['lstm_stack_seq_kernel'])
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
            engine_max_abs_diff=worst,
            profiles=profiles), indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
