"""A batch entry under a closed backlog: padded batches of whole requests
back to back (``traffic.batches()``: pools sorted by length, cut into
batches of ``cell['batch']``, in seeded order), each ending in a
synchronize, its commit.  ``warmup_batches`` first, then the window, then
(traced runs) ``trace_s`` more.  Only real frames count.

Each batch of the window keeps its longest row and ``rows_per_batch`` rows
drawn from the seed; the sample is up to ``sample.max`` of those, drawn
from the seed, and the longest of all.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import gen
from bench.readers import Traced


def _batch_frames(pool: torch.Tensor, traffic: gen.Traffic, rows, T: int):
    """(B, T, n_x) frames of a padded batch: each row a window of the pool,
    zero past its length; and the lengths."""
    dev = pool.device
    offs = torch.tensor([traffic.offset(int(i)) for i in rows], device=dev)
    lens = torch.tensor([traffic.length(int(i)) for i in rows], device=dev)
    steps = torch.arange(T, device=dev)
    idx = (offs[:, None] + steps[None, :]).clamp_max(pool.shape[0] - 1)
    live = (steps[None, :] < lens[:, None]).unsqueeze(-1)
    return pool[idx] * live, lens


def drive(system, traffic: gen.Traffic, pool: torch.Tensor, cell: dict,
          seconds: float, tracer, t_proc: float, seed: int) -> dict:
    it = traffic.batches()
    pick = gen.rng_for(seed, 'sample')

    def one(calls=None, kept=None):
        rows, T = next(it)
        with torch.profiler.record_function('bench.inputs'):
            frames, lens = _batch_frames(pool, traffic, rows, T)
        with torch.profiler.record_function('bench.run'):
            codes, lp = system.run(frames)
        if pool.device.type == 'cuda':
            torch.cuda.synchronize(pool.device)
        lens_h = lens.cpu().numpy()
        real = int(lens_h.sum())
        if calls is not None:
            calls.append((T, len(rows), real))
        if kept is not None:
            take = {int(np.argmax(lens_h))} | set(pick.choice(
                len(rows), cell['sample']['rows_per_batch'],
                replace=False).tolist())
            for j in sorted(take):
                L = int(lens_h[j])
                kept.append(dict(i=int(rows[j]), length=L,
                                 codes=codes[:L, j].cpu(),
                                 lp=lp[:L, j].cpu()))
        return len(rows), real

    for _ in range(cell['warmup_batches']):
        one()
    t0 = time.perf_counter()
    kept, frames_done, n_req = [], 0, 0
    while time.perf_counter() - t0 < seconds:
        n, real = one(kept=kept)
        n_req += n
        frames_done += real
    t1 = time.perf_counter()
    trace = None
    if tracer is not None:
        calls = []
        tracer.start()
        while tracer.elapsed() < cell['trace_s']:
            one(calls=calls)
        trace = (tracer.stop(), Traced(calls=calls))

    rng = gen.rng_for(seed, 'pick')
    longest = max(range(len(kept)), key=lambda k: kept[k]['length'])
    others = [k for k in range(len(kept)) if k != longest]
    chosen = sorted(rng.permutation(others)[:cell['sample']['max']]
                    .tolist()) + [longest]
    sample = []
    for k in chosen:
        s = kept[k]
        off = traffic.offset(s['i'])
        s['frames'] = pool[off:off + s['length']].cpu().numpy()
        sample.append(s)
    return dict(setup_s=t0 - t_proc, window_s=t1 - t0, frames=frames_done,
                attempted=n_req, failed=0, trace=trace, sample=sample)
