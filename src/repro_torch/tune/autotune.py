"""Measured-schedule autotuner on one card: interleaved timed trials.

Port of the single-device half of ``repro.tune.autotune``.  Each trial
runs its candidates in turns (A/B/A/B per iteration, so a busy host window
hits every candidate alike), each call ending in ``torch.cuda.synchronize``
on the card, and records the winner in a ``schedule.ScheduleCache``.
Tuning is offline: serving consults the saved cache and never pays for a
trial at request time.

Every candidate a trial compares gives the same bits by construction (K4
and the K3 chain are bit-identical; chunk boundaries are scheduling-only),
and each trial checks that with ``torch.equal`` before it times anything,
so a trial can only choose among proven-identical schedules.

Not ported yet (ROADMAP queue 1 item 6): ``tune_staged_stack``,
``tune_geometry`` and the staged ``stack_f32`` prediction of
``tune_serving_config`` need the multi-device staged forward; ``lb`` has
no counterpart on the port's K2 (``shmoo.py``).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .schedule import ANY_MESH, ScheduleCache, ScheduleEntry, host_fingerprint
from .shmoo import TC_GRID, ShmooRecord

def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def measure_interleaved(fns: Sequence[Callable[[], object]], *,
                        iters: int = 3, warmup: int = 1,
                        device='cuda') -> List[float]:
    """Median wall-clock us of each thunk, interleaved A/B/C per iteration
    so host-load drift hits every candidate equally; each call ends in a
    synchronize on a CUDA ``device``, so its time includes the device
    work it queued."""
    for fn in fns:
        for _ in range(warmup):
            fn()
            _sync(device)
    walls: List[List[float]] = [[] for _ in fns]
    for _ in range(iters):
        for i, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            walls[i].append(time.perf_counter() - t0)
    return [sorted(w)[len(w) // 2] * 1e6 for w in walls]


# ---------------------------------------------------------------------------
# Int8 stack backend: K4 (fused wavefront) against the K3 chain
# ---------------------------------------------------------------------------

def quantized_trial(n_x: int, n_h: int, n_layers: int, T: int, B: int,
                    tile: int, *, iters: int = 3, warmup: int = 1,
                    device='cuda') -> Tuple[float, float]:
    """Median us of the layerwise chain and of the fused stack (in that
    order) on one seeded stack at ``(T, B)``, interleaved, through
    ``lstm_stack_seq_quantized_auto`` with the weight layouts built once (as
    a deploy builds them); no admission prune, so past a kernel's single
    launch it times the batch blocks.  Raises ``AssertionError`` unless
    both give the same codes and final states."""
    from ..core import lstm, quant, systolic
    from ..kernels.lstm_seq import (lstm_stack_seq_quantized_auto,
                                    stack_kernel_weights_q)
    stack = lstm.stack_params_to(lstm.init_lstm_stack(
        n_x, n_h, n_layers, None, torch.Generator().manual_seed(7)), device)
    qps = [systolic.quantize_packed(systolic.pack_lstm(
        lp, systolic.SystolicPlan(lp.n_x, n_h, tile))) for lp in stack.layers]
    xs = torch.randn((T, B, n_x), generator=torch.Generator().manual_seed(8))
    xs_q = quant.quantize(xs.mul_(0.5).to(device), quant.STATE_FMT)
    weights = stack_kernel_weights_q(qps)
    runs = [lambda b=b: lstm_stack_seq_quantized_auto(
        qps, xs_q, return_state=True, weights=weights, backend=b)
        for b in ('layerwise', 'fused')]
    (lw, (lw_h, lw_c)), (fu, (fu_h, fu_c)) = (f() for f in runs)
    if not (torch.equal(lw, fu) and torch.equal(lw_h, fu_h)
            and torch.equal(lw_c, fu_c)):
        raise AssertionError(f'K4 and the K3 chain disagree at n_x={n_x} '
                             f'n_h={n_h} L={n_layers} T={T} B={B} '
                             f'tile={tile}')
    us_lw, us_fu = measure_interleaved(runs, iters=iters, warmup=warmup,
                                       device=device)
    return us_lw, us_fu


def tune_quantized_backend(n_x: int, n_h: int, n_layers: int, T: int, B: int,
                           *, tile: Optional[int] = None,
                           cache: Optional[ScheduleCache] = None,
                           iters: int = 3, warmup: int = 1,
                           measure: bool = True, device='cuda'
                           ) -> Tuple[ScheduleEntry, List[ShmooRecord]]:
    """Measure the int8 stack decision ``'fused'`` (K4) against
    ``'layerwise'`` (K3 per layer) that ``core.lstm
    .select_quantized_stack_backend`` otherwise takes from the cold rule.

    The key holds no tile, so run the trial at the tile the deploy runs at
    (96 for CTC-3L-421H; ``min(n_h, 128)`` when None, the reference's
    default); the records name it.  On CUDA, a fused launch that cannot
    take the whole batch (``quantized_fused_admissible``) prunes the trial:
    the entry is a predicted ``'layerwise'``.  ``measure=False`` records the
    cold rule's own answer (``source='predicted'``), with no clock and no
    device work, so a cache can be made deterministically.  Returns
    ``(entry, records)`` and records the entry in ``cache`` when given."""
    from ..core.lstm import cold_quantized_backend, quantized_fused_admissible
    tile = tile or min(n_h, 128)
    key = dict(kind='q_stack_backend', n_x=n_x, n_h=n_h, n_layers=n_layers,
               T=T, B=B, mesh=ANY_MESH)
    records: List[ShmooRecord] = []
    if (torch.device(device).type == 'cuda' and not
            quantized_fused_admissible(n_h, n_layers, B, device, tile)):
        entry = ScheduleEntry(backend='layerwise', source='predicted', **key)
    elif not measure:
        entry = ScheduleEntry(
            backend=cold_quantized_backend(n_h, n_layers, T),
            source='predicted', **key)
    else:
        us_lw, us_fu = quantized_trial(n_x, n_h, n_layers, T, B, tile,
                                       iters=iters, warmup=warmup,
                                       device=device)
        for name, us in (('layerwise', us_lw), ('fused', us_fu)):
            records.append(ShmooRecord(
                suite='q_stack_backend',
                params={'n_x': n_x, 'n_h': n_h, 'n_layers': n_layers,
                        'T': T, 'B': B, 'tile': tile, 'backend': name},
                metrics={'measured_us': us}))
        entry = ScheduleEntry(
            backend='layerwise' if us_lw <= us_fu else 'fused',
            measured_us=min(us_lw, us_fu), source='measured',
            host=host_fingerprint(device), **key)
    if cache is not None:
        cache.record(entry)
    return entry, records


# ---------------------------------------------------------------------------
# Serving: the entries the engine and the int8 deploy consult
# ---------------------------------------------------------------------------

def _serving_workload(n_in: int, slots: int, chunk: int
                      ) -> List[np.ndarray]:
    """Deterministic per-stream frame arrays for the serving-loop trial:
    ``slots`` streams of ``2.5 * chunk`` frames, long enough that every
    candidate steps several chunks and hits a ragged tail (packing,
    masking and retirement all run), short enough to trial fast."""
    rng = np.random.RandomState(1234)
    n = 2 * chunk + max(1, chunk // 2)
    return [(rng.randn(n, n_in) * 0.5).astype(np.float32)
            for _ in range(slots)]


def tune_serving_config(cfg, *, chunk: int, slots: int,
                        cache: Optional[ScheduleCache] = None,
                        measure: bool = True, iters: int = 2, params=None,
                        device='cuda'
                        ) -> Tuple[List[ScheduleEntry], List[ShmooRecord]]:
    """The ``launch/serve.py --tune`` entry point: record the cache entries
    serving consults for ``cfg``'s LSTM stack.

    (1) The int8 backend at the serving chunk shape ``(chunk, slots)``,
    keyed by the stack's real ``n_x``, at the deploy's tile (the
    silicon's 96, ``core.systolic.N_LSTM_SILICON``).  (2) With ``measure``, the end-to-end
    serving-loop chunk ceiling (``kind='serving_chunk'``): one
    ``StreamingEngine`` per depth in ``{t in TC_GRID, t < chunk} | {chunk}``
    runs the whole engine loop (packing, masking, admission, retirement)
    over a fixed workload; the streams' log-probs must be ``torch.equal``
    across depths before the interleaved timing.  ``tuned_chunk_ceiling``
    consults that entry.  ``params`` defaults to ``serve``'s own
    (``chipmunk_net.init`` from seed 0 on ``device``).  The reference's
    predicted staged ``stack_f32`` ceiling waits for the multi-device port.
    Returns ``(entries, records)``."""
    from ..core.systolic import N_LSTM_SILICON
    n_x, n_h, L = cfg.lstm_inputs, cfg.lstm_hidden, cfg.n_layers
    ent, records = tune_quantized_backend(
        n_x, n_h, L, chunk, slots, tile=N_LSTM_SILICON, cache=cache,
        measure=measure, iters=iters, device=device)
    entries = [ent]
    if not measure:
        return entries, records

    from ..models import chipmunk_net
    from ..serving.engine import StreamingEngine
    if params is None:
        params = chipmunk_net.init(cfg, torch.Generator().manual_seed(0),
                                   device=device)
    streams = _serving_workload(n_x, slots, chunk)
    depths = serving_depths(chunk)
    engines = [StreamingEngine(cfg, params, max_streams=slots, chunk=d)
               for d in depths]

    def run_once(eng):
        before = len(eng.sched.done)
        for f in streams:
            eng.submit(f)
        return eng.run()[before:]

    outs = []
    for eng in engines:
        done = sorted(run_once(eng), key=lambda s: s.sid)
        outs.append([torch.from_numpy(s.full_log_probs()) for s in done])
    for d, o in zip(depths[1:], outs[1:]):  # chunk boundaries: scheduling
        if len(o) != len(outs[0]) or not all(
                torch.equal(a, b) for a, b in zip(outs[0], o)):
            raise AssertionError(f'serving log-probs at chunk depth {d} '
                                 f'differ from depth {depths[0]}')
    meds = measure_interleaved([lambda e=e: run_once(e) for e in engines],
                               iters=iters, warmup=0, device=device)
    for d, us in zip(depths, meds):
        records.append(ShmooRecord(
            suite='serving_chunk',
            params={'n_x': n_x, 'n_h': n_h, 'n_layers': L, 'T': chunk,
                    'B': slots, 'tc': d, 'backend': engines[0].backend},
            metrics={'measured_us': us}))
    win = int(np.argmin(meds))
    ent = ScheduleEntry(kind='serving_chunk', n_x=n_x, n_h=n_h, n_layers=L,
                        T=chunk, B=slots, mesh=ANY_MESH, tc=depths[win],
                        measured_us=meds[win], source='measured',
                        host=host_fingerprint(device))
    if cache is not None:
        cache.record(ent)
    entries.append(ent)
    return entries, records


# ---------------------------------------------------------------------------
# Deterministic offline replay
# ---------------------------------------------------------------------------

def serving_depths(chunk: int) -> Tuple[int, ...]:
    """The chunk depths ``tune_serving_config`` trials for ``chunk`` (all
    of ``TC_GRID`` for a wildcard ``chunk=0``)."""
    if not chunk:
        return TC_GRID
    return tuple(sorted({t for t in TC_GRID if t < chunk} | {chunk}))


def replay_check(cache: ScheduleCache, *, device='cuda',
                 tile: int = 96) -> Tuple[int, List[ScheduleEntry]]:
    """Check the entries of the kinds this port tunes, with no clock: a
    ``q_stack_backend`` entry names ``'fused'`` or ``'layerwise'``, and a
    ``predicted`` one re-derives from ``tune_quantized_backend(measure=
    False)`` on ``device`` at ``tile`` (the cold rule, with the fused
    admission prune on CUDA); a ``serving_chunk`` entry's ``tc`` lies in
    its trial grid (``serving_depths`` of its ``T``).  Raises
    ``AssertionError`` on drift.  Returns ``(checked, unchecked)``:
    the count of entries checked, and the entries of the kinds this port
    cannot check yet (staged, geometry, ``lb``, ``stack_backend``), which
    the caller reports rather than passes."""
    checked, unchecked = 0, []
    for e in cache.entries():
        if e.kind == 'q_stack_backend':
            if e.backend not in ('fused', 'layerwise'):
                raise AssertionError(f'unknown int8 backend in {e}')
            if e.source == 'predicted':
                want, _ = tune_quantized_backend(
                    e.n_x, e.n_h, e.n_layers, e.T, e.B, tile=tile,
                    measure=False, device=device)
                if want.backend != e.backend:
                    raise AssertionError(f'predicted int8 backend drifted: '
                                         f'{want.backend} vs {e}')
            checked += 1
        elif e.kind == 'serving_chunk':
            if e.tc not in serving_depths(e.T):
                raise AssertionError(f'serving chunk left its grid '
                                     f'{serving_depths(e.T)}: {e}')
            checked += 1
        else:
            unchecked.append(e)
    return checked, unchecked
