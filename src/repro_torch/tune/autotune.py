"""Measured-schedule autotuner: interleaved timed trials.

Port of ``repro.tune.autotune``.  Each trial
runs its candidates in turns (A/B/A/B per iteration, so a busy host window
hits every candidate alike), each call ending in ``torch.cuda.synchronize``
on the card, and records the winner in a ``schedule.ScheduleCache``.
Tuning is offline: serving consults the saved cache and never pays for a
trial at request time.

Every candidate a trial compares gives the same bits by construction (K4
and the K3 chain are bit-identical; chunk boundaries, staged chunk depths
and the geometries of one arithmetic class are scheduling-only), and each
trial checks that with ``torch.equal`` before it times anything, so a
trial can only choose among proven-identical schedules (``tune_geometry``
with ``allow_reassoc`` lets other classes in under an allclose gate).

The staged trials run the scale-out of ``core.systolic`` with one
controller driving every engine: ``tune_staged_stack`` on a live
``SystolicMesh``, ``tune_geometry`` on meshes it builds inside an engine
budget, every engine on one device.  ``tune_stack_lb`` times K2's layer
blocks (one launch a group of ``lb`` layers, the same bits for every
``lb``) in the space of ``shmoo.enumerate_lb_candidates``.
"""
from __future__ import annotations

import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .schedule import (ANY_MESH, ScheduleCache, ScheduleEntry,
                       devices_signature, host_fingerprint, mesh_signature)
from .shmoo import (TC_GRID, GeometryCandidate, ShmooRecord, card_budget,
                    enumerate_geometry_candidates, enumerate_lb_candidates,
                    enumerate_staged_candidates, geometry_params,
                    rank_geometry_candidates, rank_lb_candidates,
                    rank_staged_candidates, staged_params)

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
# K2's layer block lb — one card
# ---------------------------------------------------------------------------

def tune_stack_lb(n_x: int, n_h: int, n_layers: int, T: int, B: int, *,
                  cache: Optional[ScheduleCache] = None, iters: int = 3,
                  warmup: int = 1, measure: bool = True, device='cuda'
                  ) -> Tuple[Optional[ScheduleEntry], List[ShmooRecord]]:
    """Tune the fused stack's layer block ``lb``: K2 in groups of ``lb``
    layers, one launch a group (``lstm_stack_seq(..., lb=lb)``).

    The candidates are ``shmoo.enumerate_lb_candidates`` on ``device``
    (the divisors of L whose group geometry admits one stream on the
    card; every divisor on the CPU), ranked by passes L / lb, fewest
    first: the prediction is the largest.  With ``measure`` and more than
    one candidate, every candidate runs K2 on one seeded stack and input
    at ``(T, B)``, unmasked, from weights built once; their outputs and
    final states must be ``torch.equal`` before ``measure_interleaved``
    times them, each call ending in a synchronize.  Records
    ``kind='stack_lb'`` for any mesh (``source`` ``'predicted'`` or
    ``'measured'``) in ``cache`` when given.  Returns ``(entry,
    records)``; the entry is None when no ``lb`` is admissible (K2 cannot
    run the stack at all; nothing to record)."""
    cands = enumerate_lb_candidates(n_x, n_h, n_layers, B, device=device)
    if not cands:
        return None, []
    ranked = rank_lb_candidates(cands, n_layers)
    records = [ShmooRecord(
        suite='stack_lb',
        params={'n_x': n_x, 'n_h': n_h, 'n_layers': n_layers, 'T': T,
                'B': B, 'lb': lb},
        metrics={'passes': passes, 'measured_us': 0.0})
        for lb, passes in ranked]
    key = dict(kind='stack_lb', n_x=n_x, n_h=n_h, n_layers=n_layers, T=T,
               B=B, mesh=ANY_MESH)
    if not measure or len(cands) == 1:
        entry = ScheduleEntry(lb=ranked[0][0], source='predicted', **key)
    else:
        from ..core.lstm import init_lstm_stack, stack_params_to
        from ..kernels.lstm_seq import lstm_stack_seq, stack_kernel_weights
        stack = stack_params_to(init_lstm_stack(
            n_x, n_h, n_layers, None, torch.Generator().manual_seed(7)),
            device)
        xs = (torch.randn((T, B, n_x),
                          generator=torch.Generator().manual_seed(8))
              * 0.5).to(device)
        with torch.no_grad():
            weights = stack_kernel_weights(stack)
            runs = [lambda lb=lb: lstm_stack_seq(stack, xs, weights=weights,
                                                 lb=lb)
                    for lb, _ in ranked]
            outs = [run() for run in runs]
            for (lb, _), out in zip(ranked[1:], outs[1:]):
                if not _stack_equal(out, outs[0]):
                    raise AssertionError(f'K2 at lb={lb} differs from '
                                         f'lb={ranked[0][0]} at n_x={n_x} '
                                         f'n_h={n_h} L={n_layers} T={T} '
                                         f'B={B}')
            meds = measure_interleaved(runs, iters=iters, warmup=warmup,
                                       device=device)
        for r, us in zip(records, meds):
            r.metrics['measured_us'] = us
        win = int(np.argmin(meds))
        entry = ScheduleEntry(lb=ranked[win][0], measured_us=meds[win],
                              source='measured',
                              host=host_fingerprint(device), **key)
    if cache is not None:
        cache.record(entry)
    return entry, records


# ---------------------------------------------------------------------------
# Staged scale-out schedule: the chunk depth on a live mesh
# ---------------------------------------------------------------------------

def _stack_equal(a, b) -> bool:
    """Two ``systolic_lstm_stack_seq`` results bit for bit: ys and every
    layer's (h_T, c_T)."""
    (ys_a, fin_a), (ys_b, fin_b) = a, b
    return torch.equal(ys_a, ys_b) and all(
        torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        for x, y in zip(fin_a, fin_b))


def _stack_close(a, b, rtol: float, atol: float) -> bool:
    """``_stack_equal`` under an allclose (another arithmetic class)."""
    (ys_a, fin_a), (ys_b, fin_b) = a, b
    return torch.allclose(ys_a, ys_b, rtol=rtol, atol=atol) and all(
        torch.allclose(x[0], y[0], rtol=rtol, atol=atol)
        and torch.allclose(x[1], y[1], rtol=rtol, atol=atol)
        for x, y in zip(fin_a, fin_b))


def tune_staged_stack(stack, mesh, xs: torch.Tensor, *,
                      cache: Optional[ScheduleCache] = None, top_k: int = 3,
                      iters: int = 3, warmup: int = 1, measure: bool = True,
                      device=None
                      ) -> Tuple[ScheduleEntry, List[ShmooRecord]]:
    """Tune the staged scale-out's chunk depth ``Tc`` on one placement.

    ``stack``: ``LSTMStackParams``; ``mesh``: a live (stage, row, col)
    ``SystolicMesh`` that admits the stack (stage-aware
    ``seq_scaleout_admissible``, its budget ``engine_budget(mesh)``);
    ``xs``: a (T, B, n_x) representative input.  Enumerates the admissible
    depths (``shmoo.enumerate_staged_candidates`` at the mesh's per-engine
    budget), ranks them by ``perf_model``, and with ``measure`` times the
    ``top_k`` predicted best, interleaved, as ``systolic_lstm_stack_seq(...,
    chunk=tc)`` calls on the stack placed once (``place_stack``), each
    ending in a synchronize on ``device`` (default: ``xs``'s) — after
    checking every candidate's outputs and final states ``torch.equal``.
    Records the winner under ``mesh_signature(mesh)`` (``source``
    ``'measured'``, or ``'predicted'`` without ``measure``) in ``cache``
    when given.  Returns ``(entry, records)``."""
    from ..core import systolic
    device = xs.device if device is None else torch.device(device)
    T, B, n_x = xs.shape
    n_h, L = stack.layers[0].n_h, len(stack.layers)
    S, rows, cols = mesh.shape['stage'], mesh.shape['row'], mesh.shape['col']
    if not systolic.seq_scaleout_admissible(n_h, mesh, n_layers=L):
        raise ValueError(f'mesh {mesh.shape} does not admit the staged '
                         f'scale-out of this stack')
    per_engine = systolic.engine_budget(mesh)
    budget = None if per_engine is None else per_engine * S * rows * cols
    cands = enumerate_staged_candidates(n_x, n_h, L, T, B, stages=S,
                                        rows=rows, cols=cols, budget=budget)
    if not cands:
        raise ValueError('no admissible staged candidate for this mesh')
    ranked = rank_staged_candidates(cands, n_x, n_h, L, T)
    records = [ShmooRecord(suite='staged_schedule',
                           params=staged_params(n_x, n_h, L, T, B, c),
                           metrics={'predicted_us': us, 'measured_us': 0.0})
               for c, us in ranked]
    key = dict(kind='stack_f32', n_x=n_x, n_h=n_h, n_layers=L, T=T, B=B,
               mesh=mesh_signature(mesh))
    if not measure:
        winner, pred_us = ranked[0]
        entry = ScheduleEntry(tc=winner.tc, in_stage=winner.in_stage,
                              bn=winner.bn, bk=winner.bk, lb=winner.lb,
                              predicted_us=pred_us, source='predicted', **key)
    else:
        trial = ranked[:top_k]
        with torch.no_grad():
            placement = systolic.place_stack(stack, mesh, staged=True, T=T,
                                             batch=B)
            runs = [lambda tc=c.tc: systolic.systolic_lstm_stack_seq(
                stack, mesh, xs, chunk=tc, placement=placement)
                for c, _ in trial]
            outs = [run() for run in runs]
            for (c, _), out in zip(trial[1:], outs[1:]):
                if not _stack_equal(out, outs[0]):
                    raise AssertionError(f'staged chunk depth {c.tc} differs '
                                         f'from {trial[0][0].tc} on '
                                         f'{mesh.shape}')
            meds = measure_interleaved(runs, iters=iters, warmup=warmup,
                                       device=device)
        for (c, _), us in zip(trial, meds):
            for r in records:
                if r.params['tc'] == c.tc:
                    r.metrics['measured_us'] = us
        win = int(np.argmin(meds))
        winner, pred_us = trial[win]
        entry = ScheduleEntry(tc=winner.tc, in_stage=winner.in_stage,
                              bn=winner.bn, bk=winner.bk, lb=winner.lb,
                              predicted_us=pred_us, measured_us=meds[win],
                              source='measured',
                              host=host_fingerprint(device), **key)
    if cache is not None:
        cache.record(entry)
    return entry, records


# ---------------------------------------------------------------------------
# Geometry: the mesh, its stage split and its schedule inside an engine budget
# ---------------------------------------------------------------------------

def reference_geometry(n_h: int, n_layers: int, T: int,
                       ref: Tuple[int, int, int]) -> GeometryCandidate:
    """The balanced-default candidate of placement ``ref`` = (stages, rows,
    cols): what dispatch builds with a cold cache (the balanced split,
    ``Tc = ceil(T / 4S)``)."""
    rs, rr, rc = ref
    base, rem = divmod(n_layers, rs)
    blk = math.lcm(rr, rc)
    n_h_p = -(-n_h // blk) * blk
    return GeometryCandidate(
        stages=rs, rows=rr, cols=rc,
        blocks=tuple(base + (1 if s < rem else 0) for s in range(rs)),
        tc=max(1, -(-T // (4 * rs))), in_stage='sequential',
        bn=n_h_p // rr, bk=n_h_p // rc, n_h_p=n_h_p)


def tune_geometry(stack, xs: torch.Tensor, *, devices: int,
                  ref: Tuple[int, int, int],
                  cache: Optional[ScheduleCache] = None, top_k: int = 3,
                  iters: int = 3, warmup: int = 1, measure: bool = True,
                  allow_reassoc: bool = False, device=None
                  ) -> Tuple[ScheduleEntry, List[ShmooRecord], float]:
    """Tune the mesh geometry itself for an engine budget (DESIGN.md §13).

    ``devices`` is the engine budget; every candidate's engines sit on
    ``device`` (default: ``xs``'s), one controller driving them, and the
    space is pruned at that card's budget (``shmoo.card_budget``).
    ``ref`` is the placement dispatch builds today (``graves-75``'s
    ``(3, 5, 5)``); its balanced-default candidate (``reference_geometry``)
    anchors the baseline and the bit-equality class.  With ``measure``
    the trial is that candidate plus the predicted top ``top_k`` of its
    arithmetic class (the port's ``(n_h_p, bk, bn)``, shmoo deviation
    (c)), whose outputs and final states must be ``torch.equal`` to the
    reference candidate's before any timing; ``allow_reassoc`` adds the
    predicted top ``top_k`` of the other classes, each allclose (rtol
    1e-4, atol 1e-6).  Each candidate runs ``systolic_lstm_stack_seq`` on
    its own mesh with the stack placed once at its split, interleaved,
    a synchronize after each call.

    Records the ``geometry`` winner under ``devices_signature(devices)``
    and, measured, the winner's ``stack_f32`` schedule (``tc``,
    ``blocks``) under its concrete mesh signature, which
    ``core.systolic.resolve_staged_chunk`` / ``resolve_staged_blocks`` and
    ``place_stack`` read.  Returns ``(entry, records, baseline_us)``, the
    last the reference candidate's measured us (0.0 predicted-only)."""
    from ..core import systolic
    device = xs.device if device is None else torch.device(device)
    T, B, n_x = xs.shape
    n_h, L = stack.layers[0].n_h, len(stack.layers)
    budget = card_budget(device)
    cands = enumerate_geometry_candidates(n_x, n_h, L, T, B, devices=devices,
                                          budget=budget)
    if not cands:
        raise ValueError(f'no admissible geometry for {devices} engines')
    ranked = rank_geometry_candidates(cands, n_x, n_h, L, T)
    records = [ShmooRecord(suite='geometry',
                           params=geometry_params(n_x, n_h, L, T, B, devices,
                                                  c),
                           metrics={'predicted_us': us, 'measured_us': 0.0})
               for c, us in ranked]

    def _entry(cand, pred_us, meas_us, source, mesh_sig, kind='geometry'):
        return ScheduleEntry(
            kind=kind, n_x=n_x, n_h=n_h, n_layers=L, T=T, B=B,
            mesh=mesh_sig, tc=cand.tc, in_stage=cand.in_stage,
            bn=cand.bn, bk=cand.bk, lb=cand.lb, stages=cand.stages,
            rows=cand.rows, cols=cand.cols, blocks=cand.blocks_str(),
            predicted_us=pred_us, measured_us=meas_us, source=source,
            host=host_fingerprint(device) if source == 'measured' else '')

    if not measure:
        winner, pred = ranked[0]
        entry = _entry(winner, pred, 0.0, 'predicted',
                       devices_signature(devices))
        if cache is not None:
            cache.record(entry)
        return entry, records, 0.0

    rs, rr, rc = ref
    if rs * rr * rc > devices:
        raise ValueError(f'reference {ref} exceeds the budget of {devices} '
                         f'engines')
    if not any((c.stages, c.rows, c.cols) == ref for c, _ in ranked):
        raise ValueError(f'reference placement {ref} is not admissible')
    ref_cand = reference_geometry(n_h, L, T, ref)
    sig = ref_cand.arith_signature
    trial: List[Tuple[GeometryCandidate, float]] = [(ref_cand, 0.0)]
    same = [(c, u) for c, u in ranked if c.arith_signature == sig]
    trial += [(c, u) for c, u in same[:top_k] if c != ref_cand]
    n_exact = len(trial)
    if allow_reassoc:
        trial += [(c, u) for c, u in ranked[:top_k]
                  if c.arith_signature != sig]

    runs = []
    with torch.no_grad():
        for c, _ in trial:
            mesh = systolic.make_systolic_mesh(c.rows, c.cols,
                                               stage=c.stages, devices=device)
            placement = systolic.place_stack(stack, mesh, staged=True,
                                             blocks=c.blocks)
            runs.append(lambda m=mesh, p=placement, tc=c.tc:
                        systolic.systolic_lstm_stack_seq(stack, m, xs,
                                                         chunk=tc,
                                                         placement=p))
        outs = [run() for run in runs]
        for i, ((c, _), out) in enumerate(zip(trial, outs)):
            ok = (_stack_equal(out, outs[0]) if i < n_exact
                  else _stack_close(out, outs[0], rtol=1e-4, atol=1e-6))
            if not ok:
                raise AssertionError(f'geometry {c} disagrees with the '
                                     f'reference candidate {ref_cand}')
        meds = measure_interleaved(runs, iters=iters, warmup=warmup,
                                   device=device)
    for (c, _), us in zip(trial, meds):
        want = geometry_params(n_x, n_h, L, T, B, devices, c)
        for r in records:
            if r.params == want:
                r.metrics['measured_us'] = us
    win = int(np.argmin(meds))
    winner, pred = trial[win]
    entry = _entry(winner, pred, meds[win], 'measured',
                   devices_signature(devices))
    if cache is not None:
        cache.record(entry)
        # the winner's schedule under its concrete mesh key, which staged
        # dispatch and placement read whenever that mesh runs
        cache.record(_entry(winner, pred, meds[win], 'measured',
                            f'stage:{winner.stages},row:{winner.rows},'
                            f'col:{winner.cols}', kind='stack_f32'))
    return entry, records, meds[0]


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
    silicon's 96, ``core.systolic.N_LSTM_SILICON``).  (2) A chunk-depth
    ceiling for the deadline policy (``kind='stack_f32'``, any mesh, any
    T): the predicted best ``Tc <= chunk`` of the paper's staged Table-2
    placement (``min(L, 3)`` stages of 5x5, pruned at ``device``'s
    ``card_budget``), a prediction until a measured entry shadows it
    (exact keys beat wildcards).  (3) With ``measure``, the end-to-end
    serving-loop chunk ceiling (``kind='serving_chunk'``): one
    ``StreamingEngine`` per depth in ``{t in TC_GRID, t < chunk} | {chunk}``
    runs the whole engine loop (packing, masking, admission, retirement)
    over a fixed workload; the streams' log-probs must be ``torch.equal``
    across depths before the interleaved timing.  ``tuned_chunk_ceiling``
    consults (3) first, then (2).  ``params`` defaults to ``serve``'s own
    (``chipmunk_net.init`` from seed 0 on ``device``).  Returns
    ``(entries, records)``."""
    from ..core.systolic import N_LSTM_SILICON
    n_x, n_h, L = cfg.lstm_inputs, cfg.lstm_hidden, cfg.n_layers
    ent, records = tune_quantized_backend(
        n_x, n_h, L, chunk, slots, tile=N_LSTM_SILICON, cache=cache,
        measure=measure, iters=iters, device=device)
    entries = [ent]
    tcs = [t for t in TC_GRID if t <= chunk] or [chunk]
    cands = [c for c in enumerate_staged_candidates(
        n_x, n_h, L, chunk, slots, stages=min(L, 3), rows=5, cols=5,
        budget=card_budget(device)) if c.tc in tcs]
    if cands:
        win, pred = rank_staged_candidates(cands, n_x, n_h, L, chunk)[0]
        ent = ScheduleEntry(kind='stack_f32', n_x=n_x, n_h=n_h, n_layers=L,
                            T=0, B=slots, mesh=ANY_MESH, tc=win.tc,
                            in_stage=win.in_stage, predicted_us=pred,
                            source='predicted')
        if cache is not None:
            cache.record(ent)
        entries.append(ent)
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


def _check_geometry(e: ScheduleEntry, budget: Optional[int]) -> None:
    """A ``geometry`` entry (keyed ``'devices:N'``) against a fresh
    enumeration of its budget: its (stages, rows, cols, blocks) must still
    be admissible, and a ``predicted`` winner must still rank first."""
    T, B = e.T or 128, e.B or 8
    cands = enumerate_geometry_candidates(
        e.n_x, e.n_h, e.n_layers, T, B, devices=int(e.mesh.split(':')[1]),
        budget=budget)
    geo = (e.stages, e.rows, e.cols,
           tuple(int(p) for p in e.blocks.split(',')))
    if not any((c.stages, c.rows, c.cols, c.blocks) == geo and c.tc <= T
               for c in cands):
        raise AssertionError(f'cached geometry left the admissible space: '
                             f'{e}')
    if e.source == 'predicted':
        w = rank_geometry_candidates(cands, e.n_x, e.n_h, e.n_layers, T)[0][0]
        if ((w.stages, w.rows, w.cols, w.blocks, w.tc, w.in_stage)
                != geo + (e.tc, e.in_stage)):
            raise AssertionError(f'predicted geometry winner drifted: {w} '
                                 f'vs {e}')


def _check_staged(e: ScheduleEntry, budget: Optional[int]) -> None:
    """A staged entry on a concrete mesh (``'stage:S,row:R,col:C'``)
    against a fresh enumeration of that placement: its ``tc`` must be an
    admissible depth (or the dispatch default ``ceil(T / 4S)``, the
    geometry trial's reference schedule), its ``in_stage`` the port's one
    order, and a ``predicted`` winner must still rank first."""
    T, B = e.T or 128, e.B or 8
    dims = dict(p.split(':') for p in e.mesh.split(','))
    stages = int(dims.get('stage', 1))
    cands = enumerate_staged_candidates(
        e.n_x, e.n_h, e.n_layers, T, B, stages=stages,
        rows=int(dims.get('row', 1)), cols=int(dims.get('col', 1)),
        budget=budget)
    if e.in_stage not in ('', 'sequential'):
        raise AssertionError(f'in_stage {e.in_stage!r} is not the port\'s '
                             f'one order (sequential): {e}')
    default_tc = max(1, -(-T // (4 * stages)))
    if not cands or not (any(c.tc == e.tc for c in cands)
                         or e.tc == default_tc):
        raise AssertionError(f'cached winner left the admissible space: '
                             f'{e}')
    if e.source == 'predicted':
        win = rank_staged_candidates(cands, e.n_x, e.n_h, e.n_layers,
                                     T)[0][0]
        if win.tc != e.tc:
            raise AssertionError(f'predicted winner drifted: Tc={win.tc} '
                                 f'vs {e}')


def _check_lb(e: ScheduleEntry, device) -> None:
    """A ``stack_lb`` entry against a fresh enumeration of K2's layer
    blocks on ``device``: its ``lb`` must still be a candidate, and a
    ``predicted`` one must still rank first."""
    cands = enumerate_lb_candidates(e.n_x, e.n_h, e.n_layers, e.B or 8,
                                    device=device)
    if e.lb not in cands:
        raise AssertionError(f'cached layer block left the admissible '
                             f'space {cands}: {e}')
    if e.source == 'predicted':
        want = rank_lb_candidates(cands, e.n_layers)[0][0]
        if want != e.lb:
            raise AssertionError(f'predicted layer block drifted: lb={want} '
                                 f'vs {e}')


def replay_check(cache: ScheduleCache, *, device='cuda',
                 tile: int = 96) -> Tuple[int, List[ScheduleEntry]]:
    """Check the entries of the kinds this port tunes, with no clock: a
    ``q_stack_backend`` entry names ``'fused'`` or ``'layerwise'``, and a
    ``predicted`` one re-derives from ``tune_quantized_backend(measure=
    False)`` on ``device`` at ``tile`` (the cold rule, with the fused
    admission prune on CUDA); a ``serving_chunk`` entry's ``tc`` lies in
    its trial grid (``serving_depths`` of its ``T``); a ``geometry`` entry
    and a staged (``stack_f32``/``stack_int8``) entry on a concrete mesh
    lie in a fresh enumeration of their space at ``device``'s
    ``card_budget``, a ``predicted`` one re-ranking first
    (``_check_geometry``, ``_check_staged``); a ``stack_lb`` entry names a
    layer block K2 can run on ``device``, a ``predicted`` one the first of
    the ranking (``_check_lb``).  Raises ``AssertionError`` on drift.
    Returns ``(checked, unchecked)``: the count of entries checked, and
    the entries no space re-derives (staged entries for any mesh, the
    reference's ``stack_backend``), which the caller reports rather than
    passes."""
    budget = card_budget(device)
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
        elif e.kind == 'serving_chunk':
            if e.tc not in serving_depths(e.T):
                raise AssertionError(f'serving chunk left its grid '
                                     f'{serving_depths(e.T)}: {e}')
        elif e.kind == 'geometry' and e.mesh.startswith('devices:'):
            _check_geometry(e, budget)
        elif e.kind == 'stack_lb':
            _check_lb(e, device)
        elif (e.kind in ('stack_f32', 'stack_int8') and e.tc
              and e.mesh != ANY_MESH and ':' in e.mesh):
            _check_staged(e, budget)
        else:
            unchecked.append(e)
            continue
        checked += 1
    return checked, unchecked
