"""Shmoo harness: the shared record format, the staged-schedule and
geometry candidate spaces, their pruning and predicted ranking.

Port of ``repro.tune.shmoo``.  A ``ShmooRecord`` is ``(suite, params,
metrics)`` and ``write_shmoo_csv`` emits the reference's canonical CSV
(``suite`` column, then the param columns, then the metric columns), so a
port sweep and a reference sweep read alike.  The staged space fixes a
(stage, row, col) mesh and shmoos the chunk depth; the geometry space
(DESIGN.md §13) shmoos the mesh itself inside an engine budget: stage
count, (rows, cols) grid, per-stage layer split, and chunk depth.  Both
are pruned before anything is timed and ranked by the calibrated silicon
model (``core.perf_model.staged_wavefront_cycles``); ``autotune`` times
the top of a ranking.  Enumeration and ranking are pure functions of
their arguments (no clock, no device query), so predicted-only runs
replay byte for byte; the record format and the tie-break order (the
candidate's own order) are the reference's.

Deviations from the reference, each for the card:

* **(a) Budget.** The reference prunes by a TPU's 12 MB VMEM per device.
  The port prunes by its own rule 3 (``core.systolic.engine_budget``):
  ``budget`` is the on-chip memory the engines of one card share (its L2,
  ``card_budget``), and a candidate's engine may hold ``budget // its
  engine count``; None (engines on the CPU) is unbounded.  At the same
  per-engine number the spaces equal the reference's.
* **(b) One in-stage order.** One controller issues the same products in
  both of the reference's in-stage orders, so the port runs one
  (``core.systolic``): every candidate is ``in_stage='sequential'``,
  predicted with ``in_stage_batched=False``, and the port's lists are the
  reference's filtered to ``'sequential'``.
* **(c) Arithmetic class.** The reference's bit-equality class is
  ``(n_h_p, bk)``: row and stage splits only reorder the schedule.  On the
  card each engine's product is a (B, bk) x (bk, 4 * bn) cuBLAS call whose
  algorithm depends on its shape, and a row split changes bn: at 421 on an
  H100, ``(3, 1, 5)`` (bn 425) differs from ``(3, 5, 5)`` (bn 85) by up
  to 2.2e-08.  So the port's class is ``(n_h_p, bk, bn)``
  (``GeometryCandidate.arith_signature``).
* **(d) The layer-block budget.** The reference's ``lb`` space prunes a
  layer group by its VMEM estimate (``stack_vmem_bytes_estimate``
  against 12 MB).  The port's K2 keeps a group resident across the SMs,
  so ``enumerate_lb_candidates`` prunes by the card's own rule: the
  ``lb``-layer geometry (``stack_geometry(..., lb=lb)``) must admit one
  stream (shared memory within a CTA's limit, every CTA resident), the
  batch alone never pruning, since K2 runs a batch in blocks.  Off the
  card (no SM count) every divisor of L is a candidate.  At 123 -> 3x421
  on 132 SMs the port's space is [1, 3], the reference's [1].

The layer-block space (``enumerate_lb_candidates``,
``rank_lb_candidates``) ranks by passes L / lb, fewest first, as the
reference does; every candidate gives the same bits.
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

from ..core import perf_model as pm

#: Chunk-depth grid of the schedule shmoos (clamped to the chunk).
TC_GRID = (4, 8, 16, 32, 64)


@dataclasses.dataclass
class ShmooRecord:
    """One shmoo point: which sweep, where in the space, what it scored."""
    suite: str
    params: Dict[str, object]
    metrics: Dict[str, float]


def write_shmoo_csv(path, records: Sequence[ShmooRecord],
                    param_order: Optional[Sequence[str]] = None,
                    metric_order: Optional[Sequence[str]] = None
                    ) -> pathlib.Path:
    """Write the shared CSV: ``suite,<params...>,<metrics...>``.

    Column order defaults to the sorted keys of the first record (explicit
    orders let a sweep keep a stable, documented header).  Every record
    must cover the same columns — drift between shmoo producers is a
    ValueError here, not a silently ragged file.
    """
    if not records:
        raise ValueError('empty shmoo')
    pcols = list(param_order or sorted(records[0].params))
    mcols = list(metric_order or sorted(records[0].metrics))
    lines = [','.join(['suite'] + pcols + mcols)]
    for r in records:
        if set(r.params) != set(pcols) or set(r.metrics) != set(mcols):
            raise ValueError(
                f'ragged shmoo record for suite {r.suite!r}: '
                f'{sorted(r.params)}/{sorted(r.metrics)} vs {pcols}/{mcols}')
        vals = ([r.suite] + [_fmt(r.params[c]) for c in pcols]
                + [_fmt(r.metrics[c]) for c in mcols])
        lines.append(','.join(vals))
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text('\n'.join(lines) + '\n')
    return path


def _fmt(v) -> str:
    if isinstance(v, float):
        return f'{v:.4f}'
    return str(v)


#: The in-stage order of every candidate (deviation (b)).
IN_STAGE = 'sequential'


def card_budget(device) -> Optional[int]:
    """The on-chip bytes the engines of one card share: the L2 of a CUDA
    ``device``, None (unbounded) for the CPU."""
    import torch
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    return torch.cuda.get_device_properties(device).L2_cache_size


def _fits(resident: int, budget: Optional[int], engines: int) -> bool:
    """Rule 3: one engine's resident bytes within its share of the card's
    ``budget`` (None: unbounded)."""
    return budget is None or resident <= budget // engines


def _resident_bytes(lb: int, bn: int, bk: int, dtype_bytes: int) -> int:
    """One engine's resident block of the staged form: ``lb`` layers of
    both weight families at ``bn x bk`` plus their peephole and bias
    rows (``core.systolic.seq_scaleout_admissible``'s stage-aware
    count)."""
    from ..core.lstm import GATES
    return (lb * 2 * GATES * bn * bk * dtype_bytes
            + lb * (3 + GATES) * bn * dtype_bytes)


def _padded(n_h: int, rows: int, cols: int) -> Tuple[int, int, int]:
    """(n_h_p, bn, bk): N_h padded so rows and cols divide it."""
    blk = math.lcm(rows, cols)
    n_h_p = -(-n_h // blk) * blk
    return n_h_p, n_h_p // rows, n_h_p // cols


def _tc_grid(T: int) -> List[int]:
    """The chunk depths of ``TC_GRID`` up to T (T itself when none is)."""
    return sorted({min(t, T) for t in TC_GRID if t <= T} or {T})


def _stack_layers(n_x: int, n_h: int, n_layers: int) -> List[pm.LayerDims]:
    return [pm.LayerDims(n_x, n_h)] + [pm.LayerDims(n_h, n_h)
                                       for _ in range(n_layers - 1)]


# ---------------------------------------------------------------------------
# Staged-schedule candidate space (a fixed mesh)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class StagedCandidate:
    """One point of the staged-schedule space: chunk depth, in-stage order
    (always ``'sequential'``), and the per-engine block geometry the mesh
    implies (``bn x bk`` from the row/col split, ``lb`` the bottleneck
    stage's layer count)."""
    tc: int
    in_stage: str
    stages: int
    rows: int
    cols: int
    bn: int
    bk: int
    lb: int


def enumerate_staged_candidates(n_x: int, n_h: int, n_layers: int, T: int,
                                B: int, *, stages: int, rows: int, cols: int,
                                dtype_bytes: int = 4,
                                budget: Optional[int] = None
                                ) -> List[StagedCandidate]:
    """The admissible chunk depths for one (stage, row, col) placement.
    The split is the mesh's; the schedule chooses the chunk depth.  Pruned
    as dispatch prunes: the stage count must not exceed the stack, and the
    bottleneck stage's resident block (``lb`` layers at ``bn x bk``) must
    fit one engine's share of ``budget`` (``card_budget``; None:
    unbounded).  Sorted by the candidates' own order."""
    if stages < 1 or stages > n_layers:
        return []
    _, bn, bk = _padded(n_h, rows, cols)
    lb = -(-n_layers // stages)
    if not _fits(_resident_bytes(lb, bn, bk, dtype_bytes), budget,
                 stages * rows * cols):
        return []
    return sorted(StagedCandidate(tc=tc, in_stage=IN_STAGE, stages=stages,
                                  rows=rows, cols=cols, bn=bn, bk=bk, lb=lb)
                  for tc in _tc_grid(T))


def predict_staged_us(cand: StagedCandidate, n_x: int, n_h: int,
                      n_layers: int, T: int, v: float = pm.V_MAX) -> float:
    """Model-predicted wall time (us) of one candidate on the calibrated
    silicon: ``staged_wavefront_cycles`` in the sequential in-stage order
    at the candidate's stage count over the homogeneous stack."""
    cfg = pm.TileConfig(cand.stages, cand.rows, cand.cols)
    cyc = pm.staged_wavefront_cycles(_stack_layers(n_x, n_h, n_layers), cfg,
                                     T, chunk=cand.tc, in_stage_batched=False)
    return cyc / pm.freq_hz(v) * 1e6


def rank_staged_candidates(cands: Sequence[StagedCandidate], n_x: int,
                           n_h: int, n_layers: int, T: int
                           ) -> List[Tuple[StagedCandidate, float]]:
    """Candidates with their predicted us, best first; ties break on the
    candidate's own order (the replay-determinism contract)."""
    scored = [(c, predict_staged_us(c, n_x, n_h, n_layers, T))
              for c in cands]
    return sorted(scored, key=lambda cu: (cu[1], cu[0]))


def staged_params(n_x: int, n_h: int, n_layers: int, T: int, B: int,
                  c: StagedCandidate) -> Dict[str, object]:
    """A staged candidate's record params (the reference's columns)."""
    return {'n_x': n_x, 'n_h': n_h, 'n_layers': n_layers, 'T': T, 'B': B,
            'stages': c.stages, 'rows': c.rows, 'cols': c.cols, 'bn': c.bn,
            'bk': c.bk, 'lb': c.lb, 'tc': c.tc, 'in_stage': c.in_stage}


def staged_shmoo_records(n_x: int, n_h: int, n_layers: int, T: int, B: int,
                         *, stages: int, rows: int, cols: int,
                         budget: Optional[int] = None,
                         suite: str = 'staged_schedule'
                         ) -> List[ShmooRecord]:
    """The predicted shmoo of one placement, ranked, in the shared record
    format."""
    cands = enumerate_staged_candidates(n_x, n_h, n_layers, T, B,
                                        stages=stages, rows=rows, cols=cols,
                                        budget=budget)
    return [ShmooRecord(suite=suite,
                        params=staged_params(n_x, n_h, n_layers, T, B, c),
                        metrics={'predicted_us': us})
            for c, us in rank_staged_candidates(cands, n_x, n_h, n_layers,
                                                T)]


# ---------------------------------------------------------------------------
# Geometry candidate space (DESIGN.md §13): the mesh inside an engine budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class GeometryCandidate:
    """One point of the geometry space: a mesh, its per-stage layer split
    and its schedule.  ``blocks`` is the per-stage layer-count composition
    (every entry >= 1: an empty stage only deepens the pipeline), ``lb``
    the bottleneck stage's count, ``n_h_p``/``bn``/``bk`` the padded
    hidden width and the per-engine block the (rows, cols) split
    implies."""
    stages: int
    rows: int
    cols: int
    blocks: Tuple[int, ...]
    tc: int
    in_stage: str
    bn: int
    bk: int
    n_h_p: int

    @property
    def lb(self) -> int:
        return max(self.blocks)

    @property
    def devices(self) -> int:
        return self.stages * self.rows * self.cols

    @property
    def arith_signature(self) -> Tuple[int, int, int]:
        """The port's bit-equality class ``(n_h_p, bk, bn)`` (deviation
        (c); the reference's is ``(n_h_p, bk)``): stage counts, stage
        splits and chunk depths only reorder the schedule, but bn is the
        width of every engine product, whose algorithm the card picks by
        shape.  Candidates in different classes are only allclose."""
        return (self.n_h_p, self.bk, self.bn)

    def blocks_str(self) -> str:
        return ','.join(str(b) for b in self.blocks)


def _stage_splits(n_layers: int, n_stages: int) -> List[Tuple[int, ...]]:
    """All positive compositions of ``n_layers`` into ``n_stages`` parts,
    lexicographic (the balanced split is always one)."""
    if n_stages == 1:
        return [(n_layers,)]
    out = []
    for first in range(1, n_layers - n_stages + 2):
        for rest in _stage_splits(n_layers - first, n_stages - 1):
            out.append((first,) + rest)
    return out


def enumerate_geometry_candidates(n_x: int, n_h: int, n_layers: int, T: int,
                                  B: int, *, devices: int,
                                  dtype_bytes: int = 4,
                                  budget: Optional[int] = None
                                  ) -> List[GeometryCandidate]:
    """The admissible geometry space for an engine budget: every ``stages
    x (rows x cols)`` mesh with ``stages`` in [2, n_layers] and at most
    ``devices`` engines, every positive per-stage split, every chunk depth;
    pruned by rule 3 at the bottleneck stage's ``max(blocks)`` layers
    against one engine's share of ``budget`` (``card_budget``; None:
    unbounded), the engines all on one card.  Sorted by the candidates'
    own order."""
    out = []
    for stages in range(2, min(n_layers, devices) + 1):
        grid_budget = devices // stages
        splits = _stage_splits(n_layers, stages)
        for rows in range(1, grid_budget + 1):
            for cols in range(1, grid_budget // rows + 1):
                n_h_p, bn, bk = _padded(n_h, rows, cols)
                engines = stages * rows * cols
                for split in splits:
                    if not _fits(_resident_bytes(max(split), bn, bk,
                                                 dtype_bytes),
                                 budget, engines):
                        continue
                    out.extend(GeometryCandidate(
                        stages=stages, rows=rows, cols=cols, blocks=split,
                        tc=tc, in_stage=IN_STAGE, bn=bn, bk=bk, n_h_p=n_h_p)
                        for tc in _tc_grid(T))
    return sorted(out)


def predict_geometry_us(cand: GeometryCandidate, n_x: int, n_h: int,
                        n_layers: int, T: int,
                        v: float = pm.V_MAX) -> float:
    """Model-predicted wall time (us) of one geometry candidate:
    ``staged_wavefront_cycles`` at its stage count and split."""
    cfg = pm.TileConfig(cand.stages, cand.rows, cand.cols)
    cyc = pm.staged_wavefront_cycles(_stack_layers(n_x, n_h, n_layers), cfg,
                                     T, chunk=cand.tc, in_stage_batched=False,
                                     blocks=cand.blocks)
    return cyc / pm.freq_hz(v) * 1e6


def rank_geometry_candidates(cands: Sequence[GeometryCandidate], n_x: int,
                             n_h: int, n_layers: int, T: int
                             ) -> List[Tuple[GeometryCandidate, float]]:
    """Geometry candidates with predicted us, best first; ties break on the
    candidate's own order."""
    scored = [(c, predict_geometry_us(c, n_x, n_h, n_layers, T))
              for c in cands]
    return sorted(scored, key=lambda cu: (cu[1], cu[0]))


def geometry_params(n_x: int, n_h: int, n_layers: int, T: int, B: int,
                    devices: int, c: GeometryCandidate) -> Dict[str, object]:
    """A geometry candidate's record params (the reference's columns)."""
    return {'n_x': n_x, 'n_h': n_h, 'n_layers': n_layers, 'T': T, 'B': B,
            'devices': devices, 'stages': c.stages, 'rows': c.rows,
            'cols': c.cols, 'blocks': c.blocks_str().replace(',', '+'),
            'bn': c.bn, 'bk': c.bk, 'lb': c.lb, 'tc': c.tc,
            'in_stage': c.in_stage}


def geometry_shmoo_records(n_x: int, n_h: int, n_layers: int, T: int, B: int,
                           *, devices: int, budget: Optional[int] = None,
                           suite: str = 'geometry') -> List[ShmooRecord]:
    """The predicted geometry shmoo for an engine budget, ranked, in the
    shared record format."""
    cands = enumerate_geometry_candidates(n_x, n_h, n_layers, T, B,
                                          devices=devices, budget=budget)
    return [ShmooRecord(suite=suite,
                        params=geometry_params(n_x, n_h, n_layers, T, B,
                                               devices, c),
                        metrics={'predicted_us': us})
            for c, us in rank_geometry_candidates(cands, n_x, n_h, n_layers,
                                                  T)]


# ---------------------------------------------------------------------------
# Single-engine layer-block space (K2's lb)
# ---------------------------------------------------------------------------

def enumerate_lb_candidates(n_x: int, n_h: int, n_layers: int, batch: int,
                            *, sms: Optional[int] = None,
                            device=None) -> List[int]:
    """The layer blocks K2 can run a stack in: the divisors of
    ``n_layers`` whose ``lb``-layer geometry admits at least one stream on
    a card of ``sms`` SMs (default: ``device``'s, when it is a CUDA
    device), ascending (deviation (d)).  With no SM count (the CPU, whose
    plain version runs any ``lb``) every divisor.  ``n_x`` and ``batch``
    do not prune: layer 0's input product is hoisted, and K2 runs a batch
    in blocks."""
    from ..kernels.lstm_seq import stack_geometry
    if sms is None and device is not None:
        import torch
        device = torch.device(device)
        if device.type == 'cuda':
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
    divisors = [lb for lb in range(1, n_layers + 1) if n_layers % lb == 0]
    if sms is None:
        return divisors
    return [lb for lb in divisors if stack_geometry(
        n_h, n_layers, 1, sms, lb=lb).admissible(sms)]


def rank_lb_candidates(cands: Sequence[int], n_layers: int
                       ) -> List[Tuple[int, float]]:
    """lb candidates scored by passes (``n_layers / lb``: launches a batch
    block on the card, weight re-streams on the TPU), best first; ties
    break on the larger lb.  The reference's ranking: the predicted
    preference is the largest admissible lb, which the measured trial in
    ``autotune.tune_stack_lb`` confirms or overturns per card."""
    scored = [(lb, n_layers / lb) for lb in cands]
    return sorted(scored, key=lambda cu: (cu[1], -cu[0]))
