"""Serving-side fault tolerance: the fleet-operation layer (DESIGN.md §10,
§11).

The port's copy of ``repro.runtime.serving_faults`` (the reference module
cannot be imported without the JAX package).  This module is the
policy/state side of fault tolerance for the packed streaming engine
(``serving/engine.py``); the mechanism side is the generalized
``FaultTolerantRunner`` (``runtime/fault.py``).  Its capabilities:

  * **stream-state checkpoint/resume** — ``StreamStateCheckpointer``
    snapshots a preempted/evicted stream's packed per-layer ``(h, c)`` rows
    (f32 — or the int8 kernels' opaque ``(h_q, c_q)`` carries; the
    checkpointer is tree-generic) plus its frame cursor through the port's
    ``CheckpointManager``, so a resubmitted stream restores and continues
    **bit-equal** to an uninterrupted run instead of being dropped;
  * **engine-failure injection + graceful degradation** — a deterministic
    ``fail_at`` schedule raises ``EngineFailure`` mid-serve; the engine
    reacts by re-dispatching down ``core.lstm.DEGRADATION_LADDER``
    (``cuda_seq_fused`` -> ``cuda_seq`` -> ``torch_scan``) and re-placing
    its packed state cache (``elastic_replace``, an exact host round trip),
    with only a logged latency blip and no stream loss;
  * **deadline watchdog** — per-chunk deadlines derived from the paper's
    real-time model (``chunk_deadline_s`` on
    ``core.perf_model.staged_realtime_frame_s``), recorded as structured
    events by the runner and exposed via ``StreamingEngine.stats()``;
  * **poisoned-slot quarantine** — a non-finite guard over the packed state
    cache (``finite_slots``: four device ops, its ``(S,)`` mask read back
    behind the chunk's log-probs) detects a slot whose carried
    state went NaN/Inf so the engine can quarantine exactly that slot —
    zero its rows, evict the session with a terminal error — while
    neighbouring slots' outputs stay bit-untouched;
  * **deadline-aware chunk sizing** (§11) — ``ChunkSizePolicy``, pure
    host-side policy on ``core.perf_model``.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core.perf_model import FRAME_PERIOD_S, staged_realtime_frame_s


class EngineFailure(RuntimeError):
    """A mesh engine (or group of engines) declared dead mid-serve.

    Raised by the deterministic fault schedule (``ServingFaultConfig.fail_at``
    via ``FaultTolerantRunner``'s injection hook) — or, on real hardware, by
    the dispatch layer when a device stops answering.  Handlers react by
    type AND taxonomy (§14):

      * ``transient=False`` (default) — a PERMANENT loss: the serving engine
        degrades its backend down the ladder and re-places its packed state cache before retrying the chunk.
        Permanent failures do not burn the runner's transient retry budget —
        the fault hook fires on the first attempt.
      * ``transient=True`` — a recoverable glitch (link hiccup, watchdog
        blip): the runner retries in place under the ordinary backoff
        budget; no degradation happens.

    ``domain`` carries the fault-domain id (on the flat ladder, one
    domain per rung transition); None means "unattributed", which the engine
    maps to the highest-numbered healthy domain (LIFO — matching the
    tracker's heal order, so fail/heal schedules compose deterministically).
    """

    def __init__(self, n_dead: int = 1,
                 message: Optional[str] = None, *,
                 transient: bool = False,
                 domain: Optional[int] = None):
        self.n_dead = int(n_dead)
        self.transient = bool(transient)
        self.domain = None if domain is None else int(domain)
        kind = 'transient fault on' if transient else 'declared dead'
        super().__init__(message or f'{n_dead} mesh engine(s) {kind}')


@dataclasses.dataclass
class ServingFaultConfig:
    """Fault policy for one ``StreamingEngine`` (all features opt-in).

    ``fail_at`` maps engine step -> number of engines lost at that step (the
    deterministic failure-injection schedule); ``poison_at`` maps engine
    step -> slot index whose packed state rows are overwritten with NaN
    before that step's chunk (the quarantine-path injection hook; the
    engine writes the NaN into copies of the chunk's input states).  The
    non-finite guard (``guard_nonfinite``, ``finite_slots``) runs on the
    device right after the chunk call and its mask comes back behind the
    same event as the log-probs; ``chip_smoke.py`` counts the device ops it
    adds and times it against ``faults=None``.  ``deadline_s`` pins an
    explicit per-chunk deadline; ``deadline_factor`` instead derives one
    from the paper's real-time model (``chunk_deadline_s``).
    ``checkpoint_dir`` enables stream-state checkpoint/resume through
    ``StreamStateCheckpointer``.

    Recovery-side knobs (§14): ``fail_at`` values may also be dict specs
    ``{'n_dead': int, 'transient': bool, 'domain': int}`` to inject the
    taxonomy; ``recover_at`` maps engine step -> number of fault domains
    healed at that step (fed to the ``MeshHealthTracker``, which then arms
    the canary-validated promotion path); ``promote_hysteresis`` is the
    tracker's base backoff window in engine steps; ``canary`` gates
    promotion on a bit-equality shadow-chunk replay (``canary_rtol`` relaxes
    the comparison to allclose for cross-arithmetic-class rungs);
    ``event_log_cap`` bounds the engine + runner event logs with a ring
    buffer (``runtime.fault.RingLog``).
    """

    fail_at: Dict[int, object] = dataclasses.field(default_factory=dict)
    poison_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    recover_at: Dict[int, int] = dataclasses.field(default_factory=dict)
    guard_nonfinite: bool = True
    max_retries: int = 3
    backoff_s: float = 0.05
    deadline_s: Optional[float] = None
    deadline_factor: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    heartbeat_path: Optional[str] = None
    promote_hysteresis: int = 4
    canary: bool = True
    canary_rtol: Optional[float] = None
    event_log_cap: int = 1024

    def resolve_deadline_s(self, chunk: int) -> Optional[float]:
        """The per-chunk deadline this config implies: the explicit
        ``deadline_s`` when set, else ``chunk_deadline_s(chunk,
        deadline_factor)`` (the paper's staged real-time frame budget times
        the slack factor), else None (watchdog disabled)."""
        if self.deadline_s is not None:
            return self.deadline_s
        if self.deadline_factor is not None:
            return chunk_deadline_s(chunk, self.deadline_factor)
        return None

    def make_fail_schedule(self):
        """The ``FaultTolerantRunner`` injection hook for this config:
        ``step -> EngineFailure`` on scheduled steps, else None.  A plain
        int value is ``n_dead`` (a permanent unattributed loss); a dict value ``{'n_dead', 'transient', 'domain'}`` injects
        the full §14 taxonomy.  Deterministic by construction — tests and
        CI replay it exactly."""
        fail_at = dict(self.fail_at)

        def schedule(step: int):
            if step not in fail_at:
                return None
            spec = fail_at[step]
            if isinstance(spec, dict):
                return EngineFailure(spec.get('n_dead', 1),
                                     transient=spec.get('transient', False),
                                     domain=spec.get('domain'))
            return EngineFailure(spec)

        return schedule


def chunk_deadline_s(chunk: int, factor: float = 1.0, **kw) -> float:
    """Per-chunk serving deadline from the paper's real-time model: ``chunk``
    frames times ``core.perf_model.staged_realtime_frame_s`` (the graves-75
    steady-state per-frame execution time), scaled by ``factor`` — the
    slack multiplier a host-emulated deployment needs over the silicon
    budget.  Extra ``kw`` pass through to ``staged_realtime_frame_s``."""
    return chunk * staged_realtime_frame_s(**kw) * factor


class ChunkSizePolicy:
    """Deadline-aware serving chunk sizing on a halving ladder (DESIGN.md
    §11).  Pure host-side control policy — no numerics of its own: the §7
    masking contract makes a stream's outputs bit-invariant to where chunk
    boundaries fall, so the policy may move them freely.

    The budget is the paper's REAL-TIME arrival deadline: a chunk of ``c``
    frames represents ``c * FRAME_PERIOD_S`` of sensor time
    (``core.perf_model.realtime_chunk_budget_s``), scaled by ``slack``.
    Feedback comes from the observed launch-to-commit wall time of each
    committed chunk (the same ``dt`` the §10 watchdog records as
    ``deadline_miss``):

      * **miss** (``dt > budget(c)``) — the chunk fell behind the frame
        arrival rate.  Per-chunk cost on a host is ``a + b*c`` (fixed
        dispatch overhead plus per-frame compute) while the budget is
        ``c * budget_per_frame``, so small chunks are the ones that miss:
        the policy GROWS the chunk (doubles, up to ``chunk_max``) to
        amortise ``a``, and pins a floor so it never returns to a size that
        already missed.
      * **provably-safe step-down** — when ``patience`` consecutive chunks
        finish within ``budget(c/2)`` (i.e. the observed wall time already
        meets the HALVED chunk's budget), the policy halves the chunk to
        cut per-symbol emission latency.  The step-down can never introduce
        a miss that the observations did not already rule out.

    Deterministic given the fed ``(chunk_len, dt)`` sequence, so tests
    drive it with synthetic durations.
    """

    def __init__(self, chunk_max: int, chunk_min: int = 1,
                 slack: float = 1.0, patience: int = 3):
        if not 1 <= chunk_min <= chunk_max:
            raise ValueError(f'need 1 <= chunk_min <= chunk_max, got '
                             f'{chunk_min}, {chunk_max}')
        self.chunk_max = int(chunk_max)
        self.chunk_min = int(chunk_min)
        self.frame_budget_s = FRAME_PERIOD_S * slack
        self.patience = int(patience)
        self.size = int(chunk_max)      # start fully amortised (and safest)
        self.misses = 0
        self.history: list = []         # (chunk_len, dt) per committed chunk
        self._floor = int(chunk_min)    # sizes below this are known too small
        self._streak = 0

    def budget_s(self, chunk_len: int) -> float:
        """The arrival-rate deadline of one ``chunk_len``-frame chunk:
        ``core.perf_model.realtime_chunk_budget_s`` with the policy's slack
        folded into ``frame_budget_s``."""
        return chunk_len * self.frame_budget_s

    def observe(self, chunk_len: int, dt: float) -> None:
        """Feed one committed chunk's launch-to-commit wall time."""
        self.history.append((int(chunk_len), float(dt)))
        if dt > self.budget_s(chunk_len):
            self.misses += 1
            self._streak = 0
            self._floor = max(self._floor, min(2 * chunk_len, self.chunk_max))
            self.size = max(self._floor,
                            min(2 * chunk_len, self.chunk_max))
        elif (self.size > max(self.chunk_min, self._floor)
              and dt <= self.budget_s(max(chunk_len // 2, 1))):
            self._streak += 1
            if self._streak >= self.patience:
                self._streak = 0
                self.size = max(self.size // 2, self.chunk_min, self._floor)
        else:
            self._streak = 0


def finite_slots(states) -> torch.Tensor:
    """Per-slot finiteness of a packed state cache: ``(S,) bool`` on the
    states' device, True iff every layer's ``(h, c)`` row for that slot is
    entirely finite; integer leaves are finite by definition.  One
    reduction over all layers at once: the rows are joined and each
    element times 0 is summed per slot — 0 exactly when the slot's row is
    finite (``x * 0`` is NaN for an infinite or NaN ``x``, and a sum of
    zeros cannot overflow).  Four device ops (join, multiply, sum,
    compare), where ``isfinite().all()`` takes six (``isfinite`` of a
    float tensor is four kernels).  A False entry is the quarantine
    trigger — the guard itself mutates nothing."""
    flat = [x for pair in states for x in pair]
    rows = [x.reshape(x.shape[0], -1) for x in flat
            if x.dtype.is_floating_point]
    if not rows:
        return torch.ones((flat[0].shape[0],), dtype=torch.bool,
                          device=flat[0].device)
    return torch.cat(rows, dim=1).mul(0).sum(dim=1).eq(0)


def elastic_replace(tree):
    """Re-place every tensor of ``tree`` (nested tuples/lists of tensors)
    via an exact host round trip: a copy to host memory, then back onto
    its device — the in-memory form of ``CheckpointManager.restore``'s
    re-placement.  The serving engine runs it on its packed state cache on
    every rung change, down (degrade) and up (promotion).  Values are
    bit-preserved: copies only, no arithmetic."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(elastic_replace(x) for x in tree)
    return tree.detach().to('cpu', copy=True).to(tree.device)


class StreamStateCheckpointer:
    """Per-stream ``(h, c)`` + cursor snapshots through ``CheckpointManager``.

    One checkpoint directory per stream id (``<dir>/stream_<sid:08d>``),
    each written via the manager's atomic tmp+rename layout with per-leaf
    checksums and manifest-path validation, keyed by the stream's frame
    cursor.  The payload is tree-generic: f32 ``(h, c)`` rows and the int8
    kernels' opaque ``(h_q, c_q)`` carries round-trip equally (exact numpy
    serialization, dtype kept), so resume is bit-equal / bit-identical on a
    fixed backend.  ``keep=1``: only a stream's latest preemption point
    matters.
    """

    def __init__(self, directory: str):
        self.dir = pathlib.Path(directory)

    def _manager(self, sid: int) -> CheckpointManager:
        return CheckpointManager(self.dir / f'stream_{sid:08d}', keep=1)

    def save(self, sid: int, state_rows, cursor: int) -> None:
        """Checkpoint one stream's packed state rows + frame cursor
        (blocking — preemption is on the control path, not the hot path)."""
        payload = {'cursor': np.int64(cursor), 'state': state_rows}
        self._manager(sid).save(int(cursor), payload, blocking=True)

    def load(self, sid: int, state_like) -> Tuple[tuple, int]:
        """Restore the latest snapshot of stream ``sid`` into the structure
        of ``state_like`` (per-layer ``(h, c)`` rows; each restored leaf is
        a tensor on its target's device, the CPU for a numpy target);
        returns ``(state_rows, cursor)``.  Manifest paths are validated
        against the target tree, so loading the wrong stream shape fails
        loudly."""
        out = self._manager(sid).restore(
            {'cursor': np.int64(0), 'state': state_like})
        return out['state'], int(out['cursor'])

    def has(self, sid: int) -> bool:
        """True iff a committed checkpoint exists for stream ``sid``."""
        d = self.dir / f'stream_{sid:08d}'
        return d.is_dir() and any(
            p.is_dir() and not p.name.endswith('.tmp')
            for p in d.glob('step_*'))
