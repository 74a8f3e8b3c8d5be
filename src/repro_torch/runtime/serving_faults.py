"""Serving-side deadline policy of the streaming engine (DESIGN.md §10-§11).

The first piece of the port's counterpart of ``repro.runtime.serving_faults``
(which cannot be imported without the JAX package): the per-chunk deadline
of the paper's real-time model (``chunk_deadline_s``) and the deadline-aware
chunk sizing of §11 (``ChunkSizePolicy``), copied with their docstrings.
Both are pure host-side policy on ``core.perf_model``; no tensors.  The
fault model (``ServingFaultConfig``, ``EngineFailure``, ``finite_slots``,
``elastic_replace``, ``StreamStateCheckpointer``) comes with the engine's
fault runtime.
"""
from __future__ import annotations

from ..core.perf_model import FRAME_PERIOD_S, staged_realtime_frame_s


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
