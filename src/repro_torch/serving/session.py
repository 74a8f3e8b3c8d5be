"""Per-stream session state and incremental CTC emission.

A copy of ``repro.serving.session`` (which cannot be imported without JAX).

A ``StreamSession`` is one utterance flowing through the engine: queued input
frames, the cursor of how many have been consumed, the log-probs emitted so
far, and latency timestamps.  ``IncrementalCTCDecoder`` folds the greedy
best-path collapse across chunk boundaries so phonemes are emitted as soon
as their frames are processed — the "partial hypothesis" a near-sensor
deployment streams out — and its accumulated output equals the monolithic
``core.ctc.ctc_greedy_decode`` of the full utterance.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np


class IncrementalCTCDecoder:
    """Greedy CTC best-path decode, emitted incrementally chunk by chunk.

    Feeding the per-chunk argmax frames reproduces, symbol for symbol, what
    ``core.ctc.ctc_greedy_decode`` returns on the concatenated sequence: a
    symbol is emitted when it is not blank and differs from the immediately
    preceding frame's best symbol, and that predecessor is carried across
    chunk boundaries (the collapse state is one integer).
    """

    def __init__(self, blank: int = 0):
        self.blank = blank
        self._prev = -1          # best symbol of the previous frame (any)
        self.symbols: List[int] = []

    def feed(self, log_probs: np.ndarray) -> List[int]:
        """Consume (T_chunk, K) log-probs; return newly emitted symbols."""
        best = np.asarray(log_probs).argmax(axis=-1)
        fresh = []
        for sym in best.tolist():
            if sym != self.blank and sym != self._prev:
                fresh.append(sym)
            self._prev = sym
        self.symbols.extend(fresh)
        return fresh


@dataclasses.dataclass
class StreamSession:
    """One utterance streaming through the engine.

    ``frames``: (L, n_in) host array of queued input frames; ``cursor``
    counts frames already consumed by the engine.  Outputs accumulate in
    ``log_probs`` (list of (t, K) chunks, valid rows only) and, when a
    decoder is attached, incrementally in ``decoder.symbols``.

    Fault-tolerance fields (DESIGN.md §10): ``saved_state`` holds the
    stream's preempted per-layer ``(h, c)`` rows between eviction and
    re-admission (scattered back into the packed cache by the engine's
    admission callback, then cleared); ``error`` is the terminal fault
    string set when the stream is quarantined — an errored session is never
    retired into ``done`` and must not be resubmitted.

    ``priority`` (DESIGN.md §11) is the admission class the scheduler
    orders the pending queue by: higher values are latency-SLO streams that
    are admitted first and may displace (preempt) an active bulk stream —
    scheduling only, a stream's outputs are bit-invariant to it (§7).
    """

    sid: int
    frames: np.ndarray
    decoder: Optional[IncrementalCTCDecoder] = None
    cursor: int = 0
    priority: int = 0
    log_probs: List[np.ndarray] = dataclasses.field(default_factory=list)
    t_enqueue: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    saved_state: Optional[tuple] = None
    error: Optional[str] = None

    @property
    def remaining(self) -> int:
        """Frames not yet consumed by the engine."""
        return len(self.frames) - self.cursor

    @property
    def length(self) -> int:
        """Total utterance length in frames."""
        return len(self.frames)

    def next_chunk(self, chunk: int) -> np.ndarray:
        """The next up-to-``chunk`` frames (does not advance the cursor)."""
        return self.frames[self.cursor:self.cursor + chunk]

    def consume(self, log_probs: np.ndarray) -> None:
        """Record one processed chunk's valid-row outputs and advance."""
        n = len(log_probs)
        assert n <= self.remaining, (n, self.remaining)
        self.cursor += n
        if n and self.t_first is None:
            self.t_first = time.time()
        if n:
            self.log_probs.append(np.asarray(log_probs))
            if self.decoder is not None:
                self.decoder.feed(log_probs)

    def full_log_probs(self) -> np.ndarray:
        """Concatenated (L_consumed, K) log-probs emitted so far."""
        if not self.log_probs:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(self.log_probs, axis=0)
