"""Bounded structured event log of the serving engine.

The first piece of the port's counterpart of ``repro.runtime.fault`` (which
cannot be imported without the JAX package): ``RingLog``, copied.  The
fault runner (``FaultConfig``, ``StepTimer``, ``FaultTolerantRunner``)
comes with the engine's fault runtime.
"""
from __future__ import annotations

import collections
from typing import Optional


class RingLog:
    """Bounded append-only event log for long-lived serving processes.

    A fixed-capacity ring over structured event dicts: appends past the cap
    silently evict the OLDEST entries and bump ``dropped`` (the operator's
    truncation signal, surfaced by ``StreamingEngine.stats()`` as
    ``events_dropped``).  ``cap=None`` is unbounded (the historical list
    behaviour).  List-compatible where the test/stats surface needs it:
    iteration, ``len``, indexing, ``==`` against lists, and ``+``
    concatenation all behave like the equivalent list of retained events.
    """

    def __init__(self, cap: Optional[int] = None):
        self.cap = None if cap is None else int(cap)
        if self.cap is not None and self.cap < 1:
            raise ValueError(f'event log cap must be >= 1, got {self.cap}')
        self._d: collections.deque = collections.deque(maxlen=self.cap)
        self.dropped = 0

    def append(self, item) -> None:
        """Append one event, evicting the oldest (and counting the drop)
        when the ring is full."""
        if self.cap is not None and len(self._d) == self.cap:
            self.dropped += 1
        self._d.append(item)

    def extend(self, items) -> None:
        """Append every event of ``items`` in order (ring semantics each)."""
        for item in items:
            self.append(item)

    def clear(self) -> None:
        """Drop all retained events (does not reset ``dropped``)."""
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._d)[i]
        return self._d[i]

    def __add__(self, other):
        return list(self._d) + list(other)

    def __radd__(self, other):
        return list(other) + list(self._d)

    def __eq__(self, other):
        return list(self._d) == list(other)

    def __repr__(self) -> str:
        return (f'RingLog(cap={self.cap}, n={len(self._d)}, '
                f'dropped={self.dropped})')
