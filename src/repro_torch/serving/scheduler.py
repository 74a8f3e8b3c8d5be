"""Slot scheduling: admission / eviction / refill over a fixed slot grid.

A copy of ``repro.serving.scheduler`` (which cannot be imported without
JAX): the ``StreamingEngine`` (serving/engine.py) schedules frame streams
onto rows of the packed state cache with it.  The scheduler owns *which*
item occupies *which* slot and nothing else — state initialisation happens
in the admission callback, so the policy is reusable across workloads.

Priority admission (DESIGN.md §11): items may carry an integer ``priority``
attribute (higher = more urgent; absent = 0, plain FIFO).  The pending queue
is kept ordered by priority, FIFO within a priority class, so ``refill``
admits latency-SLO items ahead of bulk ones; ``preempt_candidate`` names the
active item a higher-priority pending item should displace.  The scheduler
stays pure bookkeeping — the caller performs the actual preemption (it owns
the state snapshot).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Generic, List, Optional, Tuple, TypeVar

T = TypeVar('T')


def _priority(item) -> int:
    """An item's admission priority (0 when it declares none)."""
    return int(getattr(item, 'priority', 0) or 0)


class SlotScheduler(Generic[T]):
    """Priority/FIFO continuous batching over ``num_slots`` slots.

    Items are ``submit``ted to a pending queue (ordered by priority, FIFO
    within a class); ``refill`` admits them into free slots (continuous
    batching — finished slots are refilled without stopping the others);
    ``finish`` retires a slot into ``done``; ``evict`` frees a slot without
    retiring the item — by default the item leaves the scheduler
    (abandonment), with ``requeue=True`` it re-enters the FRONT of its
    priority class in ``pending`` (preemption: the stream resumes as soon
    as a slot frees, but never jumps a strictly-higher-priority waiter).
    Pure bookkeeping: no tensors live here.
    """

    def __init__(self, num_slots: int):
        assert num_slots >= 1, num_slots
        self.slots: List[Optional[T]] = [None] * num_slots
        self.pending: Deque[T] = deque()
        self.done: List[T] = []

    @property
    def num_slots(self) -> int:
        return len(self.slots)

    @property
    def busy(self) -> bool:
        """True while anything is active or queued (the drain condition)."""
        return bool(self.pending) or any(s is not None for s in self.slots)

    def _insert(self, item: T, front_of_class: bool) -> None:
        """Insert into ``pending`` keeping it priority-ordered: after the
        last strictly-higher-priority item, then after (``front_of_class``
        False: FIFO append) or before (True: preemption re-entry) its own
        class."""
        p = _priority(item)
        idx = 0
        for q in self.pending:
            if _priority(q) > p or (not front_of_class and _priority(q) == p):
                idx += 1
            else:
                break
        self.pending.insert(idx, item)

    def submit(self, item: T) -> None:
        """Queue an item for admission at the next ``refill`` — behind every
        pending item of the same or higher priority (FIFO within a class),
        ahead of strictly lower-priority ones."""
        self._insert(item, front_of_class=False)

    def refill(self, on_admit: Optional[Callable[[int, T], None]] = None
               ) -> List[Tuple[int, T]]:
        """Admit pending items into free slots, highest priority first
        (FIFO within a class — the queue is kept in admission order).

        ``on_admit(slot, item)`` runs per admission — this is where callers
        reset per-slot state (caches, packed state rows) so a recycled slot
        can never leak its previous occupant's state.  Returns the
        admissions performed.
        """
        admitted = []
        for i, slot in enumerate(self.slots):
            if slot is None and self.pending:
                item = self.pending.popleft()
                self.slots[i] = item
                if on_admit is not None:
                    on_admit(i, item)
                admitted.append((i, item))
        return admitted

    def active(self) -> List[Tuple[int, T]]:
        """(slot index, item) for every occupied slot, in slot order."""
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    def finish(self, slot: int) -> T:
        """Retire the slot's item into ``done`` and free the slot."""
        item = self.slots[slot]
        assert item is not None, f'slot {slot} is empty'
        self.done.append(item)
        self.slots[slot] = None
        return item

    def evict(self, slot: int, requeue: bool = False) -> T:
        """Free the slot WITHOUT retiring the item.

        ``requeue=False`` (default) is abandonment: the item leaves the
        scheduler entirely (never enters ``done``).  ``requeue=True`` is
        preemption: the item re-enters the FRONT of its priority class in
        ``pending`` — a preempted stream resumes before newly submitted
        peers (but not before strictly-higher-priority waiters) — and the
        ``busy``/``done`` accounting stays consistent (a pending item keeps
        the scheduler busy; nothing is retired either way).
        """
        item = self.slots[slot]
        assert item is not None, f'slot {slot} is empty'
        self.slots[slot] = None
        if requeue:
            self._insert(item, front_of_class=True)
        return item

    def preempt_candidate(self) -> Optional[int]:
        """The slot a higher-priority pending item should displace, or None.

        Non-None only when every slot is occupied AND the highest-priority
        pending item strictly outranks the lowest-priority active one; the
        returned slot holds that lowest-priority occupant (highest slot
        index on ties, so slot 0 — the longest-resident under FIFO refill —
        is displaced last).  Query only: the caller decides whether to act
        (it owns the displaced item's state snapshot).
        """
        if not self.pending or any(s is None for s in self.slots):
            return None
        top = max(_priority(q) for q in self.pending)
        slot, low = None, None
        for i, item in enumerate(self.slots):
            p = _priority(item)
            if low is None or p <= low:
                slot, low = i, p
        return slot if low is not None and top > low else None
