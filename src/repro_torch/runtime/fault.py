"""Fault tolerance + straggler mitigation for the training AND serving loops.

The port's copy of ``repro.runtime.fault`` (pure Python; the reference
module cannot be imported without the JAX package).  What a 1000+ node
deployment needs and what it implements:

  * **checkpoint/restart** — every failure path funnels into "restore latest
    checkpoint and continue"; combined with the elastic restore in
    checkpoint/manager.py this also covers topology changes after node loss.
  * **retry with backoff** — transient faults (preemption notices, flaky
    interconnect RPCs) retry the step before escalating to restore.
  * **deadline watchdog** — an optional per-step deadline; steps that
    overrun it are recorded as ``deadline_miss`` events (an in-process
    watchdog observes overruns post-hoc — it cannot preempt a kernel
    already enqueued on the device — so the sound reaction is to log,
    count, and let the caller's policy decide: the serving layer shrinks
    the next chunk or sheds load, a supervisor kills a persistently-late
    job).
  * **heartbeat** — a progress record external supervisors watch (kept
    in-memory as ``last_heartbeat`` and optionally mirrored to a file); a
    stuck job (no heartbeat for k x step-time) is killed+rescheduled by the
    supervisor, which is the only sound cross-host action (in-process
    watchdogs cannot observe a wedged device).
  * **straggler detection** — per-step EWMA of step time; steps slower than
    ``threshold x`` EWMA are logged as straggler events.  On real pods the
    mitigation is re-sharding around the slow host (elastic restore) — here we
    record the decision so the policy is testable.
  * **failure injection** — deterministic fault schedule for tests.  The
    schedule may return/raise a *specific* exception instance (e.g.
    ``runtime.serving_faults.EngineFailure``) so handlers can react by type.

The runner is deliberately workload-agnostic: ``run_step`` drives the
training ``(state, batch) -> (state, metrics)`` contract, and the
generalized ``run`` drives ANY zero-arg attempt (the serving engine's
packed chunk dispatch, ``serving/engine.py``) under the same
injection/retry/deadline/heartbeat machinery.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class FaultConfig:
    max_retries: int = 3
    backoff_s: float = 0.1
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    heartbeat_path: Optional[str] = None
    # optional per-step deadline (seconds); overruns are recorded as
    # ``deadline_miss`` events, never raised (see module docstring)
    deadline_s: Optional[float] = None
    # permanent (non-transient) faults get their own budget: they must not
    # burn the transient retry budget before the fault hook fires, but an
    # unbounded degrade loop is still a bug — cap it well above any ladder
    max_permanent: int = 8
    # bound the event log (None = unbounded); see RingLog
    event_log_cap: Optional[int] = None


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


class StepTimer:
    """EWMA step-time tracker + straggler classifier."""

    def __init__(self, alpha: float, factor: float):
        self.alpha, self.factor = alpha, factor
        self.ewma: Optional[float] = None
        self.stragglers: List[Dict] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.factor * self.ewma)
        if is_straggler:
            self.stragglers.append({'step': step, 'dt': dt, 'ewma': self.ewma})
        # slow steps do not poison the baseline
        if self.ewma is None:
            self.ewma = dt
        elif not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


class FaultTolerantRunner:
    """Retry/restore/deadline loop for any repeated step-shaped workload.

    Two entry points share one loop (``run``):

      * ``run_step(step, state, batch)`` — the training contract
        ``(state, batch) -> (state, metrics)``; on a fault the optional
        ``restore_fn`` replaces ``state`` before the retry (checkpoint
        restart).
      * ``run(step, fn, on_fault=...)`` — the generalized contract: drive
        any zero-arg attempt with injection/retry/backoff, the deadline
        watchdog, straggler tracking, and heartbeats.  ``on_fault(exc,
        attempt)`` runs between a failed attempt and its retry — the
        serving engine uses it to degrade its backend down the ladder
        (``runtime/serving_faults.py``) before recomputing the chunk.

    Every runner constructs its own ``FaultConfig`` when none is given
    (``cfg=None`` default — never a shared mutable default instance).
    """

    def __init__(self, step_fn: Optional[Callable] = None, ckpt_manager=None,
                 cfg: Optional[FaultConfig] = None,
                 restore_fn: Optional[Callable] = None,
                 fail_schedule: Optional[Callable[[int], Any]] = None,
                 on_fault: Optional[Callable[[BaseException, int],
                                             None]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.cfg = cfg if cfg is not None else FaultConfig()
        self.restore_fn = restore_fn
        self.fail_schedule = fail_schedule
        self.on_fault = on_fault
        self.timer = StepTimer(self.cfg.ewma_alpha, self.cfg.straggler_factor)
        self.events = RingLog(self.cfg.event_log_cap)
        self.deadline_misses = 0
        self.last_heartbeat: Optional[Dict] = None
        self.last_fault_domain: Optional[int] = None

    def _heartbeat(self, step: int):
        payload = {'step': step, 'time': time.time(),
                   'ewma_step_s': self.timer.ewma,
                   'deadline_misses': self.deadline_misses,
                   'fault_domain': self.last_fault_domain}
        self.last_heartbeat = payload
        if self.cfg.heartbeat_path:
            pathlib.Path(self.cfg.heartbeat_path).write_text(
                json.dumps(payload))

    def _injected(self, step: int) -> Optional[BaseException]:
        """Consult the fault schedule; promote truthy results to exceptions."""
        if self.fail_schedule is None:
            return None
        fault = self.fail_schedule(step)
        if not fault:
            return None
        if isinstance(fault, BaseException):
            return fault
        return RuntimeError(f'injected fault at step {step}')

    def run(self, step: int, fn: Callable[[], Any],
            on_fault: Optional[Callable[[BaseException, int], None]] = None,
            retry_fn: Optional[Callable[[], Any]] = None,
            launched_at: Optional[float] = None,
            deadline_s: Optional[float] = None):
        """Drive one attempt of ``fn`` to success under the fault machinery.

        Injects scheduled faults (first attempt only), retries with linear
        backoff up to ``cfg.max_retries`` (then re-raises), records
        straggler and ``deadline_miss`` events, and emits a heartbeat on
        success.  ``on_fault`` (per-call, else the constructor's) runs
        between a failed attempt and the retry.  Returns ``fn()``'s result.

        Async dispatch support (DESIGN.md §11): when the work was launched
        non-blocking BEFORE this call and ``fn`` merely resolves it,
        ``launched_at`` pins the step's start time, so the deadline/straggler
        duration is charged from launch to COMMIT (resolution), never just
        the resolve wait — an async chunk that comes back late is a
        ``deadline_miss`` even though its launch returned instantly.
        ``retry_fn``, when given, replaces ``fn`` from the second attempt on:
        a resolved-future attempt cannot be replayed, so retries run a fresh
        synchronous recompute (timed from their own start).  ``deadline_s``
        overrides ``cfg.deadline_s`` per call — the serving engine derives
        it per chunk when the chunk length varies under a size policy.

        Fault taxonomy (§14): an exception whose ``transient`` attribute is
        ``False`` (a permanent ``EngineFailure``) does NOT burn the
        transient retry budget — the fault hook fires on its first attempt
        and the loop keeps retrying under the separate ``max_permanent``
        cap (a safety backstop, not a policy knob: the hook's degradation
        ladder bottoms out long before it).  Exceptions without the
        attribute default to transient — the historical retry behaviour.
        Fault events carry ``transient`` and ``domain``; the heartbeat
        carries the last-seen ``fault_domain``.
        """
        on_fault = on_fault if on_fault is not None else self.on_fault
        deadline = deadline_s if deadline_s is not None else self.cfg.deadline_s
        attempts = 0       # transient faults charged to the retry budget
        permanent = 0      # permanent faults (degrade path, separate cap)
        while True:
            total = attempts + permanent
            try:
                if total == 0:
                    injected = self._injected(step)
                    if injected is not None:
                        raise injected
                t0 = time.time()
                if total == 0 and launched_at is not None:
                    t0 = launched_at
                out = fn() if (total == 0 or retry_fn is None) \
                    else retry_fn()
                dt = time.time() - t0
                if self.timer.observe(step, dt):
                    self.events.append({'kind': 'straggler', 'step': step,
                                        'dt': dt})
                if deadline is not None and dt > deadline:
                    self.deadline_misses += 1
                    self.events.append({'kind': 'deadline_miss', 'step': step,
                                        'dt': dt,
                                        'deadline_s': deadline})
                self._heartbeat(step)
                return out
            except Exception as e:           # noqa: BLE001 — retry any fault
                transient = bool(getattr(e, 'transient', True))
                domain = getattr(e, 'domain', None)
                if transient:
                    attempts += 1
                else:
                    permanent += 1
                if domain is not None:
                    self.last_fault_domain = domain
                self.events.append({'kind': 'fault', 'step': step,
                                    'attempt': attempts + permanent,
                                    'error': repr(e),
                                    'transient': transient,
                                    'domain': domain})
                if attempts > self.cfg.max_retries \
                        or permanent > self.cfg.max_permanent:
                    raise
                if transient:
                    time.sleep(self.cfg.backoff_s * attempts)
                if on_fault is not None:
                    on_fault(e, attempts + permanent)

    def run_step(self, step: int, state, batch):
        """Training-loop contract: ``(state, batch) -> (state, metrics)``
        with retry + checkpoint-restore semantics (``restore_fn`` replaces
        the carried state before a retry)."""
        box = [state]

        def attempt():
            return self.step_fn(box[0], batch)

        def restore(e, attempts):
            if self.restore_fn is not None:
                box[0] = self.restore_fn()
                self.events.append({'kind': 'restore', 'step': step})

        return self.run(step, attempt, on_fault=restore)
