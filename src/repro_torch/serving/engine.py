"""Packed multi-stream stateful streaming engine, sync or double-buffered.

Counterpart of ``repro.serving.engine.StreamingEngine`` with its async
dispatch and chunk-size policy (DESIGN.md §11), without its fault runtime.
Every active stream's ``(h, c)`` LSTM state lives in one packed per-layer
state cache of shape ``(max_streams, N_h)`` on the engine's device, and
each ``step`` runs ONE batched chunked call (``models.chipmunk_net
.stream_forward``) for all active streams.  Ragged streams are handled by
the valid-length masking contract: a slot's padded tail steps are identity
on its carried state, so admission, eviction and refill never perturb
neighbouring streams.  On ``cuda_seq`` a step is one K1 launch per layer;
on ``cuda_seq_fused`` it is one K2 launch for the whole stack.

Every step is split into a LAUNCH and a later COMMIT.  The launch packs
the chunk into host buffers (pinned on the card), uploads frames and valid
counts with asynchronous copies, enqueues the chunk call, enqueues the
asynchronous copy of its log-probs back into a host buffer and records one
event behind it; nothing engine-visible changes.  The commit waits on that
event alone, then advances states, cursors, outputs and retirement.  The
synchronous mode commits right after launching (a depth-0 pipeline); with
``async_dispatch=True`` the host plans, packs and launches chunk k+1 on
chunk k's uncommitted output states before it commits chunk k, so host
work overlaps device time.  Admissions for the speculative launch are
applied to copies of those states, so a squashed speculation leaves the
tensors the commit adopts untouched.  Both modes share one code path and
give the same bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.lstm import resolve_serving_backend
from ..kernels.lstm_seq import stack_kernel_weights
from ..models import chipmunk_net
from ..runtime import ChunkSizePolicy, RingLog
from .scheduler import SlotScheduler
from .session import IncrementalCTCDecoder, StreamSession

# Host buffer sets in the ring: at most two chunks are in flight (the
# pending one and its speculative successor) and a squashed one's copies may
# still run; each reuse first waits on the event of the set's last chunk.
_HOST_RING = 3


class _HostBuffers:
    """One chunk's host staging, sized for the engine's packing width:
    frames and valid counts going up, log-probs coming down.  Pinned on the
    card, so the copies are asynchronous.  ``event`` (None on the CPU) is
    recorded behind the last copy of the chunk that used the set last; that
    chunk's commit waits on it, and the set is next used (and the event
    recorded again) only after that commit or its squash."""

    def __init__(self, slots: int, chunk: int, n_in: int, n_out: int,
                 pin: bool):
        f32 = dict(dtype=torch.float32, pin_memory=pin)
        self.frames = torch.zeros(slots * chunk * n_in, **f32)
        self.valid = torch.zeros(slots, dtype=torch.int64, pin_memory=pin)
        self.lp = torch.zeros(slots * chunk * n_out, **f32)
        self.event = torch.cuda.Event() if pin else None

    def wait(self) -> None:
        """Block the host until the set's last chunk's copies have run (a
        wait on one event, never on the whole stream; at once when the set
        is unused)."""
        if self.event is not None:
            self.event.synchronize()


@dataclasses.dataclass
class _InFlight:
    """One launched, uncommitted chunk: its active (slot, session) rows,
    the valid frame counts, the host copy of its log-probs, complete once
    ``done`` has fired (None on the CPU, where the copy is synchronous),
    and its output states (on the device) with the states it was fed."""
    chunk_idx: int
    active: List[Tuple[int, StreamSession]]
    valid: np.ndarray
    host_lp: torch.Tensor
    done: Optional[torch.cuda.Event]
    new_states: tuple
    t_launch: float
    chunk_len: int
    states_in: tuple = ()


class StreamingEngine:
    """Continuous streaming over a packed slot grid of recurrent state.

    One instance owns ``max_streams`` state slots on the device of
    ``params``; streams are admitted from a priority/FIFO queue, advance up
    to ``chunk`` frames per ``step`` through one batched call, and retire
    when their frames are exhausted.  Numerics contract: a stream's
    log-probs are allclose to the monolithic ``chipmunk_net.forward`` of its
    utterance, and bit-equal whatever streams share its batch (the packed
    call shape is fixed, and rows never mix), whatever ``async_dispatch``
    is, and wherever the chunk-size policy puts chunk boundaries.  The
    backend is resolved and pinned once at construction
    (``core.lstm.resolve_serving_backend``); on ``cuda_seq_fused`` the
    kernel's stacked weights are built then too.

    ``async_dispatch`` enables §11 double buffering (launch of chunk k+1
    overlapped with device compute of chunk k); ``chunk_policy`` (a
    ``runtime.ChunkSizePolicy``) makes the per-step chunk length adapt to
    the observed launch-to-commit wall time against the paper's 10 ms
    frame-arrival budget.  Both are scheduling-only.
    """

    def __init__(self, cfg, params, *, max_streams: int = 4, chunk: int = 16,
                 decode_ctc: bool = False, async_dispatch: bool = False,
                 chunk_policy: Optional[ChunkSizePolicy] = None):
        if cfg.family != 'lstm':
            raise ValueError('StreamingEngine serves the recurrent family')
        if chunk < 1 or max_streams < 1:
            raise ValueError('chunk and max_streams must be >= 1')
        if chunk_policy is not None and chunk_policy.chunk_max > chunk:
            raise ValueError(f'chunk_policy.chunk_max '
                             f'{chunk_policy.chunk_max} exceeds the engine '
                             f'packing width {chunk}')
        self.params = params
        self.device = params.layers[0].w_h.device
        self.chunk = chunk
        self.decode_ctc = decode_ctc
        self.async_dispatch = bool(async_dispatch)
        self._policy = chunk_policy
        self.backend = resolve_serving_backend(
            params, cfg.lstm_backend, chunk, max_streams, self.device)
        self.cfg = cfg.replace(lstm_backend=self.backend)
        self.stack_weights = (stack_kernel_weights(params)
                              if self.backend == 'cuda_seq_fused' else None)
        self.sched: SlotScheduler[StreamSession] = SlotScheduler(max_streams)
        self.states = chipmunk_net.init_state(cfg, max_streams, self.device)
        self._pin = self.device.type == 'cuda'
        self._host = [_HostBuffers(max_streams, chunk, cfg.lstm_inputs,
                                   cfg.n_outputs, self._pin)
                      for _ in range(_HOST_RING)]
        self._launched = 0
        self._next_sid = 0
        self._step_idx = 0
        self._pending: Optional[_InFlight] = None
        self.chunk_walls: List[float] = []   # per-chunk launch-to-commit s
        self.events = RingLog()

    # ------------------------------------------------------------ admission
    def submit(self, frames: np.ndarray, sid: Optional[int] = None,
               priority: int = 0) -> StreamSession:
        """Queue an utterance ((L, n_in) host frames) for streaming;
        ``priority`` > 0 is admitted ahead of bulk streams and may displace
        one."""
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2 or frames.shape[1] != self.cfg.lstm_inputs:
            raise ValueError(f'frames must be (L, {self.cfg.lstm_inputs}), '
                             f'got {frames.shape}')
        if sid is None:
            sid = self._next_sid
        self._next_sid = max(self._next_sid, sid + 1)
        dec = IncrementalCTCDecoder() if self.decode_ctc else None
        sess = StreamSession(sid=sid, frames=frames, decoder=dec,
                             priority=priority, t_enqueue=time.time())
        self.sched.submit(sess)
        return sess

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, by an asynchronous copy from
        pinned memory on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._pin:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _apply_admission(self, states: tuple, slot: int,
                         sess: StreamSession) -> tuple:
        """Slot initialisation on copies of ``states``, shared by the
        realized admission (``_admit_slot``) and the speculative launch, so
        both feed the same bits: a recycled slot never leaks its previous
        occupant's state — zero its packed rows, or, for a resumed session,
        copy its saved per-layer ``(h, c)`` rows back in (an exact copy, so
        resume is bit-equal to never having been evicted).  Never writes
        into ``states``: a squashed speculation must leave the tensors that
        the commit adopts untouched."""
        out = []
        for l, (h, c) in enumerate(states):
            h, c = h.clone(), c.clone()
            if sess.saved_state is None:
                h[slot] = 0
                c[slot] = 0
            else:
                rh, rc = sess.saved_state[l]
                h[slot] = self._upload(rh)
                c[slot] = self._upload(rc)
            out.append((h, c))
        return tuple(out)

    def _admit_slot(self, slot: int, sess: StreamSession) -> None:
        """Admission callback: initialise the slot in the committed cache
        (``_apply_admission``) and clear the session's saved rows."""
        self.states = self._apply_admission(self.states, slot, sess)
        if sess.saved_state is not None:
            sess.saved_state = None
            self._record('resume', sid=sess.sid, slot=slot,
                         cursor=sess.cursor)

    def _snapshot_slot(self, slot: int) -> tuple:
        """Host copy of one slot's per-layer ``(h, c)`` rows, exactly as
        carried (no arithmetic)."""
        return tuple((h[slot].cpu().numpy().copy(),
                      c[slot].cpu().numpy().copy()) for h, c in self.states)

    def preempt(self, sid: int, requeue: bool = True
                ) -> Optional[StreamSession]:
        """Preempt a stream: snapshot its packed per-layer ``(h, c)`` rows
        onto the session, free its slot, and with ``requeue=True`` put it
        back at the front of its priority class.  A control-plane op: under
        async dispatch the in-flight chunk is committed first (``_sync``),
        so the snapshot reads committed rows.  The resumed stream continues
        bit-equal to an uninterrupted run on the same backend.  Returns the
        session, or None when ``sid`` is not active."""
        self._sync()
        for slot, sess in self.sched.active():
            if sess.sid == sid:
                sess.saved_state = self._snapshot_slot(slot)
                self.sched.evict(slot, requeue=requeue)
                self._record('preempt', sid=sid, slot=slot, requeue=requeue)
                return sess
        return None

    def evict(self, sid: int) -> Optional[StreamSession]:
        """Abandon a stream mid-flight; its slot is freed for refill and its
        rows are zeroed on the next admission.  Its state is snapshotted
        onto the session, so ``resume`` can continue it later, bit-equal."""
        return self.preempt(sid, requeue=False)

    def resume(self, sess: StreamSession) -> StreamSession:
        """Resubmit a preempted or evicted session; on admission it restores
        its saved packed state and continues from its cursor."""
        self.sched.submit(sess)
        return sess

    def _record(self, kind: str, **info) -> None:
        self.events.append({'kind': kind, 'step': self._step_idx, **info})

    def _maybe_priority_preempt(self) -> None:
        """When every slot is busy and a strictly higher-priority stream
        waits, preempt the scheduler's candidate so the refill admits it."""
        slot = self.sched.preempt_candidate()
        if slot is not None:
            self.preempt(self.sched.slots[slot].sid)

    # -------------------------------------------------- launch/commit core
    def _next_chunk_len(self) -> int:
        """Frames the next chunk should carry: the policy's current size
        (never above the engine packing width), else the fixed ``chunk``."""
        if self._policy is not None:
            return min(self._policy.size, self.chunk)
        return self.chunk

    def _deadline_for(self, chunk_len: int) -> Optional[float]:
        """Per-chunk deadline: the chunk-size policy's arrival-rate budget
        when one is attached (so ``deadline_miss`` events and the policy's
        feedback agree), else None."""
        if self._policy is not None:
            return self._policy.budget_s(chunk_len)
        return None

    def _pack(self, plan, chunk_len: int, buf: _HostBuffers):
        """Host-side packing of one chunk into ``buf``: each planned
        stream's next frames at its cursor into the (S, chunk_len, n_in)
        frames, zeros elsewhere, and the (S,) valid counts.  ``plan`` rows
        are (slot, session, cursor): the cursor is explicit so the async
        path can pack speculatively without mutating any session.  Returns
        the two host tensors (views of ``buf``)."""
        S, n_in = self.sched.num_slots, self.cfg.lstm_inputs
        frames = buf.frames[:S * chunk_len * n_in].view(S, chunk_len, n_in)
        frames_np, valid_np = frames.numpy(), buf.valid.numpy()
        frames_np.fill(0)
        valid_np.fill(0)
        for slot, sess, cursor in plan:
            part = sess.frames[cursor:cursor + chunk_len]
            frames_np[slot, :len(part)] = part
            valid_np[slot] = len(part)
        return frames, buf.valid

    def _launch(self, states_in: tuple, plan, chunk_idx: int,
                chunk_len: int) -> _InFlight:
        """Enqueue one chunk without waiting for the device: pack the
        planned streams into the next host buffers, upload frames and valid
        counts by asynchronous copies, enqueue the chunk call on
        ``states_in`` and the copy of its log-probs back to the host, and
        record one event behind that copy.  Nothing engine-visible
        changes here."""
        buf = self._host[self._launched % _HOST_RING]
        self._launched += 1
        buf.wait()
        frames, valid = self._pack(plan, chunk_len, buf)
        valid_host = valid.numpy().copy()
        t0 = time.time()
        frames_d = frames.to(self.device, non_blocking=True)
        valid_d = valid.to(self.device, non_blocking=True)
        lp, new_states = chipmunk_net.stream_forward(
            self.cfg, self.params, states_in, frames_d, valid_len=valid_d,
            stack_weights=self.stack_weights)
        host_lp = buf.lp[:lp.numel()].view(lp.shape)
        host_lp.copy_(lp, non_blocking=True)
        if buf.event is not None:
            buf.event.record()
        return _InFlight(chunk_idx=chunk_idx,
                         active=[(i, s) for i, s, _ in plan],
                         valid=valid_host, host_lp=host_lp, done=buf.event,
                         new_states=new_states, t_launch=t0,
                         chunk_len=chunk_len, states_in=states_in)

    def _commit(self, rec: _InFlight) -> bool:
        """Resolve one in-flight chunk and commit it: wait on its event
        (the log-probs' copy to the host, behind the chunk call), feed the
        launch-to-commit wall time to the chunk-size policy and the
        deadline check, then — only now — advance states, cursors, outputs
        and retirement.  Returns True iff the commit was clean (no fault
        runtime yet, so always): the async path adopts its speculative
        launch only then."""
        if rec.done is not None:
            rec.done.synchronize()
        host = rec.host_lp.numpy()
        dt = time.time() - rec.t_launch
        self.chunk_walls.append(dt)
        if self._policy is not None:
            self._policy.observe(rec.chunk_len, dt)
        deadline = self._deadline_for(rec.chunk_len)
        if deadline is not None and dt > deadline:
            self._record('deadline_miss', dt=dt, deadline_s=deadline)
        self.states = tuple((h.contiguous(), c.contiguous())
                            for h, c in rec.new_states)
        for i, sess in rec.active:
            # a copy: the host buffer is reused by a later chunk
            sess.consume(host[i, :rec.valid[i]].copy())
            if sess.remaining == 0:
                sess.t_done = time.time()
                self.sched.finish(i)
        self._step_idx += 1
        return True

    def _sync(self) -> None:
        """Async control-plane barrier: commit the in-flight chunk, if any.
        Preemption and eviction snapshots must read committed state, so
        every control op drains the pipeline first.  No-op in sync mode
        (nothing is ever left in flight)."""
        if self._pending is not None:
            rec, self._pending = self._pending, None
            self._commit(rec)

    def _speculate(self, rec: _InFlight):
        """Plan chunk k+1 while chunk k is still in flight (no mutation).

        Retirements and admissions are deterministic at launch time: a
        stream retires iff its remaining frames minus the in-flight valid
        count hit zero, and refill admits the pending queue (already in
        priority order) into free slots in slot order.  Returns ``(plan,
        admissions)`` — plan rows are (slot, session, speculative cursor) —
        or None when the next step cannot be speculated: nothing to run, or
        a waiting stream that outranks an active one (the commit-time
        priority preemption must run serialized)."""
        survivors, freeing = [], []
        for slot, sess in rec.active:
            if sess.remaining - int(rec.valid[slot]) > 0:
                survivors.append((slot, sess,
                                  sess.cursor + int(rec.valid[slot])))
            else:
                freeing.append(slot)
        free = sorted({i for i, s in enumerate(self.sched.slots)
                       if s is None} | set(freeing))
        queue = list(self.sched.pending)
        if queue and not free:
            low = min(s.priority for _, s, _ in survivors)
            if max(q.priority for q in queue) > low:
                return None
        admissions = []
        for slot in free:
            if not queue:
                break
            admissions.append((slot, queue.pop(0)))
        plan = survivors + [(slot, sess, sess.cursor)
                            for slot, sess in admissions]
        plan.sort(key=lambda row: row[0])
        if not plan:
            return None
        return plan, admissions

    # ------------------------------------------------------------- stepping
    def _step_async(self) -> bool:
        """One §11 double-buffered step: speculatively pack and launch chunk
        k+1 on the in-flight chunk k's output states (host work and device
        compute overlap here), then commit chunk k; adopt the speculative
        launch only if the commit was clean and the realized admissions
        match the speculation, else squash it."""
        if self._pending is None:
            # pipeline fill: plan from committed state, launch, don't commit
            self._maybe_priority_preempt()
            self.sched.refill(self._admit_slot)
            plan = [(i, s, s.cursor) for i, s in self.sched.active()]
            if not plan:
                return False
            self._pending = self._launch(self.states, plan, self._step_idx,
                                         self._next_chunk_len())
            return True
        rec, self._pending = self._pending, None
        spec = self._speculate(rec)
        spec_rec = None
        if spec is not None:
            plan, admissions = spec
            states_in = rec.new_states
            for slot, sess in admissions:
                states_in = self._apply_admission(states_in, slot, sess)
            spec_rec = self._launch(states_in, plan, rec.chunk_idx + 1,
                                    self._next_chunk_len())
        clean = self._commit(rec)
        self._maybe_priority_preempt()
        admitted = self.sched.refill(self._admit_slot)
        if (clean and spec_rec is not None
                and [(i, s.sid) for i, s in admitted]
                == [(i, s.sid) for i, s in spec[1]]):
            self._pending = spec_rec
        elif spec_rec is not None:
            # the commit deviated from the speculation: drop the launched
            # chunk unobserved and relaunch from committed state next step
            self._record('squash', chunk=spec_rec.chunk_idx)
        return True

    def step(self) -> bool:
        """Advance every active stream by up to one chunk: admit pending
        streams into free slots (priority first), launch ONE batched call
        for all of them (padded slots masked out via ``valid_len``), and
        commit its outputs and retirements.  Synchronous mode launches and
        immediately commits (a depth-0 pipeline); ``async_dispatch`` defers
        the commit one step so host packing overlaps device compute
        (``_step_async``).  Returns False when there was nothing to do."""
        if self.async_dispatch:
            return self._step_async()
        self._maybe_priority_preempt()
        self.sched.refill(self._admit_slot)
        plan = [(i, s, s.cursor) for i, s in self.sched.active()]
        if not plan:
            return False
        self._commit(self._launch(self.states, plan, self._step_idx,
                                  self._next_chunk_len()))
        return True

    def run(self) -> List[StreamSession]:
        """Drain: step until every submitted stream has been served (the
        async pipeline is fully committed on exit)."""
        while self.sched.busy:
            self.step()
        self._sync()
        return self.sched.done

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """Throughput/latency snapshot over the completed streams (read
        only; an async in-flight chunk is not committed by this call):
        streams, frames, p50 stream latency, p50 chunk wall time, backend,
        step count, dispatch mode, the next chunk length, the structured
        events with their counts, and the deadline misses."""
        done = self.sched.done
        lats = [s.t_done - s.t_enqueue for s in done if s.t_done]
        events = list(self.events)
        counts: dict = {}
        for e in events:
            counts[e['kind']] = counts.get(e['kind'], 0) + 1
        return {
            'streams': len(done),
            'frames': sum(s.length for s in done),
            'p50_latency_s': float(np.median(lats)) if lats else 0.0,
            'p50_chunk_s': (float(np.median(self.chunk_walls))
                            if self.chunk_walls else 0.0),
            'backend': self.backend,
            'steps': self._step_idx,
            'async': self.async_dispatch,
            'chunk_len': self._next_chunk_len(),
            'events': events,
            'event_counts': counts,
            'events_dropped': self.events.dropped,
            'deadline_misses': (self._policy.misses
                                if self._policy is not None else 0),
        }
