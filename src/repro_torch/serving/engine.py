"""Packed multi-stream stateful streaming engine (sync, fault-free).

Counterpart of ``repro.serving.engine.StreamingEngine`` without its fault
runtime, async dispatch and chunk-size policy.  Every active stream's
``(h, c)`` LSTM state lives in one packed per-layer state cache of shape
``(max_streams, N_h)`` on the engine's device, and each ``step`` runs ONE
batched chunked call (``models.chipmunk_net.stream_forward``) for all
active streams.  Frames go up to the device once per chunk and log-probs
come back once per chunk.  Ragged streams are handled by the valid-length
masking contract: a slot's padded tail steps are identity on its carried
state, so admission, eviction and refill never perturb neighbouring
streams.  On ``cuda_seq`` a step is one K1 launch per layer; on
``cuda_seq_fused`` it is one K2 launch for the whole stack.
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
from .scheduler import SlotScheduler
from .session import IncrementalCTCDecoder, StreamSession


@dataclasses.dataclass
class _InFlight:
    """One launched chunk: its active (slot, session) rows, the valid frame
    counts, and the outputs of the chunk call (still on the device)."""
    active: List[Tuple[int, StreamSession]]
    valid: np.ndarray
    lp: torch.Tensor
    new_states: tuple
    t_launch: float


class StreamingEngine:
    """Continuous streaming over a packed slot grid of recurrent state.

    One instance owns ``max_streams`` state slots on the device of
    ``params``; streams are admitted from a priority/FIFO queue, advance up
    to ``chunk`` frames per ``step`` through one batched call, and retire
    when their frames are exhausted.  Numerics contract: a stream's
    log-probs are allclose to the monolithic ``chipmunk_net.forward`` of its
    utterance, and bit-equal whatever streams share its batch (the packed
    call shape is fixed, and rows never mix).  The backend is resolved and
    pinned once at construction (``core.lstm.resolve_serving_backend``);
    on ``cuda_seq_fused`` the kernel's stacked weights are built then too.
    """

    def __init__(self, cfg, params, *, max_streams: int = 4, chunk: int = 16,
                 decode_ctc: bool = False):
        if cfg.family != 'lstm':
            raise ValueError('StreamingEngine serves the recurrent family')
        if chunk < 1 or max_streams < 1:
            raise ValueError('chunk and max_streams must be >= 1')
        self.params = params
        self.device = params.layers[0].w_h.device
        self.chunk = chunk
        self.decode_ctc = decode_ctc
        self.backend = resolve_serving_backend(
            params, cfg.lstm_backend, chunk, max_streams, self.device)
        self.cfg = cfg.replace(lstm_backend=self.backend)
        self.stack_weights = (stack_kernel_weights(params)
                              if self.backend == 'cuda_seq_fused' else None)
        self.sched: SlotScheduler[StreamSession] = SlotScheduler(max_streams)
        self.states = chipmunk_net.init_state(cfg, max_streams, self.device)
        self._next_sid = 0
        self._step_idx = 0
        self.chunk_walls: List[float] = []   # per-step launch-to-commit s

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

    def _apply_admission(self, states: tuple, slot: int,
                         sess: StreamSession) -> tuple:
        """Slot initialisation: a recycled slot never leaks its previous
        occupant's state — zero its packed rows, or, for a resumed session,
        copy its saved per-layer ``(h, c)`` rows back in (an exact copy, so
        resume is bit-equal to never having been evicted).  Updates the
        packed tensors in place and returns them."""
        for l, (h, c) in enumerate(states):
            if sess.saved_state is not None:
                rh, rc = sess.saved_state[l]
                h[slot] = torch.as_tensor(rh).to(self.device)
                c[slot] = torch.as_tensor(rc).to(self.device)
            else:
                h[slot] = 0
                c[slot] = 0
        return states

    def _admit_slot(self, slot: int, sess: StreamSession) -> None:
        """Admission callback: initialise the slot (``_apply_admission``)
        and clear the session's saved rows."""
        self.states = self._apply_admission(self.states, slot, sess)
        sess.saved_state = None

    def _snapshot_slot(self, slot: int) -> tuple:
        """Host copy of one slot's per-layer ``(h, c)`` rows, exactly as
        carried (no arithmetic)."""
        return tuple((h[slot].cpu().numpy().copy(),
                      c[slot].cpu().numpy().copy()) for h, c in self.states)

    def preempt(self, sid: int, requeue: bool = True
                ) -> Optional[StreamSession]:
        """Preempt a stream: snapshot its packed per-layer ``(h, c)`` rows
        onto the session, free its slot, and with ``requeue=True`` put it
        back at the front of its priority class.  The resumed stream
        continues bit-equal to an uninterrupted run on the same backend.
        Returns the session, or None when ``sid`` is not active."""
        for slot, sess in self.sched.active():
            if sess.sid == sid:
                sess.saved_state = self._snapshot_slot(slot)
                self.sched.evict(slot, requeue=requeue)
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

    def _maybe_priority_preempt(self) -> None:
        """When every slot is busy and a strictly higher-priority stream
        waits, preempt the scheduler's candidate so the refill admits it."""
        slot = self.sched.preempt_candidate()
        if slot is not None:
            self.preempt(self.sched.slots[slot].sid)

    # -------------------------------------------------- launch/commit core
    def _pack(self, plan, chunk_len: int):
        """Host-side packing of one chunk: each planned stream's next frames
        at its cursor into the (S, chunk_len, n_in) batch buffer.  ``plan``
        rows are (slot, session, cursor)."""
        S = self.sched.num_slots
        frames = np.zeros((S, chunk_len, self.cfg.lstm_inputs), np.float32)
        valid = np.zeros((S,), np.int64)
        for slot, sess, cursor in plan:
            part = sess.frames[cursor:cursor + chunk_len]
            frames[slot, :len(part)] = part
            valid[slot] = len(part)
        return frames, valid

    def _launch(self, plan) -> _InFlight:
        """Pack the planned streams, upload frames and valid counts in one
        copy each, and enqueue the chunk call; nothing engine-visible
        changes here."""
        frames, valid = self._pack(plan, self.chunk)
        t0 = time.time()
        frames_d = torch.from_numpy(frames).to(self.device)
        valid_d = torch.from_numpy(valid).to(self.device)
        lp, new_states = chipmunk_net.stream_forward(
            self.cfg, self.params, self.states, frames_d, valid_len=valid_d,
            stack_weights=self.stack_weights)
        return _InFlight(active=[(i, s) for i, s, _ in plan], valid=valid,
                         lp=lp, new_states=new_states, t_launch=t0)

    def _commit(self, rec: _InFlight) -> None:
        """Bring the chunk's log-probs to the host (one copy, which waits
        for the device), then advance states, cursors, outputs and
        retirement."""
        host = rec.lp.cpu().numpy()
        self.chunk_walls.append(time.time() - rec.t_launch)
        self.states = tuple((h.contiguous(), c.contiguous())
                            for h, c in rec.new_states)
        for i, sess in rec.active:
            sess.consume(host[i, :rec.valid[i]])
            if sess.remaining == 0:
                sess.t_done = time.time()
                self.sched.finish(i)
        self._step_idx += 1

    # ------------------------------------------------------------- stepping
    def step(self) -> bool:
        """Advance every active stream by up to one chunk: admit pending
        streams into free slots (priority first), launch ONE batched call
        for all of them (padded slots masked out via ``valid_len``), and
        commit its outputs and retirements.  Returns False when there was
        nothing to do."""
        self._maybe_priority_preempt()
        self.sched.refill(self._admit_slot)
        plan = [(i, s, s.cursor) for i, s in self.sched.active()]
        if not plan:
            return False
        self._commit(self._launch(plan))
        return True

    def run(self) -> List[StreamSession]:
        """Drain: step until every submitted stream has been served."""
        while self.sched.busy:
            self.step()
        return self.sched.done

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """Throughput/latency snapshot over the completed streams (read
        only): streams, frames, p50 stream latency, p50 chunk wall time,
        backend and step count."""
        done = self.sched.done
        lats = [s.t_done - s.t_enqueue for s in done if s.t_done]
        return {
            'streams': len(done),
            'frames': sum(s.length for s in done),
            'p50_latency_s': float(np.median(lats)) if lats else 0.0,
            'p50_chunk_s': (float(np.median(self.chunk_walls))
                            if self.chunk_walls else 0.0),
            'backend': self.backend,
            'steps': self._step_idx,
        }
