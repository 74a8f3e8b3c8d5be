"""Packed multi-stream stateful streaming engine, sync or double-buffered,
with the fault runtime (DESIGN.md §7, §10, §11, §14).

Counterpart of ``repro.serving.engine.StreamingEngine``: async dispatch,
the chunk-size policy and the fault runtime, on one device or over the
installed systolic mesh's engines.
Every active stream's ``(h, c)`` LSTM state lives in one packed per-layer
state cache of shape ``(max_streams, N_h)`` on the engine's device, and
each ``step`` runs ONE batched chunked call (``models.chipmunk_net
.stream_forward``) for all active streams.  Ragged streams are handled by
the valid-length masking contract: a slot's padded tail steps are identity
on its carried state, so admission, eviction and refill never perturb
neighbouring streams.  On ``cuda_seq`` a step is one K1 launch per layer;
on ``cuda_seq_fused`` it is one K2 launch for the whole stack; on
``cuda_seq_fused_systolic`` it is the staged scale-out over the installed
(stage, row, col) mesh (``core.systolic.systolic_lstm_stack_seq``), which
the engine takes at construction as its home mesh: the stack is placed on
it once (``core.systolic.place_stack``) and every systolic chunk call runs
on that placement, whatever the process registry holds later.

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

Fault tolerance (``runtime/serving_faults.py``, ``runtime/recovery.py``):
with a ``ServingFaultConfig`` attached, every commit is driven by the
``FaultTolerantRunner``.  A permanent ``EngineFailure`` steps the backend
down ``core.lstm.DEGRADATION_LADDER`` (``cuda_seq_fused_systolic`` ->
``cuda_seq_fused`` -> ``cuda_seq`` -> ``torch_scan``; a flat rung clears
the process mesh, a systolic rung re-installs the home mesh).  With a
``launch.mesh.DieMesh`` registered, the top of the ladder is the systolic
dispatch on fewer dies (``build_rungs``' die rungs): a die rung runs on the
healthy dies' ``submesh`` with a placement of its own, built the first time
the rung is used and kept.  A degrade re-places the
packed cache by an exact host round trip
(``elastic_replace``) and recomputes the chunk from committed state; a
transient one retries in place; any other error is retried under the
transient budget and then raised, never degraded.  Healed capacity
(``recover_at``) climbs back one rung at a time, each promotion validated
by a canary: the last committed chunk replayed as a shadow on the
candidate backend, compared with what was committed.  A non-finite guard
(``finite_slots``: four device ops a chunk and the copy of its mask, read
back behind the log-probs' event) quarantines exactly a poisoned slot, and preempted
streams checkpoint their rows and cursor so another engine resumes them
bit-equal.  Without a fault config none of this runs: the engine issues
the same device ops as without the runtime.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.lstm import resolve_serving_backend
from ..core.systolic import (clear_mesh, current_mesh, install_mesh,
                             place_stack)
from ..kernels.lstm_seq import stack_kernel_weights
from ..launch.mesh import current_die_mesh
from ..models import chipmunk_net
from ..runtime import (ChunkSizePolicy, EngineFailure, FaultConfig,
                       FaultTolerantRunner, MeshHealthTracker, RingLog,
                       ServingFaultConfig, StreamStateCheckpointer,
                       build_rungs, elastic_replace, finite_slots)
from .scheduler import SlotScheduler
from .session import IncrementalCTCDecoder, StreamSession

# Host buffer sets in the ring: at most two chunks are in flight (the
# pending one and its speculative successor) and a squashed one's copies may
# still run; each reuse first waits on the event of the set's last chunk.
_HOST_RING = 3


class _HostBuffers:
    """One chunk's host staging, sized for the engine's packing width:
    frames and valid counts going up, log-probs (and the non-finite guard's
    per-slot mask, when the guard is on) coming down.  Pinned on the
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
        self.finite = torch.zeros(slots, dtype=torch.bool, pin_memory=pin)
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
    the valid frame counts, its host buffer set with the host copies of its
    log-probs and guard mask (None without the guard), complete once
    ``done`` has fired (None on the CPU, where the copy is synchronous),
    its output states (on the device) with the states it was fed, and what
    a retry needs to recompute it from committed state: the frames and
    valid counts on the device and the injected poison slot.  ``error``
    holds an exception the chunk call raised at launch (fault runtime
    only); the commit raises it under the runner."""
    chunk_idx: int
    active: List[Tuple[int, StreamSession]]
    valid: np.ndarray
    buf: _HostBuffers
    host_lp: Optional[torch.Tensor]
    host_finite: Optional[torch.Tensor]
    done: Optional[torch.cuda.Event]
    new_states: Optional[tuple]
    t_launch: float
    chunk_len: int
    states_in: tuple
    frames_d: torch.Tensor
    valid_d: torch.Tensor
    poison_slot: Optional[int] = None
    error: Optional[BaseException] = None


def _poisoned(states: tuple, slot: int) -> tuple:
    """Copies of ``states`` with ``slot``'s rows set to NaN (the quarantine
    path's injection); ``states`` itself is never written."""
    out = []
    for h, c in states:
        h, c = h.clone(), c.clone()
        h[slot] = float('nan')
        c[slot] = float('nan')
        out.append((h, c))
    return tuple(out)


def _host(x) -> np.ndarray:
    """A host array of a tensor (copied off the device) or of an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tuned_chunk_ceiling(cfg, chunk: int, max_streams: int) -> int:
    """Chunk-length ceiling for the deadline policy, cache-first (the
    reference's ``serving.engine.tuned_chunk_ceiling``).

    ``ChunkSizePolicy`` adapts the chunk length at run time and grows back
    toward a ceiling, the engine's packing width ``chunk`` by default.  An
    installed schedule cache (``repro_torch.tune``) clamps it to a tuned
    depth.  Two kinds, most trustworthy first: ``'serving_chunk'``, the
    end-to-end serving-loop measurement that ``tune_serving_config``
    records, then ``'stack_f32'``, the kernel-level depth it predicts for
    the staged placement (or a loaded cache holds).  Exact ``(T, B)`` keys
    beat wildcards; the placement is the installed mesh's signature
    (``'any'`` without one).  Never above ``chunk``; ``chunk`` unchanged
    on a miss or a ``tc=0`` entry.
    Scheduling-only: outputs are bit-equal wherever chunk boundaries fall.
    """
    from ..tune.schedule import current_schedule_cache, mesh_signature
    cache = current_schedule_cache()
    if cache is None:
        return chunk
    key = dict(n_x=cfg.lstm_inputs, n_h=cfg.lstm_hidden,
               n_layers=cfg.n_layers, T=chunk, B=max_streams,
               mesh=mesh_signature(current_mesh()))
    ent = cache.lookup('serving_chunk', **key)
    if ent is None or not ent.tc:
        ent = cache.lookup('stack_f32', **key)
    if ent is not None and ent.tc:
        return max(1, min(chunk, int(ent.tc)))
    return chunk


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
    (``core.lstm.resolve_serving_backend``), under the installed systolic
    mesh, which the engine keeps as its home mesh; on ``cuda_seq_fused``
    (and a staged home, whose ladder steps down onto K2) the kernel's
    stacked weights are built then too, and on a systolic backend the
    stack's blocks placed on the home mesh, which its chunk calls are
    bound to.

    ``faults`` (a ``runtime.ServingFaultConfig``) opts into the §10/§14
    fault model: engine-failure injection with ladder degradation and
    canary-validated promotion, the per-chunk deadline watchdog, non-finite
    slot quarantine, and stream checkpoint/resume through the port's
    ``CheckpointManager``.  Without it the engine runs no guard and no
    runner, and issues the same device ops per chunk.

    ``async_dispatch`` enables §11 double buffering (launch of chunk k+1
    overlapped with device compute of chunk k); ``chunk_policy`` (a
    ``runtime.ChunkSizePolicy``) makes the per-step chunk length adapt to
    the observed launch-to-commit wall time against the paper's 10 ms
    frame-arrival budget.  Both are scheduling-only.
    """

    def __init__(self, cfg, params, *, max_streams: int = 4, chunk: int = 16,
                 decode_ctc: bool = False,
                 faults: Optional[ServingFaultConfig] = None,
                 async_dispatch: bool = False,
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
        self._home_mesh = current_mesh()   # re-installed on systolic rungs
        # built once; on a fault runtime they serve a promotion back to K2
        self.stack_weights = (stack_kernel_weights(params) if self.backend
                              in ('cuda_seq_fused', 'cuda_seq_fused_systolic')
                              else None)
        # a systolic home's blocks, placed once on the home mesh, which its
        # chunk calls are bound to (the registry is not read per chunk)
        self.placement = (place_stack(
            params, self._home_mesh,
            staged=self.backend == 'cuda_seq_fused_systolic', T=chunk,
            batch=max_streams) if self.backend.endswith('_systolic')
            else None)
        # the die mesh at construction (None: flat ladders) and the die
        # rungs' placements, keyed by (backend, healthy dies), each built
        # the first time its rung runs
        self._die_mesh = current_die_mesh()
        self._placements: dict = {}
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
        self._poison_recorded: set = set()
        self.chunk_walls: List[float] = []   # per-chunk launch-to-commit s
        self.events = RingLog(faults.event_log_cap
                              if faults is not None else None)

        self.faults = faults
        self._guard = False
        self._ckpt: Optional[StreamStateCheckpointer] = None
        self._runner: Optional[FaultTolerantRunner] = None
        self._rungs: tuple = ()
        self._tracker: Optional[MeshHealthTracker] = None
        if faults is not None:
            self._guard = faults.guard_nonfinite
            if faults.checkpoint_dir:
                self._ckpt = StreamStateCheckpointer(faults.checkpoint_dir)
            self._runner = FaultTolerantRunner(
                cfg=FaultConfig(max_retries=faults.max_retries,
                                backoff_s=faults.backoff_s,
                                deadline_s=faults.resolve_deadline_s(chunk),
                                heartbeat_path=faults.heartbeat_path,
                                event_log_cap=faults.event_log_cap),
                fail_schedule=faults.make_fail_schedule())
            # §14: the ladder from the pinned backend down — die rungs on
            # top when a die mesh is registered (rebuilt flat when the
            # pinned backend is not their top), one fault domain per die,
            # or per rung transition on a flat ladder
            shape = dict(n_layers=cfg.n_layers, n_h=cfg.lstm_hidden,
                         n_x=cfg.lstm_inputs, T=chunk, batch=max_streams)
            self._rungs = build_rungs(self.backend, die_mesh=self._die_mesh,
                                      **shape)
            if self._rungs[0].backend != self.backend:
                self._rungs = build_rungs(self.backend, **shape)
            top = self._rungs[0]
            if (top.n_dies is not None and self._home_mesh
                    == self._die_mesh.submesh(range(top.n_dies))):
                self._placements[(top.backend,
                                  tuple(range(top.n_dies)))] = self.placement
            self._tracker = MeshHealthTracker(
                n_domains=self._rungs[0].need,
                hysteresis=faults.promote_hysteresis)
        self._rung_idx = 0
        self._healed_steps: set = set()
        self._last_commit: Optional[dict] = None   # canary replay material
        self._fwd = self._make_fwd(self.cfg)

    def _make_fwd(self, cfg, placement=None):
        """The packed chunk call on ``cfg``'s backend: ``(states, frames,
        valid) -> (log-probs, new states, finite)``, where ``finite`` is the
        non-finite guard's ``(S,)`` mask on the device (``finite_slots``,
        the guard on) or None (no device op).  A systolic backend's call is
        bound to ``placement`` (None: the home placement).  Also the
        factory the promotion canary uses to build the CANDIDATE rung's
        call without touching the incumbent's."""
        guard, params, weights = self._guard, self.params, self.stack_weights
        if not cfg.lstm_backend.endswith('_systolic'):
            placement = None
        elif placement is None:
            placement = self.placement

        def fwd(states, frames, valid):
            lp, new_states = chipmunk_net.stream_forward(
                cfg, params, states, frames, valid_len=valid,
                stack_weights=weights, placement=placement)
            return lp, new_states, (finite_slots(new_states) if guard
                                    else None)

        return fwd

    def _rung_dies(self, rung) -> Tuple[int, ...]:
        """The dies a die rung runs on: the first ``n_dies`` healthy ones."""
        return tuple(self._tracker.healthy[:rung.n_dies])

    def _install_rung_mesh(self, rung) -> None:
        """Point the process mesh registry at a rung's topology: the
        healthy dies' ``submesh`` for a die rung, the home mesh (taken at
        construction) for another systolic rung, no mesh for a flat one,
        so ``auto`` dispatch elsewhere in the process sees the rung's
        topology.  The chunk calls do not read the registry: a systolic
        rung's call is bound to its placement (``_rung_placement``)."""
        if rung.n_dies is not None:
            install_mesh(self._die_mesh.submesh(self._rung_dies(rung)))
        elif rung.backend.endswith('_systolic'):
            install_mesh(self._home_mesh)
        else:
            clear_mesh()

    def _rung_placement(self, rung):
        """The stack's placement for a systolic rung: the home placement,
        or for a die rung the one keyed by (backend, healthy dies), placed
        on that ``submesh`` the first time and kept (a placement is ~150
        device ops at ``graves-75``); None for a flat rung."""
        if rung.n_dies is None:
            return None
        key = (rung.backend, self._rung_dies(rung))
        if key not in self._placements:
            self._placements[key] = place_stack(
                self.params, self._die_mesh.submesh(key[1]),
                staged=rung.backend == 'cuda_seq_fused_systolic',
                T=self.chunk, batch=self.sched.num_slots)
        return self._placements[key]

    def _rung_fwd(self, rung):
        """The chunk call of ``rung``: its backend on its placement."""
        return self._make_fwd(self.cfg.replace(lstm_backend=rung.backend),
                              self._rung_placement(rung))

    def _set_backend(self, backend: str, fwd) -> None:
        """Move the engine to ``backend`` (a rung change): its config and
        its chunk call ``fwd``."""
        self.backend = backend
        self.cfg = self.cfg.replace(lstm_backend=backend)
        self._fwd = fwd

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
        onto the session (and through the stream checkpointer when one is
        configured), free its slot, and with ``requeue=True`` put it back at
        the front of its priority class.  A control-plane op: under async
        dispatch the in-flight chunk is committed first (``_sync``), so the
        snapshot reads committed rows.  The resumed stream continues
        bit-equal to an uninterrupted run on the same backend.  Returns the
        session, or None when ``sid`` is not active."""
        self._sync()
        for slot, sess in self.sched.active():
            if sess.sid == sid:
                sess.saved_state = self._snapshot_slot(slot)
                if self._ckpt is not None:
                    self._ckpt.save(sess.sid, sess.saved_state, sess.cursor)
                    self._record('checkpoint', sid=sid, cursor=sess.cursor)
                self.sched.evict(slot, requeue=requeue)
                self._record('preempt', sid=sid, slot=slot, requeue=requeue)
                return sess
        return None

    def evict(self, sid: int) -> Optional[StreamSession]:
        """Abandon a stream mid-flight; its slot is freed for refill and its
        rows are zeroed on the next admission.  Its state is snapshotted
        onto the session (and to disk when a checkpointer is configured),
        so ``resume`` or ``resume_from_checkpoint`` can continue it later,
        bit-equal."""
        return self.preempt(sid, requeue=False)

    def resume(self, sess: StreamSession) -> StreamSession:
        """Resubmit a preempted or evicted session; on admission it restores
        its saved packed state and continues from its cursor.  A
        quarantined session cannot resume (``ValueError``)."""
        if sess.error is not None:
            raise ValueError(f'stream {sess.sid} was quarantined')
        self.sched.submit(sess)
        return sess

    def resume_from_checkpoint(self, frames: np.ndarray, sid: int
                               ) -> StreamSession:
        """Rebuild a stream from its on-disk checkpoint and submit it.

        ``frames`` is the full utterance (inputs are not checkpointed —
        only the packed per-layer ``(h, c)`` rows and the frame cursor);
        the session resumes at the checkpointed cursor and its emitted
        log-probs continue from there, bit-equal to the uninterrupted
        run's suffix on the same backend."""
        if self._ckpt is None:
            raise ValueError('no checkpoint_dir configured')
        frames = np.asarray(frames, np.float32)
        n_h = self.cfg.lstm_hidden
        like = tuple((torch.zeros(n_h, dtype=h.dtype),
                      torch.zeros(n_h, dtype=c.dtype))
                     for h, c in self.states)
        state_rows, cursor = self._ckpt.load(sid, like)
        dec = IncrementalCTCDecoder() if self.decode_ctc else None
        sess = StreamSession(sid=sid, frames=frames, decoder=dec,
                             cursor=cursor, t_enqueue=time.time())
        sess.saved_state = tuple((rh.numpy(), rc.numpy())
                                 for rh, rc in state_rows)
        self._next_sid = max(self._next_sid, sid + 1)
        self.sched.submit(sess)
        self._record('resume_from_checkpoint', sid=sid, cursor=cursor)
        return sess

    def _record(self, kind: str, **info) -> None:
        self.events.append({'kind': kind, 'step': self._step_idx, **info})

    def _maybe_priority_preempt(self) -> None:
        """When every slot is busy and a strictly higher-priority stream
        waits, preempt the scheduler's candidate so the refill admits it."""
        slot = self.sched.preempt_candidate()
        if slot is not None:
            self.preempt(self.sched.slots[slot].sid)

    # -------------------------------------------------------- fault hooks
    def _on_engine_fault(self, exc: BaseException, attempt: int) -> None:
        """Between a failed chunk attempt and its retry: transient faults
        (any exception but a permanent ``EngineFailure``, so a real kernel
        error too) just retry; a permanent ``EngineFailure`` marks its fault
        domain dead in the health tracker, degrades to the highest rung the
        surviving capacity supports (at least one rung down), and re-places
        the packed state cache by an exact host round trip before the retry
        recomputes the SAME chunk.  No stream loses state or frames."""
        if not isinstance(exc, EngineFailure) or exc.transient:
            return                          # transient: plain retry
        killed = self._tracker.fail(self._step_idx, domain=exc.domain,
                                    n_dead=exc.n_dead)
        domain = killed[0] if killed else exc.domain
        n = self._tracker.n_healthy
        supported = next(
            (i for i, r in enumerate(self._rungs) if r.need <= n),
            len(self._rungs) - 1)
        target = max(self._rung_idx + 1, supported)
        if target >= len(self._rungs):
            self._record('degrade_exhausted', backend=self.backend,
                         n_dead=exc.n_dead)
            return                          # bottom of the ladder: retry as-is
        prev = self.backend
        rung = self._rungs[target]
        self._install_rung_mesh(rung)
        self._set_backend(rung.backend, self._rung_fwd(rung))
        self.states = elastic_replace(self.states)
        self._rung_idx = target
        self._last_commit = None            # stale incumbent evidence
        self._record('degrade', from_backend=prev, to_backend=rung.backend,
                     n_dead=exc.n_dead, domain=domain)

    def _quarantine(self, active, finite: torch.Tensor, new_states) -> tuple:
        """Quarantine every active slot whose new carried state went
        non-finite: zero exactly that slot's rows, in copies (a squashed
        speculative launch has read ``new_states``), evict the session with
        a terminal ``error`` (never retired into ``done``, never requeued),
        and leave every neighbouring slot's rows and outputs bit-untouched.
        Returns the scrubbed states."""
        bad = [(slot, sess) for slot, sess in active if not bool(finite[slot])]
        if not bad:
            return new_states
        out = []
        for h, c in new_states:
            h, c = h.clone(), c.clone()
            for slot, _ in bad:
                h[slot] = 0
                c[slot] = 0
            out.append((h, c))
        for slot, sess in bad:
            sess.error = (f'non-finite state quarantined at engine '
                          f'step {self._step_idx}')
            sess.saved_state = None
            self.sched.evict(slot)
            self._record('quarantine', sid=sess.sid, slot=slot)
        return tuple(out)

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
        feedback agree), else the fault config's ``resolve_deadline_s`` for
        THIS chunk length, else None."""
        if self._policy is not None:
            return self._policy.budget_s(chunk_len)
        if self.faults is not None:
            return self.faults.resolve_deadline_s(chunk_len)
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

    def _read_back(self, buf: _HostBuffers, lp: torch.Tensor,
                   finite: Optional[torch.Tensor]):
        """Enqueue the copies of a chunk's log-probs (and guard mask) into
        ``buf`` and record the set's event behind them.  Returns the host
        views (the mask's is None without the guard)."""
        host_lp = buf.lp[:lp.numel()].view(lp.shape)
        host_lp.copy_(lp, non_blocking=True)
        host_finite = None
        if finite is not None:
            host_finite = buf.finite[:finite.numel()]
            host_finite.copy_(finite, non_blocking=True)
        if buf.event is not None:
            buf.event.record()
        return host_lp, host_finite

    def _launch(self, states_in: tuple, plan, chunk_idx: int,
                chunk_len: int) -> _InFlight:
        """Enqueue one chunk without waiting for the device: compose the
        injected poison edit (``faults.poison_at``, on copies of the input
        states), pack the planned streams into the next host buffers,
        upload frames and valid counts by asynchronous copies, enqueue the
        chunk call on ``states_in`` and the copies of its log-probs (and
        guard mask) back to the host, and record one event behind them.
        Nothing engine-visible changes here.  Under the fault runtime an
        exception of the chunk call is kept in the record and raised by
        the commit, under the runner."""
        poison = (self.faults.poison_at.get(chunk_idx)
                  if self.faults is not None else None)
        if poison is not None:
            states_in = _poisoned(states_in, poison)
            if chunk_idx not in self._poison_recorded:
                self._poison_recorded.add(chunk_idx)
                self._record('poison_injected', slot=poison, step=chunk_idx)
        buf = self._host[self._launched % _HOST_RING]
        self._launched += 1
        buf.wait()
        frames, valid = self._pack(plan, chunk_len, buf)
        valid_host = valid.numpy().copy()
        t0 = time.time()
        frames_d = frames.to(self.device, non_blocking=True)
        valid_d = valid.to(self.device, non_blocking=True)
        rec = _InFlight(chunk_idx=chunk_idx,
                        active=[(i, s) for i, s, _ in plan],
                        valid=valid_host, buf=buf, host_lp=None,
                        host_finite=None, done=buf.event, new_states=None,
                        t_launch=t0, chunk_len=chunk_len,
                        states_in=states_in, frames_d=frames_d,
                        valid_d=valid_d, poison_slot=poison)
        try:
            lp, rec.new_states, finite = self._fwd(states_in, frames_d,
                                                   valid_d)
        except Exception as e:              # noqa: BLE001 — the runner's
            if self._runner is None:
                raise
            rec.error = e
            return rec
        rec.host_lp, rec.host_finite = self._read_back(buf, lp, finite)
        return rec

    def _commit(self, rec: _InFlight) -> bool:
        """Resolve one in-flight chunk and commit it: wait on its event
        (the log-probs' copy to the host, behind the chunk call) — under
        the fault runner when configured, where a failed attempt is
        recomputed synchronously from COMMITTED state after the fault hook
        (``_on_engine_fault``) ran — feed the launch-to-commit wall time to
        the chunk-size policy and the deadline watchdog, scrub quarantined
        slots, then — only now — advance states, cursors, outputs and
        retirement.  Returns True iff the commit was clean (no fault, no
        quarantine): the async path adopts its speculative launch only
        then."""
        deadline = self._deadline_for(rec.chunk_len)

        def resolve():
            if rec.error is not None:
                raise rec.error
            if rec.done is not None:
                rec.done.synchronize()
            return rec.host_lp.numpy(), rec.new_states, rec.host_finite

        def retry():
            # the failed attempt is dead; recompute from the committed cache
            # (admissions for this chunk are already realized in it; only
            # the injected poison edit is re-applied).  Its copies go to the
            # same host set behind the failed attempt's on the same stream,
            # and the event recorded again covers both.
            states_in = self.states
            if rec.poison_slot is not None:
                states_in = _poisoned(states_in, rec.poison_slot)
            lp, new_states, finite = self._fwd(states_in, rec.frames_d,
                                               rec.valid_d)
            host_lp, host_finite = self._read_back(rec.buf, lp, finite)
            if rec.done is not None:
                rec.done.synchronize()
            return host_lp.numpy(), new_states, host_finite

        faults = []
        if self._runner is not None:
            def on_fault(exc, attempt):
                faults.append(exc)
                self._on_engine_fault(exc, attempt)

            host, new_states, finite = self._runner.run(
                rec.chunk_idx, resolve, on_fault=on_fault, retry_fn=retry,
                launched_at=rec.t_launch, deadline_s=deadline)
        else:
            host, new_states, finite = resolve()
        dt = time.time() - rec.t_launch
        self.chunk_walls.append(dt)
        if self._policy is not None:
            self._policy.observe(rec.chunk_len, dt)
        if self._runner is None and deadline is not None and dt > deadline:
            self._record('deadline_miss', dt=dt, deadline_s=deadline)

        quarantined = finite is not None and not bool(finite.all())
        if quarantined:
            new_states = self._quarantine(rec.active, finite, new_states)
        self.states = tuple((h.contiguous(), c.contiguous())
                            for h, c in new_states)
        for i, sess in rec.active:
            if sess.error is not None:      # quarantined this step
                continue
            # a copy: the host buffer is reused by a later chunk
            sess.consume(host[i, :rec.valid[i]].copy())
            if sess.remaining == 0:
                sess.t_done = time.time()
                self.sched.finish(i)
        self._step_idx += 1
        clean = not (quarantined or faults)
        if clean and self._tracker is not None and self._rung_idx > 0:
            # canary replay material, captured only while degraded (the
            # home rung pays nothing): what this commit consumed, on the
            # device (never written in place), and a host copy of what it
            # produced
            self._last_commit = {
                'states_in': rec.states_in, 'frames': rec.frames_d,
                'valid': rec.valid_d, 'lp': host.copy(),
                'new_states': self.states}
        return clean

    def _sync(self) -> None:
        """Async control-plane barrier: commit the in-flight chunk, if any.
        Preemption and eviction snapshots must read committed state, so
        every control op drains the pipeline first.  No-op in sync mode
        (nothing is ever left in flight)."""
        if self._pending is not None:
            rec, self._pending = self._pending, None
            self._commit(rec)

    # ------------------------------------------------- recovery / promotion
    def _poll_recovery(self) -> None:
        """Top-of-step recovery poll (§14): apply any scheduled heals
        (``faults.recover_at``, each engine step at most once) to the
        health tracker, then attempt a canary-validated promotion when
        capacity and the hysteresis window allow.  Keyed on the COMMITTED
        step index in both dispatch modes, so sync and async replay the
        same recovery trail."""
        if self._tracker is None:
            return
        heal_n = self.faults.recover_at.get(self._step_idx)
        if heal_n and self._step_idx not in self._healed_steps:
            self._healed_steps.add(self._step_idx)
            revived = self._tracker.heal(self._step_idx, heal_n)
            self._record('heal', domains=list(revived),
                         n_healed=int(heal_n))
        if self._rung_idx > 0:
            self._maybe_promote()

    def _promotion_due(self, step: int) -> bool:
        """True iff the recovery poll at committed step ``step`` may try a
        promotion: the engine is degraded, the rung above fits the healthy
        capacity after that step's scheduled heal, and the hysteresis
        window is open.  The async path does not speculate across such a
        step (``_speculate``), so a promotion lands before the same chunk
        in both dispatch modes.  (The reference's async engine speculates
        across it and promotes one chunk later than its sync engine.)"""
        if self._tracker is None or self._rung_idx == 0:
            return False
        heal = (0 if step in self._healed_steps
                else self.faults.recover_at.get(step, 0))
        healthy = min(self._tracker.n_domains,
                      self._tracker.n_healthy + heal)
        return (healthy >= self._rungs[self._rung_idx - 1].need
                and self._tracker.can_promote(step))

    def _canary_equal(self, a, b) -> bool:
        """Canary comparison on host copies: bitwise by default
        (``np.array_equal``), or allclose under an explicit
        ``canary_rtol`` opt-in for rungs that sum in other orders (K2, K1
        and the torch scan do on the card)."""
        rtol = self.faults.canary_rtol
        if rtol is None:
            return bool(np.array_equal(_host(a), _host(b)))
        return bool(np.allclose(_host(a), _host(b), rtol=rtol, atol=0.0))

    def _maybe_promote(self) -> None:
        """Attempt one climb-back step up the rung ladder (§14).

        Preconditions: the candidate rung (one above current) is within the
        tracker's healthy capacity, the hysteresis window is open, and —
        when the canary is armed — a committed chunk exists to validate
        against.  The pipeline is drained first (``_sync``), so a promotion
        NEVER lands mid-flight; the drain may itself fault or move rungs,
        so every precondition is re-checked after it.

        Canary protocol: build the candidate backend's chunk call, replay
        the last committed chunk as a SHADOW on the committed input state,
        and compare the replayed log-probs AND new states with the
        incumbent's committed results on the host.  Equal -> promote:
        re-place the packed cache (``elastic_replace``), adopt the
        candidate call, and re-arm the hysteresis window.  Unequal ->
        reject: emit ``promote_rejected`` and double the backoff.
        Commit-on-success end to end: no engine-visible state changes
        unless the canary passes."""
        step = self._step_idx
        if (self._tracker.n_healthy < self._rungs[self._rung_idx - 1].need
                or not self._tracker.can_promote(step)):
            return
        if self.faults.canary and self._last_commit is None:
            return                  # nothing committed to validate against
        self._sync()                # promotion never lands mid-flight
        if self._rung_idx == 0:
            return
        cand_idx = self._rung_idx - 1
        cand = self._rungs[cand_idx]
        if (self._tracker.n_healthy < cand.need
                or not self._tracker.can_promote(self._step_idx)):
            return
        lc = self._last_commit
        if self.faults.canary and lc is None:
            return
        prev_mesh = current_mesh()
        self._install_rung_mesh(cand)
        cand_fwd = self._rung_fwd(cand)
        if self.faults.canary:
            self._record('promote_canary', from_backend=self.backend,
                         to_backend=cand.backend, chunk=lc['lp'].shape[-2]
                         if lc['lp'].ndim >= 2 else 0)
            lp, st, _ = cand_fwd(lc['states_in'], lc['frames'], lc['valid'])
            ok = self._canary_equal(lp, lc['lp'])
            ref_leaves = [x for pair in lc['new_states'] for x in pair]
            got_leaves = [x for pair in st for x in pair]
            ok = ok and len(ref_leaves) == len(got_leaves) and all(
                self._canary_equal(g, r)
                for g, r in zip(got_leaves, ref_leaves))
            if not ok:
                # squash: the incumbent's topology back, nothing committed
                # (its placement untouched)
                if prev_mesh is not None:
                    install_mesh(prev_mesh)
                else:
                    clear_mesh()
                self._tracker.note_reject(self._step_idx)
                self._record('promote_rejected', from_backend=self.backend,
                             to_backend=cand.backend,
                             backoff=self._tracker.backoff)
                return
        prev = self.backend
        self._set_backend(cand.backend, cand_fwd)
        self.states = elastic_replace(self.states)
        self._rung_idx = cand_idx
        if cand_idx == 0:
            self._last_commit = None    # home rung: stop paying capture
        self._tracker.note_promote(self._step_idx)
        self._record('promote', from_backend=prev, to_backend=cand.backend,
                     n_dies=cand.n_dies,
                     healthy=list(self._tracker.healthy))

    def _speculate(self, rec: _InFlight):
        """Plan chunk k+1 while chunk k is still in flight (no mutation).

        Retirements and admissions are deterministic at launch time: a
        stream retires iff its remaining frames minus the in-flight valid
        count hit zero, and refill admits the pending queue (already in
        priority order) into free slots in slot order.  Returns ``(plan,
        admissions)`` — plan rows are (slot, session, speculative cursor) —
        or None when the next step cannot be speculated: nothing to run, a
        scheduled engine failure on the in-flight chunk (its commit will
        deviate), a promotion that may land at the next step's recovery
        poll (the next chunk must run on the rung the poll leaves, as in
        sync mode), or a waiting stream that outranks an active one (the
        commit-time priority preemption must run serialized)."""
        if self.faults is not None and (
                rec.chunk_idx in self.faults.fail_at
                or self._promotion_due(rec.chunk_idx + 1)):
            return None
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
        """Advance every active stream by up to one chunk: poll recovery
        (heals, a canary-validated promotion), admit pending streams into
        free slots (priority first), launch ONE batched call for all of
        them (padded slots masked out via ``valid_len``), and commit its
        outputs and retirements.  Synchronous mode launches and immediately
        commits (a depth-0 pipeline); ``async_dispatch`` defers the commit
        one step so host packing overlaps device compute (``_step_async``).
        With a fault config the commit runs under the ``FaultTolerantRunner``
        (``_commit``); nothing commits unless the attempt succeeded.
        Returns False when there was nothing to do."""
        self._poll_recovery()
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
        events (engine, then runner) with their counts and drops, the
        deadline misses, and the fault runtime's rung, healthy fault
        domains and last heartbeat (None without a fault config)."""
        done = self.sched.done
        lats = [s.t_done - s.t_enqueue for s in done if s.t_done]
        events = list(self.events)
        dropped = self.events.dropped
        if self._runner is not None:
            events += self._runner.events
            dropped += self._runner.events.dropped
        counts: dict = {}
        for e in events:
            counts[e['kind']] = counts.get(e['kind'], 0) + 1
        if self._runner is not None:
            misses = self._runner.deadline_misses
        elif self._policy is not None:
            misses = self._policy.misses
        else:
            misses = 0
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
            'events_dropped': dropped,
            'deadline_misses': misses,
            'rung': (self._rungs[self._rung_idx].label()
                     if self._rungs else self.backend),
            'healthy_domains': (list(self._tracker.healthy)
                                if self._tracker else None),
            'heartbeat': (self._runner.last_heartbeat
                          if self._runner else None),
        }
