"""Serving entry point of the port: streams for the paper's CTC LSTM, tokens
for the dense, MoE and recurrent LMs.

``--arch`` picks the front end by family.  A dense LM (``qwen3-14b``,
``qwen2.5-14b``, ``codeqwen1.5-7b``, ``minicpm-2b``), an MoE LM
(``mixtral-8x22b``, ``kimi-k2-1t-a32b``) or a recurrent LM (``xlstm-1.3b``:
mLSTM and sLSTM blocks; ``hymba-1.5b``: attention beside Mamba heads) is
served by ``SlotServer``: a fixed number of decode slots, each with its
own cache (a KV cache, a ring of the sliding window's slots for Mixtral
and Hymba's windowed layers; xLSTM's recurrent state; Hymba's Mamba state
beside its K/V), refilled from the queue as requests finish (continuous
batching), greedy sampling, the prompt fed token by token through the
bundle's ``decode_step`` as the reference does; attention runs on K8 on
the card (xLSTM has none).  The full configuration is the default
(Qwen3-14B: 40 layers, d_model 5120, bf16, random weights from seed 0;
xLSTM-1.3B and Hymba-1.5B whole, f32 weights; the MoE configs at full
width do not fit one card).  The cross-attention configs
(``whisper-base``, ``llama-3.2-vision-90b``) are refused before any init:
the reference's ``SlotServer`` passes no source (ROADMAP R4), so they
decode through ``transformer.precompute_cross_kv`` and
``decode_step(..., cross_kv=)``::

    python -m repro_torch.launch.serve --arch qwen3-14b --requests 6 \
        --slots 4 --max-new 16
    python -m repro_torch.launch.serve --arch qwen3-14b --smoke \
        --device cpu
    python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke \
        --requests 6 --slots 4 --max-new 16
    python -m repro_torch.launch.serve --arch xlstm-1.3b --requests 6 \
        --slots 4 --max-new 16
    python -m repro_torch.launch.serve --arch hymba-1.5b --smoke \
        --device cpu

The paper's CTC LSTM streams utterances of MFCC frames in, and per-frame
CTC log-probs and incrementally decoded phonemes out.  Every engine step
advances all active streams through one batched chunked call; on
``--lstm-backend cuda_seq_fused`` that call is one kernel launch for the
whole stack.  Runs on the card by
default; the full ``chipmunk-ctc`` configuration is the default and
``--smoke`` selects the reduced one::

    python -m repro_torch.launch.serve --requests 8 --slots 8 --chunk 16
    python -m repro_torch.launch.serve --async --deadline-slo 1.0
    python -m repro_torch.launch.serve --device cpu --smoke --requests 4

``--systolic-topology NAME`` installs a ``launch.mesh`` preset on
``--device`` first, so that ``auto`` scales out over its engines: the
staged ``cuda_seq_fused_systolic`` on ``graves-75``, the paper's 3x(5x5)
(DESIGN.md §9), the layerwise ``cuda_seq_systolic`` on a stage-1 grid::

    python -m repro_torch.launch.serve --systolic-topology graves-75
    python -m repro_torch.launch.serve --device cpu --smoke \
        --systolic-topology 2x2

``--die-topology NAME`` installs a two-level die preset (DESIGN.md §14):
its dies are the fault domains, so with the fault flags an engine failure
re-forms the systolic array on the surviving dies (``graves-3x25``: 75 ->
50 -> 25 engines) before the ladder reaches a flat kernel, and a healed die
comes back through the canary::

    python -m repro_torch.launch.serve --die-topology graves-3x25 \
        --fail-engines 1@2 --recover-at-step 1@5 --promote-hysteresis 2

``--async`` packs and launches the next chunk while the one in flight
computes (DESIGN.md §11); ``--deadline-slo FACTOR`` attaches the chunk-size
policy, whose budget is chunk x 10 ms frame period x FACTOR.  Both leave
every stream's outputs bit-equal to sync serving at a fixed chunk.

The fault flags attach a ``runtime.ServingFaultConfig`` (DESIGN.md §10,
§14): ``--fail-at-step``/``--fail-engines`` inject engine failures that
step the backend down the ladder (``cuda_seq_fused_systolic`` ->
``cuda_seq_fused`` -> ``cuda_seq`` -> ``torch_scan``),
``--recover-at-step`` heals them for a canary-validated climb back
(``--promote-hysteresis``, ``--no-canary``), ``--poison-slot`` exercises
the quarantine, ``--stream-ckpt-dir`` the stream checkpoints and
``--deadline-factor`` the deadline watchdog::

    python -m repro_torch.launch.serve --device cpu --smoke --requests 4 \
        --slots 2 --chunk 4 --lstm-backend cuda_seq_fused \
        --fail-engines 1@1 --recover-at-step 1@2 --promote-hysteresis 1

``--schedule-cache PATH`` installs a measured-schedule cache
(``repro_torch.tune``) that dispatch consults before its cold rules: the
int8 stack backend, the f32 stack backend of ``auto``, and the deadline
policy's chunk ceiling (``serving.tuned_chunk_ceiling``); ``--tune`` runs
``tune.tune_serving_config`` for this configuration first (a timed K4
against K3 trial, and the serving loop timed at each chunk depth) and
saves the entries to ``--schedule-cache`` when given::

    python -m repro_torch.launch.serve --tune --schedule-cache sched.json \
        --slots 8 --chunk 16 --deadline-slo 1.0
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from .. import configs
from ..core.lstm import BACKENDS
from ..kernels.flash_attention import flash_attention
from ..models import chipmunk_net, get_bundle
from ..runtime import ChunkSizePolicy, ServingFaultConfig
from ..serving import SlotScheduler, StreamingEngine, tuned_chunk_ceiling
from .mesh import (DIE_TOPOLOGIES, SYSTOLIC_TOPOLOGIES, install_die_topology,
                   install_systolic_topology)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None
    t_enqueue: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # prompt tokens not yet fed into the slot's cache (reset on admission)
    _prefill_left: List[int] = dataclasses.field(default_factory=list)


def refuse_cross(cfg) -> None:
    """``SlotServer`` serves no cross-attention config: the reference's
    ``SlotServer`` calls ``decode_step`` without ``cross_kv`` and fails on
    the cross layers (ROADMAP R4), and a request carries no source.  Those
    families decode through ``transformer.precompute_cross_kv`` +
    ``decode_step(..., cross_kv=)``."""
    if cfg.cross_attn_every or cfg.n_encoder_layers:
        raise NotImplementedError(
            f'{cfg.name}: SlotServer serves no cross-attention config '
            f'(R4: the reference\'s SlotServer passes no source to '
            f'decode_step); decode through transformer.precompute_cross_kv '
            f'and decode_step(..., cross_kv=)')


class SlotServer:
    """``num_slots`` concurrent decodes of an LM; greedy sampling;
    per-slot refill (the reference's ``SlotServer``).

    Each slot owns its own cache (batch 1), so a refill never perturbs a
    neighbour; a prompt goes through ``decode_step`` token by token.  Slot
    bookkeeping lives in ``serving.SlotScheduler``; this class owns the
    caches, on the parameters' device.  A cross-attention config is
    refused (``refuse_cross``)."""

    def __init__(self, cfg, params, num_slots=4, max_seq=128):
        refuse_cross(cfg)
        self.cfg = cfg
        self.bundle = get_bundle(cfg)
        self.params = params
        self.max_seq = max_seq
        self.device = params['embed']['table'].device
        self.sched: SlotScheduler[Request] = SlotScheduler(num_slots)
        self.caches = [self._fresh_cache() for _ in range(num_slots)]
        self.pos = [0] * num_slots

    def _fresh_cache(self):
        return self.bundle.init_cache(1, self.max_seq, self.device)

    @property
    def done(self) -> List[Request]:
        return self.sched.done

    def submit(self, req: Request):
        req.t_enqueue = time.time()
        req.out = []
        self.sched.submit(req)

    def _admit(self, i: int, req: Request):
        # fresh cache per admission: a recycled slot never leaks state
        self.caches[i] = self._fresh_cache()
        self.pos[i] = 0
        req._prefill_left = list(req.prompt)

    def step(self):
        """One decode step across all active slots."""
        self.sched.refill(self._admit)
        for i, req in self.sched.active():
            if req._prefill_left:
                tok = req._prefill_left.pop(0)
                emit = not req._prefill_left
            else:
                tok = req.out[-1]
                emit = True
            logits, self.caches[i] = self.bundle.decode_step(
                self.params, self.caches[i],
                torch.tensor([[tok]], device=self.device), self.pos[i])
            self.pos[i] += 1
            if emit:
                nxt = int(torch.argmax(logits[0, -1]))
                if req.t_first is None:
                    req.t_first = time.time()
                req.out.append(nxt)
                if (len(req.out) >= req.max_new
                        or self.pos[i] >= self.max_seq - 1):
                    req.t_done = time.time()
                    self.sched.finish(i)

    def drain(self):
        while self.sched.busy:
            self.step()


class StreamServer:
    """Frame-stream serving front-end over ``serving.StreamingEngine``
    with incremental CTC decoding switched on; ``faults`` (a
    ``runtime.ServingFaultConfig``, None: no fault runtime),
    ``async_dispatch`` and ``chunk_policy`` (a ``runtime.ChunkSizePolicy``,
    None: fixed chunks) pass through to the engine."""

    def __init__(self, cfg, params, num_slots=4, chunk=16, faults=None,
                 async_dispatch=False, chunk_policy=None):
        self.engine = StreamingEngine(cfg, params, max_streams=num_slots,
                                      chunk=chunk, decode_ctc=True,
                                      faults=faults,
                                      async_dispatch=async_dispatch,
                                      chunk_policy=chunk_policy)

    def submit(self, frames: np.ndarray, priority: int = 0):
        """Queue one utterance ((L, n_in) frames)."""
        return self.engine.submit(frames, priority=priority)

    def drain(self):
        """Serve until every queued utterance is done; returns them."""
        return self.engine.run()

    @property
    def done(self):
        return self.engine.sched.done


def deadline_policy(cfg, chunk: int, slots: int, slo: float
                    ) -> ChunkSizePolicy:
    """The ``--deadline-slo`` chunk-size policy: budget ``chunk`` x 10 ms x
    ``slo``, its ceiling the tuned chunk depth of an installed schedule
    cache (``tuned_chunk_ceiling``; ``chunk`` on a miss)."""
    return ChunkSizePolicy(chunk_max=tuned_chunk_ceiling(cfg, chunk, slots),
                           slack=slo)


def _run_token_serving(cfg, args):
    """Serve ``args.requests`` random prompts (3-7 tokens, numpy seed 0)
    through ``SlotServer`` on ``args.device`` with weights from seed 0;
    prints the reference's summary line, then the device, the parameters
    (and those a token runs through: an MoE's experts at top_k / E), the
    attention backend and K8's launches.  Returns the numbers and the
    requests.  A cross-attention config is refused before any init
    (``refuse_cross``)."""
    refuse_cross(cfg)
    bundle = get_bundle(cfg)
    params = bundle.init(torch.Generator(args.device).manual_seed(0),
                         args.device)
    server = SlotServer(cfg, params, num_slots=args.slots)
    rng = np.random.RandomState(0)
    launches = flash_attention.launches
    t0 = time.time()
    for r in range(args.requests):
        prompt = rng.randint(1, cfg.vocab_size,
                             size=rng.randint(3, 8)).tolist()
        server.submit(Request(rid=r, prompt=prompt, max_new=args.max_new))
    server.drain()
    wall = time.time() - t0
    launches = flash_attention.launches - launches
    toks = sum(len(r.out) for r in server.done)
    lat = [r.t_done - r.t_enqueue for r in server.done]
    print(f'served {len(server.done)} requests, {toks} tokens in {wall:.2f}s '
          f'({toks / wall:.1f} tok/s); p50 latency {np.median(lat):.2f}s')
    print(f'{cfg.name} on {args.device}: {bundle.param_count(params)} '
          f'parameters ({bundle.active_param_count(params)} active), '
          f'attention {cfg.attn_backend}, K8 launches {launches}')
    for r in sorted(server.done, key=lambda r: r.rid)[:3]:
        print(f'  req {r.rid}: prompt {r.prompt[:4]}... -> {r.out}')
    return dict(requests=len(server.done), tokens=toks, wall_s=wall,
                tok_per_s=toks / wall, p50_latency_s=float(np.median(lat)),
                k8_launches=launches, done=server.done)


def _parse_at_spec(spec: str):
    """Parse a repeatable ``VALUE@STEP`` injection flag into (step, value)."""
    value, step = spec.split('@')
    return int(step), int(value)


def _build_fault_config(args):
    """Assemble a ``runtime.ServingFaultConfig`` from the CLI fault flags;
    returns None when no fault feature was requested (the engine then runs
    without the fault runtime)."""
    fail_at = dict(_parse_at_spec(s) for s in (args.fail_engines or []))
    if args.fail_at_step is not None and args.fail_at_step not in fail_at:
        fail_at[args.fail_at_step] = 1
    poison_at = dict(_parse_at_spec(s) for s in (args.poison_slot or []))
    recover_at = dict(_parse_at_spec(s) for s in (args.recover_at or []))
    if not (fail_at or poison_at or recover_at or args.stream_ckpt_dir
            or args.deadline_factor is not None):
        return None
    return ServingFaultConfig(fail_at=fail_at, poison_at=poison_at,
                              recover_at=recover_at,
                              promote_hysteresis=args.promote_hysteresis,
                              canary=args.canary,
                              backoff_s=0.0,
                              deadline_factor=args.deadline_factor,
                              checkpoint_dir=args.stream_ckpt_dir)


def _print_fault_summary(stats) -> None:
    """The fault runtime's counts and its ladder moves, one line each."""
    counts = stats['event_counts']
    print(f'fault summary: backend={stats["backend"]} '
          f'rung={stats["rung"]} '
          f'degrade={counts.get("degrade", 0)} '
          f'promote={counts.get("promote", 0)} '
          f'quarantine={counts.get("quarantine", 0)} '
          f'deadline_misses={stats["deadline_misses"]} '
          f'checkpoints={counts.get("checkpoint", 0)} '
          f'events_dropped={stats["events_dropped"]}')
    for e in stats['events']:
        if e['kind'] == 'degrade':
            print(f'  degrade @step {e["step"]}: {e["from_backend"]} -> '
                  f'{e["to_backend"]} ({e["n_dead"]} engine(s) dead, '
                  f'domain {e["domain"]})')
        elif e['kind'] == 'heal':
            print(f'  heal @step {e["step"]}: domains {e["domains"]} '
                  f'healed')
        elif e['kind'] == 'promote_canary':
            print(f'  promote_canary @step {e["step"]}: replaying '
                  f'committed chunk on {e["to_backend"]}')
        elif e['kind'] == 'promote':
            print(f'  promote @step {e["step"]}: {e["from_backend"]} -> '
                  f'{e["to_backend"]} (healthy domains {e["healthy"]})')
        elif e['kind'] == 'promote_rejected':
            print(f'  promote_rejected @step {e["step"]}: '
                  f'{e["to_backend"]} canary mismatch '
                  f'(backoff -> {e["backoff"]})')


def _run_stream_serving(cfg, args):
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(0),
                               device=args.device)
    policy = (None if args.deadline_slo is None else
              deadline_policy(cfg, args.chunk, args.slots, args.deadline_slo))
    faults = _build_fault_config(args)
    server = StreamServer(cfg, params, num_slots=args.slots, chunk=args.chunk,
                          faults=faults, async_dispatch=args.async_dispatch,
                          chunk_policy=policy)
    rng = np.random.RandomState(0)
    t0 = time.time()
    for r in range(args.requests):
        frames = rng.randn(rng.randint(args.chunk, 4 * args.chunk),
                           cfg.lstm_inputs).astype(np.float32) * 0.5
        # every 3rd utterance is a latency-SLO stream (priority admission)
        server.submit(frames, priority=1 if r % 3 == 2 else 0)
    server.drain()
    wall = time.time() - t0
    stats = server.engine.stats()
    mode = 'async' if stats['async'] else 'sync'
    print(f'streamed {stats["streams"]} utterances, {stats["frames"]} frames '
          f'in {wall:.2f}s ({stats["frames"] / wall:.1f} frames/s, {mode}) '
          f'on {args.device} [{stats["backend"]}]; p50 latency '
          f'{stats["p50_latency_s"]:.3f}s, p50 chunk '
          f'{stats["p50_chunk_s"] * 1e3:.2f}ms')
    if args.deadline_slo is not None:
        print(f'deadline slo: chunk_max={policy.chunk_max} '
              f'chunk_len={stats["chunk_len"]} '
              f'deadline_misses={stats["deadline_misses"]}')
    for s in sorted(server.done, key=lambda s: s.sid)[:3]:
        print(f'  stream {s.sid}: {s.length} frames -> '
              f'phonemes {s.decoder.symbols[:8]}')
    if faults is not None:
        _print_fault_summary(stats)
    return stats


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's argument parser."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', default='chipmunk-ctc',
                    choices=sorted(configs.ARCH_MODULES))
    ap.add_argument('--smoke', action='store_true',
                    help='use the reduced configuration instead of the full '
                         'one')
    ap.add_argument('--requests', type=int, default=6)
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--max-new', type=int, default=8,
                    help='tokens generated per request (token families)')
    ap.add_argument('--chunk', type=int, default=16,
                    help='frames per engine step (LSTM streaming)')
    ap.add_argument('--lstm-backend', default='auto', choices=BACKENDS,
                    help='cuda_step serves on the CPU only (K5 has no '
                         'masked form)')
    ap.add_argument('--device', default='cuda',
                    help='torch device of weights and states (cuda, cpu)')
    ap.add_argument('--systolic-topology', default=None,
                    choices=sorted(SYSTOLIC_TOPOLOGIES),
                    help='install a systolic mesh preset (every engine on '
                         '--device) before serving: stage-1 presets make '
                         'auto pick cuda_seq_systolic, stage>1 presets the '
                         'staged cuda_seq_fused_systolic')
    ap.add_argument('--die-topology', default=None,
                    choices=sorted(DIE_TOPOLOGIES),
                    help='install a two-level die preset (every engine on '
                         '--device): dies are fault domains; an engine '
                         'failure re-forms the systolic mesh on the '
                         'surviving dies (an intermediate ladder rung) and '
                         'a healed die is canary-validated back in')
    ap.add_argument('--async', dest='async_dispatch', action='store_true',
                    help='double-buffered dispatch (DESIGN.md §11): the '
                         'next chunk is packed and launched while the '
                         'in-flight one computes; outputs stay bit-equal '
                         'to sync serving')
    ap.add_argument('--deadline-slo', type=float, default=None,
                    metavar='FACTOR',
                    help='attach the deadline-aware chunk-size policy: '
                         'budget = chunk * 10ms frame period * FACTOR '
                         '(the Table-2 arrival rate); chunk length adapts '
                         'to observed launch-to-commit wall times')
    ap.add_argument('--fail-at-step', type=int, default=None,
                    help='declare one engine dead at this engine step '
                         '(exercises the degradation ladder '
                         'cuda_seq_fused_systolic -> cuda_seq_fused -> '
                         'cuda_seq -> torch_scan)')
    ap.add_argument('--fail-engines', action='append', default=None,
                    metavar='N@STEP',
                    help='declare N engines dead at STEP (repeatable)')
    ap.add_argument('--poison-slot', action='append', default=None,
                    metavar='SLOT@STEP',
                    help='poison slot SLOT with NaN state before STEP '
                         '(repeatable; exercises quarantine)')
    ap.add_argument('--recover-at-step', dest='recover_at', action='append',
                    default=None, metavar='N@STEP',
                    help='heal N failed fault domains at engine step STEP '
                         '(repeatable; exercises the canary-validated climb '
                         'back up the ladder)')
    ap.add_argument('--promote-hysteresis', type=int, default=4,
                    help='engine steps a promotion must wait after a '
                         'failure/promotion/rejection; flaps and rejected '
                         'canaries double it (exponential backoff)')
    ap.add_argument('--no-canary', dest='canary', action='store_false',
                    default=True,
                    help='promote on capacity + hysteresis alone, without '
                         'the shadow-replay canary validation')
    ap.add_argument('--stream-ckpt-dir', default=None,
                    help='directory for per-stream (h, c) + cursor '
                         'checkpoints (enables preempt/resume across runs)')
    ap.add_argument('--deadline-factor', type=float, default=None,
                    help='per-chunk deadline as a multiple of the paper '
                         'real-time frame budget (records deadline_miss '
                         'events)')
    ap.add_argument('--schedule-cache', default=None, metavar='PATH',
                    help='install a measured-schedule cache '
                         '(repro_torch.tune JSON; empty if PATH does not '
                         'exist): dispatch consults its winners before the '
                         'cold rules; dispatch-only, numerics unchanged')
    ap.add_argument('--tune', action='store_true',
                    help='before serving, tune this configuration: a timed '
                         'K4 against K3 trial at (chunk, slots) and the '
                         'serving loop timed at each chunk depth (outputs '
                         'bit-equal across depths), recorded in the '
                         'installed cache and saved to --schedule-cache '
                         'when given')
    return ap


def install_topology(name: str, device) -> None:
    """``--systolic-topology``: install the preset with every engine on
    ``device`` and print its shape and the device each stage sits on."""
    mesh = install_systolic_topology(name, devices=device)
    where = ', '.join(
        f'stage {s} on ' + '/'.join(sorted({
            str(mesh.engine(s, r, c)) for r in range(mesh.rows)
            for c in range(mesh.cols)})) for s in range(mesh.stage))
    print(f'installed systolic topology {name}: {mesh.shape} ({where})')


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.systolic_topology:
        install_topology(args.systolic_topology, args.device)
    if args.die_topology:
        dm = install_die_topology(args.die_topology, devices=args.device)
        print(f'installed die topology {args.die_topology}: {dm.dies} dies '
              f'x {dm.engines_per_die} engines '
              f'({dm.dies}x{dm.stage}x{dm.rows}x{dm.cols})')
    get = configs.get_smoke_config if args.smoke else configs.get_config
    cfg = get(args.arch).replace(lstm_backend=args.lstm_backend)
    if cfg.family != 'lstm':
        return _run_token_serving(cfg, args)
    if args.schedule_cache or args.tune:
        _install_schedule_cache(cfg, args)
    return _run_stream_serving(cfg, args)


def _install_schedule_cache(cfg, args) -> None:
    """``--schedule-cache`` / ``--tune``: install the cache (loaded, or
    empty), tune into it, save it."""
    import pathlib
    from ..tune import (ScheduleCache, install_schedule_cache,
                        tune_serving_config)
    path = pathlib.Path(args.schedule_cache) if args.schedule_cache else None
    cache = install_schedule_cache(ScheduleCache.load(path)
                                   if path is not None and path.exists()
                                   else ScheduleCache())
    print(f'installed schedule cache: {len(cache)} entries'
          + (f' from {path}' if path is not None and path.exists() else ''))
    if not args.tune:
        return
    entries, records = tune_serving_config(cfg, chunk=args.chunk,
                                           slots=args.slots, cache=cache,
                                           device=args.device)
    for r in records:
        what = r.params.get('backend') if r.suite == 'q_stack_backend' \
            else f"Tc={r.params['tc']}"
        print(f'  trial {r.suite}: {what} {r.metrics["measured_us"]:.1f} us')
    for e in entries:
        what = e.backend or f'Tc={e.tc}'
        print(f'tuned {e.kind}: {what} ({e.source})')
    if path is not None:
        cache.save(path)
        print(f'saved {len(cache)} entries -> {path}')


if __name__ == '__main__':
    main()
