"""Streaming server for the paper's CTC LSTM on the packed engine.

Utterances of MFCC frames in, per-frame CTC log-probs and incrementally
decoded phonemes out.  Every engine step advances all active streams
through one batched chunked call; on ``--lstm-backend cuda_seq_fused`` that
call is one kernel launch for the whole stack.  Runs on the card by
default; the full ``chipmunk-ctc`` configuration is the default and
``--smoke`` selects the reduced one::

    python -m repro_torch.launch.serve --requests 8 --slots 8 --chunk 16
    python -m repro_torch.launch.serve --device cpu --smoke --requests 4
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..core.lstm import BACKENDS
from ..models import chipmunk_net
from ..serving import StreamingEngine


class StreamServer:
    """Frame-stream serving front-end over ``serving.StreamingEngine``
    with incremental CTC decoding switched on."""

    def __init__(self, cfg, params, num_slots=4, chunk=16):
        self.engine = StreamingEngine(cfg, params, max_streams=num_slots,
                                      chunk=chunk, decode_ctc=True)

    def submit(self, frames: np.ndarray, priority: int = 0):
        """Queue one utterance ((L, n_in) frames)."""
        return self.engine.submit(frames, priority=priority)

    def drain(self):
        """Serve until every queued utterance is done; returns them."""
        return self.engine.run()

    @property
    def done(self):
        return self.engine.sched.done


def _run_stream_serving(cfg, args):
    params = chipmunk_net.init(cfg, torch.Generator().manual_seed(0),
                               device=args.device)
    server = StreamServer(cfg, params, num_slots=args.slots, chunk=args.chunk)
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
    print(f'streamed {stats["streams"]} utterances, {stats["frames"]} frames '
          f'in {wall:.2f}s ({stats["frames"] / wall:.1f} frames/s) on '
          f'{args.device} [{stats["backend"]}]; p50 latency '
          f'{stats["p50_latency_s"]:.3f}s, p50 chunk '
          f'{stats["p50_chunk_s"] * 1e3:.2f}ms')
    for s in sorted(server.done, key=lambda s: s.sid)[:3]:
        print(f'  stream {s.sid}: {s.length} frames -> '
              f'phonemes {s.decoder.symbols[:8]}')
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--arch', default='chipmunk-ctc',
                    choices=sorted(configs.ARCH_MODULES))
    ap.add_argument('--smoke', action='store_true',
                    help='use the reduced configuration instead of the full '
                         'one')
    ap.add_argument('--requests', type=int, default=6)
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--chunk', type=int, default=16,
                    help='frames per engine step')
    ap.add_argument('--lstm-backend', default='auto', choices=BACKENDS,
                    help='cuda_step serves on the CPU only (K5 has no '
                         'masked form)')
    ap.add_argument('--device', default='cuda',
                    help='torch device of weights and states (cuda, cpu)')
    args = ap.parse_args(argv)
    get = configs.get_smoke_config if args.smoke else configs.get_config
    cfg = get(args.arch).replace(lstm_backend=args.lstm_backend)
    return _run_stream_serving(cfg, args)


if __name__ == '__main__':
    main()
