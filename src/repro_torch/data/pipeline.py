"""Deterministic, restartable training data: the port of
``repro.data.pipeline`` for every family (the paper's CTC LSTM and the
LMs).

Batch ``t`` is a pure function of (seed, step), drawn with the reference's
numpy generator (Philox keyed by the seed, counter at the step), so a
restarted run resumes mid-stream with only the step counter, and the port's
batches are bit-identical to the reference's.  Sources: ``SyntheticCTC``
(MFCC frames and phoneme labels), ``SyntheticLM`` (a Zipf token stream,
and for the audio and VLM families the stub frontend's ``source`` frames
or patches) and ``TokenFile`` (windows of a memory-mapped token corpus).
``HostLoader`` feeds one process with no mesh and no prefetch thread;
each batch is copied to the device as it is drawn (a pinned, non-blocking
copy waits for a trace that shows the copy in the step's way).
``ShardedLoader`` is the reference's: a prefetch thread draws each rank's
rows of the global batch, and each batch leaf becomes a DTensor placed by
its ``sharding.Layout`` (``launch.train.batch_shardings``), the rank
holding its own rows.  ``PipelineConfig`` carries the reference's seed
and prefetch depth.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..configs import ArchConfig, ShapeConfig


@dataclasses.dataclass
class PipelineConfig:
    seed: int = 0
    prefetch: int = 2


def _rng_for_step(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


class SyntheticCTC:
    """MFCC-frame/phoneme-label pairs for CTC-3L-421H-UNI (paper Sec. 4.2),
    drawn exactly as the reference draws them."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg, self.shape, self.seed = cfg, shape, seed

    def host_batch(self, step: int, lo: int, hi: int) -> Dict[str,
                                                              np.ndarray]:
        rng = _rng_for_step(self.seed, step)
        b = self.shape.global_batch
        t = self.shape.seq_len
        n_lab = max(t // 8, 1)
        frames = rng.standard_normal(
            (b, t, self.cfg.lstm_inputs), dtype=np.float32)
        labels = rng.integers(1, self.cfg.n_outputs, size=(b, n_lab),
                              dtype=np.int32)
        frame_len = rng.integers(t // 2, t + 1, size=(b,), dtype=np.int32)
        label_len = np.minimum(rng.integers(1, n_lab + 1, size=(b,)),
                               frame_len // 2).astype(np.int32)
        return {'frames': frames[lo:hi], 'labels': labels[lo:hi],
                'frame_len': frame_len[lo:hi],
                'label_len': label_len[lo:hi]}


class SyntheticLM:
    """Zipf-ish token stream; labels are the next tokens.  Drawn exactly
    as the reference draws it (the whole batch, then rows lo .. hi).  For
    the audio and VLM families also ``source`` (hi - lo, n_source_tokens,
    d_model) f32, standard normal, drawn after the tokens from the same
    generator."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0):
        self.cfg, self.shape, self.seed = cfg, shape, seed

    def host_batch(self, step: int, lo: int, hi: int) -> Dict[str,
                                                              np.ndarray]:
        rng = _rng_for_step(self.seed, step)
        b, s = self.shape.global_batch, self.shape.seq_len
        zipf = np.minimum(rng.zipf(1.3, size=(b, s + 1)),
                          self.cfg.vocab_size) - 1
        toks = zipf.astype(np.int32)[lo:hi]
        out = {'tokens': toks[:, :-1], 'labels': toks[:, 1:]}
        if self.cfg.family in ('audio', 'vlm'):
            out['source'] = rng.standard_normal(
                (hi - lo, self.cfg.n_source_tokens, self.cfg.d_model),
                dtype=np.float32)
        return out


class TokenFile:
    """Memory-mapped uint16/uint32 token corpus, read as random windows
    of ``seq_len + 1`` tokens (the reference's draw)."""

    def __init__(self, path: str, cfg: ArchConfig, shape: ShapeConfig,
                 seed: int = 0, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode='r')
        self.cfg, self.shape, self.seed = cfg, shape, seed

    def host_batch(self, step: int, lo: int, hi: int) -> Dict[str,
                                                              np.ndarray]:
        rng = _rng_for_step(self.seed, step)
        s = self.shape.seq_len
        starts = rng.integers(0, len(self.tokens) - s - 1,
                              size=self.shape.global_batch)[lo:hi]
        rows = np.stack([self.tokens[st:st + s + 1] for st in starts])
        rows = rows.astype(np.int32) % self.cfg.vocab_size
        return {'tokens': rows[:, :-1], 'labels': rows[:, 1:]}


def source_for(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
               token_file: Optional[str] = None):
    """The data source of ``cfg``'s family: ``SyntheticCTC`` for the CTC
    LSTM; for every LM ``TokenFile`` over ``token_file`` when given, else
    ``SyntheticLM``, as in the reference."""
    if cfg.family == 'lstm':
        return SyntheticCTC(cfg, shape, seed)
    if token_file:
        return TokenFile(token_file, cfg, shape, seed)
    return SyntheticLM(cfg, shape, seed)


class HostLoader:
    """Iterate ``(step, batch)`` from ``start_step`` on, each batch's arrays
    as tensors on ``device``."""

    def __init__(self, source, shape: ShapeConfig, device,
                 start_step: int = 0):
        self.source, self.shape = source, shape
        self.device = torch.device(device)
        self.step = start_step

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        step = self.step
        host = self.source.host_batch(step, 0, self.shape.global_batch)
        self.step += 1
        return step, {k: self._to_device(v) for k, v in host.items()}


class ShardedLoader:
    """Iterate ``(step, batch)`` from ``start_step`` on, each leaf a
    DTensor placed by ``shardings[name]`` (a ``sharding.Layout``; a name
    without one: a plain tensor).  Each rank draws the global batch and
    keeps its rows (the reference's per-host slice, every rank a host);
    ``prefetch`` batches are drawn ahead on a thread.  ``device``: where
    the local rows go (the mesh's device type by default)."""

    def __init__(self, source, shape: ShapeConfig, shardings: Dict[str, Any],
                 start_step: int = 0, prefetch: int = 2, device=None):
        self.source, self.shape, self.shardings = source, shape, shardings
        self.step = start_step
        lay = next(iter(shardings.values()), None)
        self.device = torch.device(
            device or (lay.mesh.device_type if lay is not None else 'cpu'))
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            host = self.source.host_batch(step, 0, self.shape.global_batch)
            try:
                self._q.put((step, host), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def _assemble(self, host: Dict[str, np.ndarray]):
        out = {}
        for k, v in host.items():
            t = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            lay = self.shardings.get(k)
            out[k] = t if lay is None else lay.distribute(t)
        return out

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
        return self

    def __next__(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        step, host = self._q.get()
        self.step = step + 1
        return step, self._assemble(host)

    def close(self):
        self._stop.set()
