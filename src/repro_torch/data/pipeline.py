"""Deterministic, restartable training data for the paper's CTC workload:
the port of the ``lstm`` family's part of ``repro.data.pipeline``.

Batch ``t`` is a pure function of (seed, step), drawn with the reference's
numpy generator (Philox keyed by the seed, counter at the step), so a
restarted run resumes mid-stream with only the step counter, and the port's
batches are bit-identical to the reference's.  ``HostLoader`` stands in for
the reference's ``ShardedLoader``: one process, no mesh; each batch is
copied to the device as it is drawn (a pinned, non-blocking copy waits for
a trace that shows the copy in the step's way).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..configs import ArchConfig, ShapeConfig


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


def source_for(cfg: ArchConfig, shape: ShapeConfig, seed: int = 0):
    """The data source of ``cfg``'s family (only ``lstm`` is ported)."""
    if cfg.family != 'lstm':
        raise ValueError(f'no ported data source for family {cfg.family!r}')
    return SyntheticCTC(cfg, shape, seed)


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
