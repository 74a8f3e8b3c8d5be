"""Weights and input frames, made on the device from the run's seed and
handed alike to the program and to the reference.

Weights follow the program's own init scheme (``core.lstm
.init_lstm_params``): each matrix uniform in [-1, 1) over the square root
of its fan-in, peepholes uniform in [-1, 1) times 0.1, biases 0 but the
forget gate's 1, the read-out uniform over sqrt(N_h) with a zero bias.
They are drawn in one call from a ``torch.Generator`` on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .gen import rng_for

GATES, FORGET = 4, 1


def torch_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for a ``torch.Generator``, one per use of the seed."""
    return int(rng_for(seed, stream).integers(0, 2 ** 63 - 1))


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{'layers': [{'w_x' (4, N, n_in), 'w_h' (4, N, N), 'w_peep' (3, N),
    'b' (4, N)}, ...], 'w_out' (n_out, N), 'b_out' (n_out,)}``, float32 on
    ``device``."""
    n_x, N, L, n_out = cfg['n_x'], cfg['n_h'], cfg['n_layers'], cfg['n_out']
    shapes = []
    for l in range(L):
        n_in = n_x if l == 0 else N
        shapes += [(GATES, N, n_in), (GATES, N, N), (3, N)]
    shapes.append((n_out, N))
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 'weights'))
    total = sum(int(np.prod(s)) for s in shapes)
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    parts = iter(torch.split(flat, [int(np.prod(s)) for s in shapes]))
    layers = []
    for l in range(L):
        n_in = n_x if l == 0 else N
        b = torch.zeros((GATES, N), device=device)
        b[FORGET] = 1.0
        layers.append(dict(
            w_x=next(parts).view(GATES, N, n_in) / n_in ** 0.5,
            w_h=next(parts).view(GATES, N, N) / N ** 0.5,
            w_peep=next(parts).view(3, N) * 0.1, b=b))
    w_out = next(parts).view(n_out, N) / N ** 0.5
    return dict(layers=layers, w_out=w_out,
                b_out=torch.zeros(n_out, device=device))


def make_frame_pool(n_frames: int, width: int, seed: int, device
                    ) -> torch.Tensor:
    """(n_frames, width) standard-normal float32 frames on ``device``:
    every request's frames are a window of this pool."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 'frames'))
    return torch.randn((n_frames, width), generator=gen, device=device)
