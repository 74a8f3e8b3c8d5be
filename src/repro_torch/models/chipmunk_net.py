"""CTC-3L-421H-UNI — the paper's workload, forward and streaming, in PyTorch.

123 MFCC features -> 3x421 peephole LSTM -> 62 CTC outputs (log-probs).
Counterpart of ``repro.models.chipmunk_net``; the LSTM backend comes from
``cfg.lstm_backend`` (``core.lstm.BACKENDS``), the read-out einsum and
``log_softmax`` are plain torch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs import ArchConfig
from ..core.lstm import (LSTMStackParams, init_lstm_stack, lstm_stack_apply,
                         lstm_stack_chunk, stack_params_to)


def init(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
         device='cuda') -> LSTMStackParams:
    """Random weights for ``cfg`` drawn on the CPU from ``generator`` (a
    fresh one seeded 0 when None), then moved to ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = init_lstm_stack(cfg.lstm_inputs, cfg.lstm_hidden, cfg.n_layers,
                             cfg.n_outputs, generator, cfg.dtype())
    return stack_params_to(params, device)


def forward(cfg: ArchConfig, params: LSTMStackParams, frames: torch.Tensor):
    """frames: (B, T, n_in) -> log-probs (T, B, n_out), whole utterances
    from zero state on ``cfg.lstm_backend``."""
    xs = frames.transpose(0, 1).contiguous()            # (T, B, n_in)
    ys, _ = lstm_stack_apply(params, xs, backend=cfg.lstm_backend)
    return torch.log_softmax(ys, dim=-1)


def init_state(cfg: ArchConfig, batch: int, device='cuda'):
    """Streaming state: zero (h, c) per layer, each (batch, N_h)."""
    n_h = cfg.lstm_hidden
    return tuple((torch.zeros((batch, n_h), dtype=cfg.dtype(), device=device),
                  torch.zeros((batch, n_h), dtype=cfg.dtype(), device=device))
                 for _ in range(cfg.n_layers))


def stream_forward(cfg: ArchConfig, params: LSTMStackParams, states, frames,
                   valid_len=None, stack_weights=None):
    """A chunk of streaming frames through the network — the model half of
    the serving engine.  frames: (B, T, n_in); states: per-layer ``(h, c)``;
    ``valid_len``: optional (B,) per-stream valid frame counts (steps
    ``t >= valid_len[b]`` are identity on every layer's state);
    ``stack_weights``: the fused kernel's weights, built once by the caller
    (``core.lstm.lstm_stack_chunk``).  Returns
    (log-probs (B, T, n_out), new states).  Feeding chunks back to back is
    bit-equal to one whole-sequence call on the same backend, and the
    composition from zero state is allclose to ``forward``."""
    xs = frames.transpose(0, 1).contiguous()            # (T, B, n_in)
    ys, new_states = lstm_stack_chunk(params, xs, states,
                                      valid_len=valid_len,
                                      backend=cfg.lstm_backend,
                                      stack_weights=stack_weights)
    return torch.log_softmax(ys, dim=-1).transpose(0, 1), new_states
