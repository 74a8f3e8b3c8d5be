"""CTC-3L-421H-UNI — the paper's workload, trainable and streaming, in
PyTorch.

123 MFCC features -> 3x421 peephole LSTM -> 62 CTC outputs (log-probs).
Counterpart of ``repro.models.chipmunk_net``; the LSTM backend comes from
``cfg.lstm_backend`` (``core.lstm.BACKENDS``), the read-out einsum and
``log_softmax`` are plain torch, and ``loss_fn`` is the mean CTC loss.
On DTensors (a sharded step, ``sharding``) the stack and the CTC
recursion run on each rank's own streams (``sharding.run_local``), the
weights made whole first: data parallel, as the reference's ``lstm``
family rule places the batch over the whole mesh.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs import ArchConfig
from ..core import ctc
from ..core.lstm import (LSTMParams, LSTMStackParams, init_lstm_stack,
                         lstm_stack_apply, lstm_stack_chunk, stack_params_to)
from ..sharding import is_dtensor, logical, replicated, run_local
from ..tree import leaves, unflatten_like


def init(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
         device='cuda') -> LSTMStackParams:
    """Random weights for ``cfg`` drawn on the CPU from ``generator`` (a
    fresh one seeded 0 when None), then moved to ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = init_lstm_stack(cfg.lstm_inputs, cfg.lstm_hidden, cfg.n_layers,
                             cfg.n_outputs, generator, cfg.dtype())
    return stack_params_to(params, device)


def axes(cfg: ArchConfig) -> LSTMStackParams:
    """The logical axes of ``init``'s parameters: the systolic axes
    ('lstm_row' -> TP, 'lstm_col' -> DP/FSDP), so under a production mesh
    the weight matrices tile in 2-D like the paper's engine grid."""
    layer = LSTMParams(w_x=(None, 'lstm_row', 'lstm_col'),
                       w_h=(None, 'lstm_row', 'lstm_col'),
                       w_peep=(None, 'lstm_row'), b=(None, 'lstm_row'))
    return LSTMStackParams(layers=tuple(layer for _ in range(cfg.n_layers)),
                           w_out=('lstm_row', 'lstm_col'),
                           b_out=('lstm_row',))


def state_axes(cfg: ArchConfig):
    """The logical axes of ``init_state``'s (h, c) per layer."""
    return tuple((('batch', 'lstm_row'), ('batch', 'lstm_row'))
                 for _ in range(cfg.n_layers))


def forward(cfg: ArchConfig, params: LSTMStackParams, frames: torch.Tensor):
    """frames: (B, T, n_in) -> log-probs (T, B, n_out), whole utterances
    from zero state on ``cfg.lstm_backend``."""
    xs = frames.transpose(0, 1).contiguous()            # (T, B, n_in)
    xs = logical(xs, 'seq', 'batch', None)
    if is_dtensor(xs):
        # each rank runs its streams through the stack's kernels
        flat = leaves(params)
        ys = run_local(
            lambda x, *p: lstm_stack_apply(unflatten_like(params, p), x,
                                           backend=cfg.lstm_backend)[0],
            [xs] + [replicated(p) for p in flat], xs.placements)
    else:
        ys, _ = lstm_stack_apply(params, xs, backend=cfg.lstm_backend)
    return torch.log_softmax(ys, dim=-1)


def loss_fn(cfg: ArchConfig, params: LSTMStackParams,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean CTC loss of a batch: ``frames`` (B, T, n_in), ``labels`` (B, L),
    ``frame_len`` (B,), ``label_len`` (B,) — the reference's ``loss_fn``;
    differentiable on every backend."""
    log_probs = forward(cfg, params, batch['frames'])
    args = [log_probs, batch['labels'], batch['frame_len'],
            batch['label_len']]
    if is_dtensor(log_probs):     # the recursion runs on each rank's streams
        from torch.distributed.tensor import Shard
        nll = run_local(ctc.ctc_loss, args,
                        tuple(Shard(0) if isinstance(p, Shard) else p
                              for p in log_probs.placements))
    else:
        nll = ctc.ctc_loss(*args)
    return nll.mean()


def init_state(cfg: ArchConfig, batch: int, device='cuda'):
    """Streaming state: zero (h, c) per layer, each (batch, N_h)."""
    n_h = cfg.lstm_hidden
    return tuple((torch.zeros((batch, n_h), dtype=cfg.dtype(), device=device),
                  torch.zeros((batch, n_h), dtype=cfg.dtype(), device=device))
                 for _ in range(cfg.n_layers))


def stream_forward(cfg: ArchConfig, params: LSTMStackParams, states, frames,
                   valid_len=None, stack_weights=None, placement=None):
    """A chunk of streaming frames through the network — the model half of
    the serving engine.  frames: (B, T, n_in); states: per-layer ``(h, c)``;
    ``valid_len``: optional (B,) per-stream valid frame counts (steps
    ``t >= valid_len[b]`` are identity on every layer's state);
    ``stack_weights``: the fused kernel's weights, and ``placement``: a
    systolic backend's placed stack with its mesh, each built once by the
    caller (``core.lstm.lstm_stack_chunk``).  Returns
    (log-probs (B, T, n_out), new states).  Feeding chunks back to back is
    bit-equal to one whole-sequence call on the same backend, and the
    composition from zero state is allclose to ``forward``."""
    xs = frames.transpose(0, 1).contiguous()            # (T, B, n_in)
    ys, new_states = lstm_stack_chunk(params, xs, states,
                                      valid_len=valid_len,
                                      backend=cfg.lstm_backend,
                                      stack_weights=stack_weights,
                                      placement=placement)
    return torch.log_softmax(ys, dim=-1).transpose(0, 1), new_states
