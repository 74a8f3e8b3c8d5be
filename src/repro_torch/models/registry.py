"""Model registry of the port: one uniform bundle per architecture family.

Counterpart of ``repro.models.registry``.  ``get_bundle(cfg)`` returns the
LM of ``models.transformer`` for the families ``'dense'``, ``'moe'``,
``'audio'`` (whisper's encoder-decoder) and ``'vlm'`` (Llama-3.2-Vision's
cross layers).  The cross families take a source in ``forward``'s and
``loss_fn``'s batch (``batch['source']``, (B, F, d)) and decode through
``transformer.precompute_cross_kv`` + ``decode_step(..., cross_kv=)``
(the bundle's ``decode_step`` passes ``cross_kv`` on by keyword), as the
reference's own test and dry run do.  The paper's CTC LSTM (``'lstm'``)
takes ``models.chipmunk_net``'s: ``init_cache`` its per-layer (h, c) and
``decode_step`` the streaming forward over the frames given.  The
recurrent families (``'ssm'``: xLSTM; ``'hybrid'``: Hymba) take the
bundles of ``models.recurrent``: xLSTM's ``init_cache`` is its recurrent
state (``init_xlstm_state``) and its ``decode_step`` the forward over one
token from that state (``pos`` unused); Hymba's is its per-layer cache
list and ``hymba_decode_step``.  A bundle's ``init`` takes ``(generator,
device)`` and returns the parameters alone; ``param_axes(cfg)`` gives
their logical sharding axes, leaf for leaf (the reference's ``init``
returns them beside the parameters), and ``cache_axes(cfg)`` those of
``init_cache``'s tensors in the port's layout; ``init_cache`` takes
``(batch, max_seq, device)``.  ``input_specs`` / ``batch_axes`` describe
a step's inputs for a ``configs.ShapeConfig`` without making them
(``TensorSpec``: shape and dtype, no storage).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch

from ..configs import ArchConfig, ShapeConfig
from ..tree import leaves
from . import chipmunk_net, recurrent, transformer
from .layers import softmax_xent


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable                      # (generator, device) -> params
    loss_fn: Callable                   # (params, batch) -> scalar
    forward: Callable                   # (params, batch) -> logits
    init_cache: Optional[Callable]      # (batch, max_seq, device) -> cache
    # (params, cache, tokens, pos, cross_kv=None) -> (logits, cache)
    decode_step: Optional[Callable]
    param_axes: Callable                # cfg -> axes tree of init's
    cache_axes: Callable                # cfg -> axes tree of the cache

    def param_count(self, params) -> int:
        return sum(int(p.numel()) for p in leaves(params))

    def active_param_count(self, params) -> int:
        """Parameters a token runs through: an MoE config's expert weights
        count at top_k / E (the reference's count, for MODEL_FLOPS =
        6 N_active D); every other config's, all of them."""
        total = self.param_count(params)
        if self.cfg.moe is None:
            return total
        m = self.cfg.moe
        moe_p = (params.get('blocks', {}).get('moe', {})
                 if isinstance(params, dict) else {})
        expert = sum(int(p.numel()) for k, p in moe_p.items()
                     if k != 'router')
        return total - expert + int(expert * m.top_k / m.n_experts)


# -------------------------------------------------------------------- bundles
def _lm_bundle(cfg: ArchConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init=functools.partial(transformer.init_lm, cfg),
        loss_fn=functools.partial(transformer.loss_fn, cfg),
        forward=lambda p, batch: transformer.forward_lm(
            cfg, p, batch['tokens'], source=batch.get('source'))[0],
        init_cache=functools.partial(transformer.init_cache, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        param_axes=transformer.lm_axes, cache_axes=transformer.cache_axes,
    )


def _xlstm_bundle(cfg: ArchConfig) -> ModelBundle:
    def decode(p, states, tokens, pos):
        return recurrent.forward_xlstm(cfg, p, tokens, states=states)

    return ModelBundle(
        cfg=cfg,
        init=functools.partial(recurrent.init_xlstm, cfg),
        loss_fn=lambda p, batch: softmax_xent(
            recurrent.forward_xlstm(cfg, p, batch['tokens'])[0],
            batch['labels']),
        forward=lambda p, batch: recurrent.forward_xlstm(
            cfg, p, batch['tokens'])[0],
        init_cache=lambda b, s, device='cuda': recurrent.init_xlstm_state(
            cfg, b, device),
        decode_step=decode,
        param_axes=recurrent.xlstm_axes,
        cache_axes=recurrent.xlstm_state_axes,
    )


def _hymba_bundle(cfg: ArchConfig) -> ModelBundle:
    return ModelBundle(
        cfg=cfg,
        init=functools.partial(recurrent.init_hymba, cfg),
        loss_fn=lambda p, batch: softmax_xent(
            recurrent.forward_hymba(cfg, p, batch['tokens']),
            batch['labels']),
        forward=lambda p, batch: recurrent.forward_hymba(
            cfg, p, batch['tokens']),
        init_cache=functools.partial(recurrent.init_hymba_cache, cfg),
        decode_step=functools.partial(recurrent.hymba_decode_step, cfg),
        param_axes=recurrent.hymba_axes,
        cache_axes=recurrent.hymba_cache_axes,
    )


def _chipmunk_bundle(cfg: ArchConfig) -> ModelBundle:
    def decode(p, states, frames, pos):
        # one chunk of the streaming forward (one frame: Table 2's case)
        return chipmunk_net.stream_forward(cfg, p, states, frames)

    return ModelBundle(
        cfg=cfg,
        init=lambda gen=None, device='cuda': chipmunk_net.init(cfg, gen,
                                                               device),
        loss_fn=functools.partial(chipmunk_net.loss_fn, cfg),
        forward=lambda p, batch: chipmunk_net.forward(cfg, p,
                                                      batch['frames']),
        init_cache=lambda b, s, device='cuda': chipmunk_net.init_state(
            cfg, b, device),
        decode_step=decode,
        param_axes=chipmunk_net.axes,
        cache_axes=chipmunk_net.state_axes,
    )


_BUNDLES = {'dense': _lm_bundle, 'moe': _lm_bundle, 'audio': _lm_bundle,
            'vlm': _lm_bundle, 'ssm': _xlstm_bundle, 'hybrid': _hymba_bundle,
            'lstm': _chipmunk_bundle}


def get_bundle(cfg: ArchConfig) -> ModelBundle:
    return _BUNDLES[cfg.family](cfg)


# --------------------------------------------------------------- input specs
class TensorSpec:
    """A tensor's shape and dtype with no storage (the port's stand-in
    for ``jax.ShapeDtypeStruct``); a leaf of the port's trees."""

    def __init__(self, shape, dtype: torch.dtype):
        self.shape, self.dtype = tuple(shape), dtype

    def __eq__(self, other) -> bool:
        return (isinstance(other, TensorSpec) and self.shape == other.shape
                and self.dtype == other.dtype)

    def __repr__(self) -> str:
        return f'TensorSpec({self.shape}, {self.dtype})'


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``TensorSpec`` stand-ins for every model input of this (arch,
    shape), the reference's.  Train/prefill: the token batch (and the stub
    frontend's embeddings for audio/vlm; the CTC LSTM's MFCC frames with
    labels of seq_len / 8 and the lengths).  Decode: one new token (frame)
    and ``pos``; the cache comes from ``init_cache``."""
    b = shape.global_batch
    spec, i32, f32 = TensorSpec, torch.int32, torch.float32
    if shape.kind in ('train', 'prefill'):
        s = shape.seq_len
        if cfg.family == 'lstm':
            batch = {'frames': spec((b, s, cfg.lstm_inputs), f32)}
            if shape.kind == 'train':
                batch.update(labels=spec((b, s // 8), i32),
                             frame_len=spec((b,), i32),
                             label_len=spec((b,), i32))
            return batch
        batch = {'tokens': spec((b, s), i32)}
        if shape.kind == 'train':
            batch['labels'] = spec((b, s), i32)
        if cfg.family in ('audio', 'vlm'):
            batch['source'] = spec((b, cfg.n_source_tokens, cfg.d_model), f32)
        return batch
    if cfg.family == 'lstm':
        return {'frames': spec((b, 1, cfg.lstm_inputs), f32),
                'pos': spec((), i32)}
    return {'tokens': spec((b, 1), i32), 'pos': spec((), i32)}


def batch_axes(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Logical sharding axes matching ``input_specs``."""
    if cfg.family == 'lstm':
        if shape.kind == 'train':
            return {'frames': ('batch', 'seq', None),
                    'labels': ('batch', None),
                    'frame_len': ('batch',), 'label_len': ('batch',)}
        return {'frames': ('batch', None, None), 'pos': ()}
    if shape.kind == 'decode':
        return {'tokens': ('batch', None), 'pos': ()}
    ax: Dict[str, Any] = {'tokens': ('batch', 'seq')}
    if shape.kind == 'train':
        ax['labels'] = ('batch', 'seq')
    if cfg.family in ('audio', 'vlm'):
        ax['source'] = ('batch', 'frames', 'embed')
    return ax

