"""Model registry of the port: one uniform bundle per architecture family.

Counterpart of ``repro.models.registry``.  ``get_bundle(cfg)`` returns the
LM of ``models.transformer`` for the families ``'dense'``, ``'moe'``,
``'audio'`` (whisper's encoder-decoder) and ``'vlm'`` (Llama-3.2-Vision's
cross layers).  The cross families take a source in ``forward``'s and
``loss_fn``'s batch (``batch['source']``, (B, F, d)) and decode through
``transformer.precompute_cross_kv`` + ``decode_step(..., cross_kv=)``
(the bundle's ``decode_step`` passes ``cross_kv`` on by keyword), as the
reference's own test and dry run do.  The paper's CTC LSTM has no
bundle: the stream server and the trainer call ``models.chipmunk_net``
directly.  The recurrent families (``'ssm'``: xLSTM; ``'hybrid'``: Hymba)
take the bundles of ``models.recurrent``: xLSTM's ``init_cache`` is its
recurrent state (``init_xlstm_state``) and its ``decode_step`` the forward
over one token from that state (``pos`` unused); Hymba's is its per-layer
cache list and ``hymba_decode_step``.  A bundle's ``init`` takes ``(generator,
device)`` and returns the parameters alone (the reference's logical
sharding axes have no meaning on one card); ``init_cache`` takes
``(batch, max_seq, device)``.  The reference's ``input_specs`` /
``batch_axes`` come with the sharding slice (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

from ..configs import ArchConfig
from ..tree import leaves
from . import recurrent, transformer
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
        moe_p = params.get('blocks', {}).get('moe', {})
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
    )


_BUNDLES = {'dense': _lm_bundle, 'moe': _lm_bundle, 'audio': _lm_bundle,
            'vlm': _lm_bundle, 'ssm': _xlstm_bundle, 'hybrid': _hymba_bundle}


def get_bundle(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == 'lstm':
        raise ValueError(f'{cfg.name}: the CTC LSTM has no bundle; '
                         f'models.chipmunk_net runs it')
    return _BUNDLES[cfg.family](cfg)

