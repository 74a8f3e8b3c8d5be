"""Model registry of the port: one uniform bundle per architecture family.

Counterpart of ``repro.models.registry``.  ``get_bundle(cfg)`` returns the
decoder-only LM (``family`` ``'dense'`` or ``'moe'``).  The paper's CTC LSTM has no
bundle: the stream server and the trainer call ``models.chipmunk_net``
directly.  Every other family raises ``NotImplementedError`` naming the
ROADMAP item that ports it.  A bundle's ``init`` takes ``(generator,
device)`` and returns the parameters alone (the reference's logical
sharding axes have no meaning on one card); ``init_cache`` takes
``(batch, max_seq, device)``.  The reference's ``input_specs`` /
``batch_axes`` come with the sharding slice (ROADMAP queue 1, item 3(d)).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

from ..configs import ArchConfig
from ..tree import leaves
from . import transformer

# family -> the ROADMAP queue 1 item that ports it
_NOT_PORTED = {
    'audio': 'item 3, the cross-attention families (whisper-base)',
    'vlm': 'item 3, the cross-attention families (llama-3.2-vision)',
    'ssm': 'item 3, recurrent.py (xLSTM)',
    'hybrid': 'item 3, recurrent.py (Hymba)',
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable                      # (generator, device) -> params
    loss_fn: Callable                   # (params, batch) -> scalar
    forward: Callable                   # (params, batch) -> logits
    init_cache: Optional[Callable]      # (batch, max_seq, device) -> cache
    decode_step: Optional[Callable]     # (params, cache, tokens, pos) -> (logits, cache)

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


def get_bundle(cfg: ArchConfig) -> ModelBundle:
    if cfg.family in ('dense', 'moe'):
        return _lm_bundle(cfg)
    if cfg.family == 'lstm':
        raise ValueError(f'{cfg.name}: the CTC LSTM has no bundle; '
                         f'models.chipmunk_net runs it')
    raise NotImplementedError(
        f'{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP '
        f'queue 1, {_NOT_PORTED.get(cfg.family, "item 3")})')

