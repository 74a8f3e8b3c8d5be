"""Carry weights from the JAX reference into the port.

``stack_params_from_numpy`` takes the reference's ``LSTMStackParams`` after
``jax.tree.map(np.asarray, params)`` (or any object or mapping with the
same field names) and returns the port's ``LSTMStackParams`` on ``device``.
Layouts are kept as they are: ``w_x`` (4, N_h, N_x), ``w_h`` (4, N_h, N_h),
``w_peep`` (3, N_h), ``b`` (4, N_h), ``w_out`` (N_out, N_h), ``b_out``
(N_out,).  ``quantized_packed_from_numpy`` does the same for one quantized
layer (``QuantizedPackedLSTM``), keeping its integer dtypes.
``train_state_from_numpy`` carries a whole train state — the reference's
``{'params', 'opt', 'step'}`` with AdamW's moments — into the port's.
``lm_params_from_numpy`` carries the dense LM's nested dict of parameters
leaf for leaf in each leaf's own dtype (bf16 included), and
``lm_cache_from_numpy`` its KV cache (a ring filled in order) and
``lm_cross_kv_from_numpy`` its precomputed cross K/V into the port's
layouts, and
``lm_train_state_from_numpy`` a whole LM train state with any of the three
optimizers' states.  ``lm_params_from_numpy`` also carries the recurrent
families' parameters (xLSTM's and Hymba's dicts);
``xlstm_state_from_numpy`` carries xLSTM's recurrent state and
``hymba_cache_from_numpy`` Hymba's per-layer caches (its rings rolled from
the reference's meta-offset slots into the port's).  Nothing here imports
JAX; the values are copied bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.lstm import LSTMParams, LSTMStackParams
from .core.systolic import QuantizedPackedLSTM
from .models.recurrent import N_META
from .optim import AdafactorState, AdamWState, SGDState


def _field(obj, name):
    """``obj.name`` or ``obj[name]``."""
    if isinstance(obj, dict):
        return obj[name]
    return getattr(obj, name)


def _tensor(a, device):
    return None if a is None else torch.from_numpy(
        np.array(a, np.float32, order='C', copy=True)).to(device)


def stack_params_from_numpy(tree, device='cuda') -> LSTMStackParams:
    """The port's stack parameters from a numpy copy of the reference's
    (by attribute or key; layers in order), on ``device``."""
    layers = tuple(
        LSTMParams(*(_tensor(_field(l, n), device)
                     for n in ('w_x', 'w_h', 'w_peep', 'b')))
        for l in _field(tree, 'layers'))
    return LSTMStackParams(layers, _tensor(_field(tree, 'w_out'), device),
                           _tensor(_field(tree, 'b_out'), device))


# field -> dtype of a quantized layer's codes
_QUANTIZED_FIELDS = (('tiles_q', np.int8), ('peep_q', np.int8),
                     ('bias_q', np.int16), ('sig_lut', np.int8),
                     ('tanh_lut', np.int8))


def quantized_packed_from_numpy(qp, device='cuda') -> QuantizedPackedLSTM:
    """The port's ``QuantizedPackedLSTM`` from a numpy copy of the
    reference's (by attribute or key): ``tiles_q`` int8 (R, C, 4, t, t),
    ``peep_q`` int8 (R, 3, t), ``bias_q`` int16 (R, 4, t), the two int8 LUTs
    (256,) and ``plan_shape``, on ``device``.  Raises ``ValueError`` if a
    field does not have its integer dtype (no silent conversion)."""
    arrays = []
    for name, dtype in _QUANTIZED_FIELDS:
        a = np.asarray(_field(qp, name))
        if a.dtype != dtype:
            raise ValueError(f'{name}: dtype {a.dtype}, expected '
                             f'{np.dtype(dtype)}')
        arrays.append(torch.from_numpy(np.array(a, order='C', copy=True)
                                       ).to(device))
    plan_shape = tuple(int(v) for v in _field(qp, 'plan_shape'))
    return QuantizedPackedLSTM(*arrays, plan_shape=plan_shape)


def _step(a) -> torch.Tensor:
    return torch.tensor(int(np.asarray(a)), dtype=torch.int32)


def train_state_from_numpy(state, device='cuda'):
    """The port's train state ``{'params', 'opt', 'step'}`` from a numpy
    copy of the reference's (``jax.tree.map(np.asarray, state)`` with an
    ``AdamWState(step, m, v)`` optimizer state): parameters and both
    moments on ``device``, the two step counters as 0-d int32 tensors on
    the CPU (where the port keeps its scalars)."""
    opt = _field(state, 'opt')
    return {'params': stack_params_from_numpy(_field(state, 'params'),
                                              device),
            'opt': AdamWState(_step(_field(opt, 'step')),
                              stack_params_from_numpy(_field(opt, 'm'),
                                                      device),
                              stack_params_from_numpy(_field(opt, 'v'),
                                                      device)),
            'step': _step(_field(state, 'step'))}


def _exact(a, device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype on ``device``.  A bf16
    array (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    goes across as its 16-bit pattern, so no value is widened or
    rounded."""
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        bits = np.array(a, order='C', copy=True).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order='C', copy=True)).to(device)


def lm_params_from_numpy(tree, device='cuda'):
    """The port's LM parameters from ``jax.tree.map(np.asarray, params)``
    of the reference's (``transformer.init_lm``): the same nested dict
    (``embed``, ``blocks`` stacked over layers, ``final_norm``; a VLM's
    ``blocks`` over (groups, per - 1) and its ``cross``; an
    encoder-decoder's ``enc_blocks``, ``enc_cross`` and ``enc_norm``),
    every leaf bit for bit in its own dtype, on ``device``."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    return _exact(tree, device)


def ring_fill(w: int, n: int) -> np.ndarray:
    """The reference's ``pos`` row (slot -> position, -1 empty) of a ring
    of ``w`` slots after positions 0 .. n - 1 were written in order: slot
    s holds the latest t < n with t % w == s."""
    s = np.arange(w)
    return np.where(s < n, s + (n - 1 - s) // w * w, -1).astype(np.int32)


def lm_cache_from_numpy(cache, device='cuda'):
    """The port's KV cache from a numpy copy of the reference's: ``k``/``v``
    (layers, B, W, Hkv, hd) -> (layers, B, Hkv, W, hd)
    (``transformer.init_cache``'s layout).  The reference's ``pos`` array
    is checked and dropped: the port's cache implies the in-order fill
    (``ring_fill``; ``layers.attention_decode``), so any other ``pos``
    raises ``ValueError``."""
    pos = np.asarray(cache['pos'])
    want = ring_fill(pos.shape[-1], int(pos.max()) + 1)
    if not (pos == want).all():
        raise ValueError(f'lm_cache_from_numpy: pos {pos.tolist()} is not '
                         f'a ring filled in order')
    return {n: _exact(np.swapaxes(np.asarray(cache[n]), 2, 3), device)
            for n in ('k', 'v')}


def xlstm_state_from_numpy(states, device='cuda'):
    """The port's xLSTM state (``recurrent.init_xlstm_state``'s tree) from
    a numpy copy of the reference's: the same nested tuples ((conv, (C,
    n, m)), (c, n, m, h)), every leaf bit for bit in its own dtype."""
    if isinstance(states, (tuple, list)):
        return tuple(xlstm_state_from_numpy(a, device) for a in states)
    return _exact(states, device)


def hymba_cache_from_numpy(cache, cfg, max_seq: int, device='cuda'):
    """The port's Hymba caches (``recurrent.init_hymba_cache(cfg, B,
    max_seq)``) from a numpy copy of the reference's list of
    ``{'k', 'v' (B, W', Hkv, hd), 'pos' (W',), 'conv', 'ssm'}``, one a
    layer.  The reference writes token t to slot (t + 128) % W' and never
    fills the meta slots; its ``pos`` row must be that fill of tokens 0 ..
    n - 1 in order (else ``ValueError``), and token t moves to the port's
    slot t % W, W = min(the layer's window or max_seq, max_seq)
    (``ring_fill``: the last W tokens, all that the port's ring holds and
    all that the reference's mask lets through).  ``conv`` and ``ssm`` are
    copied as they are."""
    out = []
    for layer, c in enumerate(cache):
        pos = np.asarray(c['pos'])
        w_ref = pos.shape[-1]
        n = max(int(pos.max()) - N_META + 1, 0)
        filled = ring_fill(w_ref, N_META + n)
        if not (pos == np.where(filled >= N_META, filled, -1)).all():
            raise ValueError(f'hymba_cache_from_numpy: layer {layer} pos '
                             f'{pos.tolist()} is not the meta-offset ring '
                             f'filled in order')
        window = (None if layer in cfg.global_layer_ids
                  else cfg.sliding_window)
        tok = ring_fill(min(window or max_seq, max_seq), n)
        src = (np.maximum(tok, 0) + N_META) % w_ref
        out.append({n_: _exact(c[n_], device) for n_ in ('conv', 'ssm')})
        for name in ('k', 'v'):
            rows = np.asarray(c[name])[:, src].copy()
            rows[:, tok < 0] = 0
            out[-1][name] = _exact(np.swapaxes(rows, 1, 2), device)
    return out


def lm_cross_kv_from_numpy(cross_kv, device='cuda'):
    """The port's cross K/V (``transformer.precompute_cross_kv``) from a
    numpy copy of the reference's: the tuple ``(k, v)``, each (cross
    layers, B, F, Hkv, hd) -> ``{'k', 'v'}``, each (cross layers, B, Hkv,
    F, hd), bit for bit."""
    k, v = cross_kv
    return {n: _exact(np.swapaxes(np.asarray(a), 2, 3), device)
            for n, a in (('k', k), ('v', v))}


# the reference's optimizer states by their moment fields, and the port's
_OPT_STATES = ((('m', 'v'), AdamWState), (('vr', 'vc'), AdafactorState),
               (('mom',), SGDState))


def lm_train_state_from_numpy(state, device='cuda'):
    """The port's LM train state ``{'params', 'opt', 'step'}`` from
    ``jax.tree.map(np.asarray, state)`` of the reference's: parameters
    and the optimizer's moments (``AdamWState``, ``AdafactorState`` or
    ``SGDState``, told apart by their fields) every leaf bit for bit in
    its own dtype on ``device``, the step counters as 0-d int32 tensors on
    the CPU."""
    opt = _field(state, 'opt')
    for names, cls in _OPT_STATES:
        if all(hasattr(opt, n) or (isinstance(opt, dict) and n in opt)
               for n in names):
            moments = [lm_params_from_numpy(_field(opt, n), device)
                       for n in names]
            return {'params': lm_params_from_numpy(_field(state, 'params'),
                                                   device),
                    'opt': cls(_step(_field(opt, 'step')), *moments),
                    'step': _step(_field(state, 'step'))}
    raise ValueError(f'unknown optimizer state {type(opt).__name__}')
