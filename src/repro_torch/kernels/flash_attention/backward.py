"""K8's backward on the card (``csrc/flash_attention_bwd.cu``) and the
autograd Function that trains through K8.

``flash_attention_bwd_kv`` (dk, dv) and ``flash_attention_bwd_q`` (dq)
each launch one kernel on CUDA tensors (a plain launch on PyTorch's
current stream, counted in its ``launches``) and run their plain version
(``ref.attention_bwd_ref``) on CPU tensors; there is no fallback between
the two.  Every launch parameter comes from the rule
``kernel.attention_bwd_geometry``: the tiles, the order of the grid and
whether ``kv_kernel`` splits the GQA group across CTAs (then the wrapper
allocates the f32 partials, (B, H, Sk, D) for dk and for dv, and takes
the stream's zeroed tickets, ``kernel._tickets``, shared with K8's split
decode).  ``flash_attention_bwd`` is the whole backward: delta =
rowsum(do * o) as one PyTorch expression (``ref.attention_delta``), then
both kernels.  No atomic touches a gradient: the same inputs give the
same bits.

``attention_train`` is attention under autograd, the counterpart of the
reference's ``chunked_attention`` custom VJP: the forward keeps (q, k, v,
o, lse) with lse from K8 (``flash_attention(..., return_lse=True)``), and
the backward recomputes p from the lse.  ``plain=True`` takes the plain
forward and backward on any device.  Nothing catches a build or launch
failure.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from ..lstm_seq.kernel import check_inputs
from .kernel import (BWD_TILES_MAX, D_MAX, POS_MAX, _tickets,
                     attention_bwd_geometry, flash_attention)
from .ref import attention_bwd_ref, attention_delta, attention_ref

_P, _I = _build.P, _build.I
_ARGS = [_I] + [_P] * 6
_TAIL = [_I] * 6 + [ctypes.c_float] + [_I] * 6
_SIGNATURES = {'flash_attention_bwd_kv_launch':
               _ARGS + [_P] * 5 + _TAIL + [_I] * 6 + [_P],
               'flash_attention_bwd_q_launch':
               _ARGS + [_P] + _TAIL + [_I] * 5 + [_P]}
_DTYPES = (torch.float32, torch.bfloat16)


def _launch(fn: str, q, k, v, do, lse, delta, outs, causal: bool,
            window: Optional[int], scale: float, offset: int,
            split: Optional[bool] = None) -> None:
    """Check the inputs and launch ``fn`` writing ``outs``, with the
    geometry of ``attention_bwd_geometry`` (``split`` forces its group
    split on or off)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f'{fn}: dtype {q.dtype}, expected one of {_DTYPES}')
    if hkv < 1 or h % hkv:
        raise ValueError(f'{fn}: H={h} is not a multiple of Hkv={hkv}')
    f32 = torch.float32
    check_inputs(dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta),
                 dict(q=(b, h, sq, d), k=(b, hkv, sk, d), v=(b, hkv, sk, d),
                      do=(b, h, sq, d), lse=(b, h, sq), delta=(b, h, sq)),
                 dev, dict(q=q.dtype, k=q.dtype, v=q.dtype, do=q.dtype,
                           lse=f32, delta=f32))
    if d > D_MAX or b * h > 65535 or max(sq, sk, abs(offset)) >= POS_MAX:
        raise ValueError(f'{fn}: D={d} must be at most {D_MAX}, B*H={b * h} '
                         f'at most 65535, and Sq={sq}, Sk={sk}, '
                         f'|offset|={abs(offset)} below {POS_MAX}')
    if outs[0].numel() == 0:
        return
    geom = attention_bwd_geometry(
        b, h, hkv, sq, sk, d, q.dtype, window, offset,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        causal=causal, split=split)
    kv = fn.endswith('kv')
    tiles = geom.kv_tiles if kv else geom.q_tiles
    if tiles > BWD_TILES_MAX:
        raise ValueError(f'{fn}: {tiles} tiles of {geom.q_rows} rows, at '
                         f'most {BWD_TILES_MAX}')
    # a window beyond +-2 POS_MAX passes or masks every pair alike
    win = 0 if window is None else max(-2 * POS_MAX, min(2 * POS_MAX, window))
    vec = (d % (16 // q.element_size()) == 0
           and all(t.data_ptr() % 16 == 0 for t in (q, k, v, do, *outs)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    extra, shape = [], ()
    if kv:
        parts = [None] * 3             # dk, dv partials and tickets
        if geom.kv_split > 1:
            parts = [torch.empty((b, h, sk, d), dtype=torch.float32,
                                 device=dev) for _ in range(2)]
            parts.append(_tickets(dev, stream, b * hkv * tiles))
        extra = [0 if t is None else t.data_ptr() for t in parts]
        shape = (geom.kv_rows, tiles, geom.kv_split, int(geom.kv_reverse))
    else:
        shape = (geom.q_keys, tiles, int(geom.q_reverse))
    lib = _build.load('flash_attention_bwd', _SIGNATURES)
    err = getattr(lib, f'{fn}_launch')(
        dev.index, *(t.data_ptr() for t in (q, k, v, do, lse, delta)),
        *(t.data_ptr() for t in outs), *extra, b, h, hkv, sq, sk, d,
        float(scale), int(causal), int(window is not None), win, offset,
        int(q.dtype == torch.bfloat16), int(vec), geom.d_tile, geom.warps,
        *shape, stream)
    _build.check(lib, err, f'{fn} launch')


def _defaults(q, k, causal, sm_scale, offset):
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    return scale, offset


@torch.library.custom_op('repro_torch::flash_attention_bwd_kv',
                         mutates_args=())
def flash_attention_bwd_kv_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 lse: torch.Tensor, delta: torch.Tensor,
                                 causal: bool, window: Optional[int],
                                 sm_scale: float, offset: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_bwd_kv`` on CPU tensors, the op
    ``repro_torch::flash_attention_bwd_kv``: the plain version, and under
    fake tensors outputs of its shapes (a cost model charges the op by its
    launch geometry, ``kernel.attention_bwd_cost``)."""
    return attention_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                             window=window, sm_scale=sm_scale,
                             offset=offset)[1:]


@flash_attention_bwd_kv_plain.register_fake
def _(q, k, v, do, lse, delta, causal, window, sm_scale, offset):
    return k.new_empty(k.shape), v.new_empty(v.shape)


@torch.library.custom_op('repro_torch::flash_attention_bwd_q',
                         mutates_args=())
def flash_attention_bwd_q_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, do: torch.Tensor,
                                lse: torch.Tensor, delta: torch.Tensor,
                                causal: bool, window: Optional[int],
                                sm_scale: float, offset: int
                                ) -> torch.Tensor:
    """``flash_attention_bwd_q`` on CPU tensors, the op
    ``repro_torch::flash_attention_bwd_q`` (as
    ``flash_attention_bwd_kv_plain``)."""
    return attention_bwd_ref(q, k, v, do, lse, delta, causal=causal,
                             window=window, sm_scale=sm_scale,
                             offset=offset)[0]


@flash_attention_bwd_q_plain.register_fake
def _(q, k, v, do, lse, delta, causal, window, sm_scale, offset):
    return q.new_empty(q.shape)


def flash_attention_bwd_kv(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: Optional[int] = None,
                           sm_scale: Optional[float] = None,
                           offset: Optional[int] = None,
                           split: Optional[bool] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, Hkv, Sk, D) in k's dtype, from q, do (B, H, Sq,
    D), k, v (B, Hkv, Sk, D), the forward's lse and delta (B, H, Sq) f32;
    arguments as ``flash_attention``'s.  ``split``: force the rule's GQA
    group split on or off (None: the rule decides).  Counted in
    ``.launches``."""
    scale, offset = _defaults(q, k, causal, sm_scale, offset)
    if q.device.type == 'cpu':
        return flash_attention_bwd_kv_plain(q, k, v, do, lse, delta, causal,
                                            window, scale, offset)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('flash_attention_bwd_kv', q, k, v, do, lse, delta, (dk, dv),
            causal, window, scale, offset, split)
    flash_attention_bwd_kv.launches += 1
    return dk, dv


def flash_attention_bwd_q(q, k, v, do, lse, delta, *, causal: bool = True,
                          window: Optional[int] = None,
                          sm_scale: Optional[float] = None,
                          offset: Optional[int] = None) -> torch.Tensor:
    """dq (B, H, Sq, D) in q's dtype; the same inputs as
    ``flash_attention_bwd_kv``.  Counted in ``.launches``."""
    scale, offset = _defaults(q, k, causal, sm_scale, offset)
    if q.device.type == 'cpu':
        return flash_attention_bwd_q_plain(q, k, v, do, lse, delta, causal,
                                           window, scale, offset)
    dq = torch.empty_like(q)
    _launch('flash_attention_bwd_q', q, k, v, do, lse, delta, (dq,),
            causal, window, scale, offset)
    flash_attention_bwd_q.launches += 1
    return dq


flash_attention_bwd_kv.launches = 0
flash_attention_bwd_q.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None,
                        offset: Optional[int] = None):
    """(dq, dk, dv) of K8 at cotangent ``do``, from its output ``o`` and
    ``lse``: both kernels (on CPU tensors both plain versions)."""
    kw = dict(causal=causal, window=window, sm_scale=sm_scale, offset=offset)
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_kv(q, k, v, do, lse, delta, **kw)
    return flash_attention_bwd_q(q, k, v, do, lse, delta, **kw), dk, dv


class _Attention(torch.autograd.Function):
    """Attention with the FlashAttention-2 backward; see
    ``attention_train``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, offset, plain):
        kw = dict(causal=causal, window=window, offset=offset)
        fwd = attention_ref if plain else flash_attention
        o, lse = fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.plain = kw, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if ctx.plain:
            grads = attention_bwd_ref(q, k, v, do, lse,
                                      attention_delta(o, do), **ctx.kw)
        else:
            grads = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return (*grads, None, None, None, None)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    offset: Optional[int] = None,
                    plain: bool = False) -> torch.Tensor:
    """``flash_attention`` (scale D ** -0.5, no ``kv_len``) as a
    differentiable op: K8 with its log-sum-exp forward and K8's backward
    kernels on CUDA tensors, their plain versions on CPU tensors, and the
    plain versions on any device when ``plain``."""
    return _Attention.apply(q, k, v, causal, window, offset, plain)
