"""The recurrent LM families of the port: xLSTM (mLSTM + sLSTM blocks) and
Hymba (attention beside Mamba heads in every layer).

Counterpart of ``repro.models.recurrent``, function for function, as plain
functions on tensors: parameters are nested dicts with the reference's
names and layouts, stacked over the reference's scan axes (xLSTM's
``mlstm`` over (groups, per - 1), ``slstm`` over groups; Hymba's
``blocks`` over layers), so weights carry across leaf for leaf
(``convert.lm_params_from_numpy``).  The reference's ``lax.scan`` over
layers is a Python loop here.  dtypes follow JAX's promotion as in
``models.layers`` (``_mm``): both configs hold f32 weights under bf16
activations, so each block computes in f32 and rounds its residual back.

- mLSTM: the stabilised chunkwise-parallel form (``mlstm_chunkwise``), a
  Python loop over chunks of ``chunk`` steps with the matrix memory carried
  at chunk boundaries.
- sLSTM: a true nonlinear recurrence, a Python loop over the steps
  (``slstm_scan``) on every ``lstm_backend``, as the reference's docstring
  says of its own hook: no kernel of either package runs it.
- Mamba: the diagonal selective SSM (``mamba_mix``); the reference's
  ``jax.lax.associative_scan`` is a log-depth doubling scan over the
  sequence (``_linear_scan``).
- Hymba: attention on K8 (``layers.attention``) through
  ``layers.attention_block`` (forward) and ``layers.attention_decode``
  (decode), on the port's ring cache; the 128 meta tokens are prepended in
  the forward and offset RoPE's positions in the decode.

No function here reaches a Pallas kernel in the reference, so the only
kernel on these paths is Hymba's K8.  The products are cuBLAS calls.

Hymba's decode is not its forward (ROADMAP R5): the reference's
``hymba_decode_step`` offsets positions by the 128 meta tokens but never
writes them into the attention caches or the Mamba state.  The port
computes what the reference computes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import ArchConfig
from ..op_cost import stack_steps, steps
from ..tree import tree_map
from . import layers as L
from .transformer import _maybe_remat, _stack_init, stacked_axes, unbind

f32 = torch.float32
Params = Dict[str, Any]
N_META = 128                     # Hymba's meta tokens
SLSTM_LABEL = 'recurrent.slstm_scan'   # record_function label of its loop


# =============================================================== mLSTM block
def init_mlstm(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    di = 2 * d                      # projection factor 2 (xLSTM paper)
    h = cfg.n_heads
    dtype, dev = cfg.dtype(), gen.device
    return {
        'ln': torch.ones((d,), dtype=dtype, device=dev),
        'w_up': L.mk_param(gen, (d, 2 * di), dtype),
        'conv_w': L.mk_param(gen, (cfg.conv_kernel, di), dtype,
                             scale=cfg.conv_kernel ** -0.5),
        'wq': L.mk_param(gen, (di, di), dtype),
        'wk': L.mk_param(gen, (di, di), dtype),
        'wv': L.mk_param(gen, (di, di), dtype),
        'w_if': L.mk_param(gen, (di, 2 * h), dtype, scale=0.01),
        'b_if': torch.cat([
            torch.zeros((h,), dtype=dtype, device=dev),
            torch.linspace(3.0, 6.0, h, dtype=f32, device=dev).to(dtype)]),
        'out_norm': torch.ones((di,), dtype=dtype, device=dev),
        'w_down': L.mk_param(gen, (di, d), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C); state: (B, K-1, C)
    or None (zeros).  Returns (out (B, S, C), the new state: the last K-1
    inputs).  The state and x concatenate in their promoted dtype, as
    ``jnp.concatenate`` does."""
    k = w.shape[0]
    pad = (x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None
           else state)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out, (xp[:, -(k - 1):] if k > 1 else None)


def mlstm_chunkwise(q, k, v, log_f, log_i, chunk: int, state=None):
    """Stabilised chunkwise mLSTM.  q, k, v: (B, H, S, dh) (k pre-scaled by
    dh^-0.5); log_f, log_i: (B, H, S).  Returns (y (B, H, S, dh) in v's
    dtype, the final state (C (B, H, dh, dh), n (B, H, dh), m (B, H)), f32).
    Within a chunk an attention-like masked decay matrix; across chunks the
    matrix memory at the boundaries.  The -1e30 / -1e29 sentinels and the
    max(|n|, exp(-m)) denominator are the reference's: they keep the first
    chunk (m = -1e30) free of NaN.  Under autograd every max is
    ``torch.maximum`` or ``amax``, which split the gradient evenly between
    tied operands as ``jnp.maximum`` and ``jnp.max`` do (the floor of
    -1e29 too: ``clamp_min`` would pass all of it at a tie)."""
    b, h, s, dh = q.shape
    nc = s // chunk
    qs, ks, vs = (a.to(f32).reshape(b, h, nc, chunk, dh) for a in (q, k, v))
    lf = log_f.to(f32).reshape(b, h, nc, chunk)
    li = log_i.to(f32).reshape(b, h, nc, chunk)
    csum_f = torch.cumsum(lf, dim=-1)                  # within a chunk
    total_f = csum_f[..., -1]                          # (B, H, nc)
    src = li + (total_f[..., None] - csum_f)           # i_t * f_{t+1..T}
    if state is None:
        c = q.new_zeros((b, h, dh, dh), dtype=f32)
        n = q.new_zeros((b, h, dh), dtype=f32)
        m = q.new_full((b, h), -1e30, dtype=f32)
    else:
        c, n, m = state
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    floor = q.new_tensor(-1e29, dtype=f32)
    ys = []
    for j in steps(range(nc), q):
        qc, kc, vc = qs[:, :, j], ks[:, :, j], vs[:, :, j]
        li_c, csum_c, tot_c = li[:, :, j], csum_f[:, :, j], total_f[:, :, j]
        # intra-chunk log weights D_ts = csum_t - csum_s + li_s (s <= t)
        dmat = csum_c[..., :, None] - csum_c[..., None, :] + li_c[..., None, :]
        dmat = torch.where(tri, dmat, torch.full_like(dmat, -1e30))
        # stabiliser per row: max(intra max, inter bound m_prev + csum_t)
        inter_bound = m[..., None] + csum_c
        m_row = torch.maximum(torch.maximum(dmat.amax(dim=-1), inter_bound),
                              floor)
        dmat = torch.exp(dmat - m_row[..., None])
        inter_w = torch.exp(inter_bound - m_row)
        w_qk = (qc @ kc.transpose(-1, -2)) * dmat
        y = w_qk @ vc + (qc @ c) * inter_w[..., None]
        n_all = w_qk.sum(dim=-1) + (qc @ n[..., None])[..., 0] * inter_w
        denom = torch.maximum(n_all.abs(), torch.exp(-m_row))
        ys.append(y / denom[..., None])
        # boundary update (new running max at chunk end)
        m_new = torch.maximum(m + tot_c, (li_c + (tot_c[..., None] - csum_c))
                              .amax(dim=-1))
        w_src = torch.exp(src[:, :, j] - m_new[..., None])     # (B, H, T)
        decay = torch.exp(m + tot_c - m_new)
        kw = kc * w_src[..., None]
        c = c * decay[..., None, None] + kw.transpose(-1, -2) @ vc
        n = n * decay[..., None] + kw.sum(dim=-2)
        m = m_new
    y = stack_steps(ys, nc, dim=2).reshape(b, h, s, dh)
    return y.to(v.dtype), (c, n, m)


def mlstm_block(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                chunk: int = 256, state=None):
    """x (B, S, D) -> (B, S, D), carrying (conv state, (C, n, m)).  The
    chunk is ``min(chunk, S)``, or S where that does not divide S, as in
    the reference."""
    b, s, d = x.shape
    h = cfg.n_heads
    di = 2 * d
    dh = di // h
    res = x
    xn = L.rms_norm(x, p['ln'])
    m_in, z = L._mm(xn, p['w_up']).chunk(2, dim=-1)
    cx, conv_state = _causal_conv(m_in, p['conv_w'],
                                  None if state is None else state[0])
    cx = F.silu(cx)
    heads = lambda a: a.reshape(b, s, h, dh).transpose(1, 2)
    q = heads(L._mm(cx, p['wq']))
    k = heads(L._mm(cx, p['wk'])) * dh ** -0.5
    v = heads(L._mm(m_in, p['wv']))
    gates = L._mm(m_in, p['w_if']) + p['b_if']          # (B, S, 2H)
    log_i = gates[..., :h].to(f32).transpose(1, 2)
    log_f = F.logsigmoid(gates[..., h:].to(f32)).transpose(1, 2)
    chunk_eff = min(chunk, s)
    if s % chunk_eff:
        chunk_eff = s                                   # smoke shapes
    y, mem_state = mlstm_chunkwise(q, k, v, log_f, log_i, chunk_eff,
                                   None if state is None else state[1])
    y = y.transpose(1, 2).reshape(b, s, di)
    y = L.rms_norm(y, p['out_norm']) * F.silu(z)
    return (res + L._mm(y, p['w_down'])).to(res.dtype), (conv_state,
                                                         mem_state)


# =============================================================== sLSTM block
# Megatron-style block sharding (the reference's): the post-conv stream is
# gathered once, q/k/v run with output-sharded weights, one reduce at
# w_down.
MLSTM_AXES = {
    'ln': ('embed',), 'w_up': ('embed', 'mlp'), 'conv_w': (None, None),
    'wq': (None, 'mlp'), 'wk': (None, 'mlp'), 'wv': (None, 'mlp'),
    'w_if': (None, None), 'b_if': (None,),
    'out_norm': ('mlp',), 'w_down': ('mlp', 'embed'),
}

# recurrent weights sharded on the output dh: the contraction stays local
SLSTM_AXES = {
    'ln': ('embed',), 'w_in': (None, 'embed', 'state'),
    'r': (None, 'heads', None, 'state'), 'b': (None, 'state'),
    'out_norm': ('state',), 'ln_ff': ('embed',),
    'w_ff1': ('embed', 'mlp'), 'w_ff2': ('mlp', 'embed'),
}


def init_slstm(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    dtype, dev = cfg.dtype(), gen.device
    ffd = int(d * 4 / 3)
    return {
        'ln': torch.ones((d,), dtype=dtype, device=dev),
        'w_in': L.mk_param(gen, (4, d, d), dtype, fan_in_dims=(1,)),
        'r': L.mk_param(gen, (4, h, dh, dh), dtype, fan_in_dims=(2,)),
        'b': torch.zeros((4, d), dtype=dtype, device=dev),
        'out_norm': torch.ones((d,), dtype=dtype, device=dev),
        'ln_ff': torch.ones((d,), dtype=dtype, device=dev),
        'w_ff1': L.mk_param(gen, (d, 2 * ffd), dtype),
        'w_ff2': L.mk_param(gen, (ffd, d), dtype),
    }


def init_slstm_state(batch: int, d: int, device, lead=()):
    """The sLSTM's initial (c, n, m, h), each (*lead, B, D) f32: zeros,
    1e-6, -10 and zeros."""
    zeros = torch.zeros(tuple(lead) + (batch, d), dtype=f32, device=device)
    return zeros, zeros + 1e-6, zeros - 10.0, zeros.clone()


def slstm_scan(p: Params, zx: torch.Tensor, state, n_heads: int,
               backend: str = 'auto'):
    """Sequential sLSTM recurrence (exp input gate, normaliser and
    stabiliser).  zx: (B, S, 4, D), the input contributions (gate order z,
    i, f, o); the recurrent product r @ h is block-diagonal per head.
    Returns (y (B, S, D) f32, (c, n, m, h)).  ``backend`` is one of
    ``core.lstm.BACKENDS``; every backend runs this plain per-step loop,
    as every backend of the reference runs its XLA scan (its docstring):
    the sLSTM's elementwise phase is in no sequence kernel."""
    from ..core.lstm import BACKENDS
    if backend not in BACKENDS:
        raise ValueError(f'lstm_backend {backend!r}, expected one of '
                         f'{BACKENDS}')
    b, s, _, d = zx.shape
    h = n_heads
    dh = d // h
    r = p['r'].to(f32)
    c, n, m, hid = (init_slstm_state(b, d, zx.device) if state is None
                    else state)
    ys = []
    # a trace reads the loop's host time under this label (nothing when no
    # profiler runs)
    with torch.profiler.record_function(SLSTM_LABEL):
        for t in steps(range(s), zx):
            rec = torch.einsum('ghde,bhd->bghe', r,
                               hid.reshape(b, h, dh)).reshape(b, 4, d)
            pre = zx[:, t].to(f32) + rec
            z = torch.tanh(pre[:, 0])
            log_i = pre[:, 1]
            log_f = F.logsigmoid(pre[:, 2])
            o = torch.sigmoid(pre[:, 3])
            m_new = torch.maximum(log_f + m, log_i)
            i_s = torch.exp(log_i - m_new)
            f_s = torch.exp(log_f + m - m_new)
            c = f_s * c + i_s * z
            n = torch.clamp_min(f_s * n + i_s, 1e-6)
            m = m_new
            hid = o * (c / n)
            ys.append(hid)
    return stack_steps(ys, s, dim=1), (c, n, m, hid)


def slstm_block(cfg: ArchConfig, p: Params, x: torch.Tensor, state=None):
    res = x
    xn = L.rms_norm(x, p['ln'])
    dt = torch.promote_types(xn.dtype, p['w_in'].dtype)
    zx = torch.einsum('bsd,gde->bsge', xn.to(dt), p['w_in'].to(dt)) + p['b']
    y, state = slstm_scan(p, zx, state, cfg.n_heads,
                          backend=cfg.lstm_backend)
    y = L.rms_norm(y.to(x.dtype), p['out_norm'])
    x = (res + y).to(res.dtype)
    # post-FFN (projection factor 4/3, gated)
    a, g = L._mm(L.rms_norm(x, p['ln_ff']), p['w_ff1']).chunk(2, dim=-1)
    return (x + L._mm(F.silu(g) * a, p['w_ff2'])).to(res.dtype), state


# ================================================================ xLSTM model
def init_xlstm(cfg: ArchConfig, generator: torch.Generator = None,
               device='cuda') -> Params:
    """Random weights for ``cfg`` drawn on ``device`` from ``generator``
    (a fresh one seeded 0 when None), with the reference's tree:
    ``{'embed', 'mlstm' (groups, per - 1, ...), 'slstm' (groups, ...),
    'final_norm'}``, one layer drawn at a time
    (``transformer._stack_init``)."""
    dev = torch.device(device)
    gen = (torch.Generator(dev).manual_seed(0) if generator is None
           else generator)
    if gen.device.type != dev.type:
        raise ValueError(f'init_xlstm: generator on {gen.device}, weights '
                         f'on {dev}')
    per = cfg.xlstm_slstm_every
    n_groups = cfg.n_layers // per
    return {'embed': L.init_embedding(cfg, gen, cfg.dtype()),
            'mlstm': _stack_init(lambda: init_mlstm(cfg, gen),
                                 (n_groups, per - 1)),
            'slstm': _stack_init(lambda: init_slstm(cfg, gen), n_groups),
            'final_norm': {'scale': torch.ones(
                (cfg.d_model,), dtype=cfg.dtype(), device=dev)}}


def xlstm_axes(cfg: ArchConfig) -> dict:
    """The logical axes of ``init_xlstm``'s parameters, leaf for leaf."""
    return {'embed': L.embedding_axes(cfg),
            'mlstm': stacked_axes(MLSTM_AXES, 2),
            'slstm': stacked_axes(SLSTM_AXES),
            'final_norm': {'scale': ('embed',)}}


def xlstm_state_axes(cfg: ArchConfig):
    """The logical axes of ``init_xlstm_state``'s tensors (the
    reference's layout)."""
    conv_ax = ('layers', None, 'batch', None, 'mlp')
    mem_ax = (('layers', None, 'batch', 'heads', 'head_dim', None),
              ('layers', None, 'batch', 'heads', 'head_dim'),
              ('layers', None, 'batch', 'heads'))
    s_ax = ('layers', 'batch', 'embed')
    return (conv_ax, mem_ax), (s_ax, s_ax, s_ax, s_ax)


def forward_xlstm(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  states=None):
    """tokens (B, S) -> (logits (B, S, V), the final states).  ``states``
    (``init_xlstm_state``'s tree) continues from them (decode), and the
    returned states have the same tree, new tensors (the reference's
    stacked scan outputs): ((conv, (C, n, m)) over (groups, per - 1),
    (c, n, m, h) over groups).  Without ``states`` (the loss and the
    forward, which read the logits alone) each group's states are dropped
    as it ends and None is returned for them: no stack of the matrix
    memories (42 x B x 16.8 MB at full width) is built."""
    x = L.embed(cfg, params['embed'], tokens)
    per = cfg.xlstm_slstm_every
    decode = states is not None
    groups = unbind(params['mlstm'])
    n_groups = len(groups)
    if decode:
        m_states = [[tree_map(lambda a: a[g, i], states[0])
                     for i in range(per - 1)] for g in range(n_groups)]
        s_states = [tree_map(lambda a: a[g], states[1])
                    for g in range(n_groups)]
    else:
        m_states = [[None] * (per - 1)] * n_groups
        s_states = [None] * n_groups

    def body(group, sblk, x, m_st, s_st):
        new_m = []
        for blk, st in zip(unbind(group), m_st):
            x, st = mlstm_block(cfg, blk, x, state=st)
            new_m.append(st)
        x, s_st = slstm_block(cfg, sblk, x, state=s_st)
        return x, new_m, s_st

    if not decode:
        body = _maybe_remat(cfg, body)
    new_m, new_s = [], []
    for g, (group, sblk) in enumerate(zip(groups,
                                          unbind(params['slstm']))):
        x, m_st, s_st = body(group, sblk, x, m_states[g], s_states[g])
        if decode:
            new_m.append(m_st)
            new_s.append(s_st)
    x = L.rms_norm(x, params['final_norm']['scale'])
    if not decode:
        return L.unembed(cfg, params['embed'], x), None
    # one copy of each layer's state into its stack
    new_states = (
        tree_map(lambda *a: torch.stack(a).unflatten(0, (n_groups, per - 1)),
                 *[st for g in new_m for st in g]),
        tree_map(lambda *a: torch.stack(a), *new_s))
    return L.unembed(cfg, params['embed'], x), new_states


def init_xlstm_state(cfg: ArchConfig, batch: int, device='cuda'):
    """The recurrent state that stands in for the KV cache: ((conv (groups,
    per - 1, B, K - 1, 2d) in the activation dtype, (C, n, m) f32 with m =
    -1e30), (c, n, m, h) f32 each (groups, B, d)).  A step returns its
    conv state in the dtype its inputs promote to (f32 for both configs),
    as the reference's does."""
    per = cfg.xlstm_slstm_every
    n_groups = cfg.n_layers // per
    d = cfg.d_model
    di, h = 2 * d, cfg.n_heads
    dh = di // h
    lead = (n_groups, per - 1, batch)
    conv = torch.zeros(lead + (cfg.conv_kernel - 1, di), dtype=cfg.adtype(),
                       device=device)
    mem = (torch.zeros(lead + (h, dh, dh), dtype=f32, device=device),
           torch.zeros(lead + (h, dh), dtype=f32, device=device),
           torch.full(lead + (h,), -1e30, dtype=f32, device=device))
    return (conv, mem), init_slstm_state(batch, d, device, (n_groups,))


# ================================================================ Mamba block
def init_mamba(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Mamba's parameters; ``b_dt`` is the reference's own numpy draw
    (``RandomState(0)``, the same in every layer) and ``a_log`` is f32
    whatever the parameter dtype."""
    d = cfg.d_model
    di = d                          # hymba: mamba heads span d_model
    n = cfg.ssm_state
    dtype, dev = cfg.dtype(), gen.device
    dt_rank = max(d // 16, 1)
    b_dt = np.log(np.expm1(np.random.RandomState(0).uniform(
        1e-3, 1e-1, size=(di,))))
    return {
        'w_in': L.mk_param(gen, (d, 2 * di), dtype),
        'conv_w': L.mk_param(gen, (cfg.conv_kernel, di), dtype,
                             scale=cfg.conv_kernel ** -0.5),
        'w_bdt': L.mk_param(gen, (di, 2 * n + dt_rank), dtype),
        'w_dt': L.mk_param(gen, (dt_rank, di), dtype),
        'b_dt': torch.from_numpy(b_dt).to(device=dev, dtype=dtype),
        'a_log': torch.log(torch.arange(1, n + 1, dtype=f32, device=dev)
                           ).repeat(di, 1),
        'd_skip': torch.ones((di,), dtype=dtype, device=dev),
        'w_out': L.mk_param(gen, (di, d), dtype),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_{-1} = 0, for every t: the
    reference's ``associative_scan`` with the same combine, as a log-depth
    doubling (Hillis-Steele) scan: ceil(log2 S) rounds of whole-tensor ops,
    not a loop of S steps."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def mamba_mix(cfg: ArchConfig, p: Params, x: torch.Tensor, state=None):
    """The selective SSM (Mamba-1).  x: (B, S, D); state: (conv (B, K - 1,
    di), ssm (B, di, N) f32) or None.  Returns (y (B, S, D), (conv, the
    last step's ssm state)).  A carried state seeds the scan through a
    virtual step 0: a_bar_0 * ssm is added to step 0's input."""
    n = cfg.ssm_state
    u, z = L._mm(x, p['w_in']).chunk(2, dim=-1)           # (B, S, di) each
    u_c, conv_state = _causal_conv(u, p['conv_w'],
                                   None if state is None else state[0])
    u_c = F.silu(u_c)
    bdt = L._mm(u_c, p['w_bdt'])
    b_mat = bdt[..., :n].to(f32)                           # (B, S, N)
    c_mat = bdt[..., n:2 * n].to(f32)
    dt = F.softplus(L._mm(bdt[..., 2 * n:], p['w_dt']) + p['b_dt']).to(f32)
    a = -torch.exp(p['a_log'])                             # (di, N)
    a_bar = torch.exp(dt[..., None] * a)                   # (B, S, di, N)
    bx = dt[..., None] * b_mat[..., None, :] * u_c.to(f32)[..., None]
    if state is not None:
        bx = torch.cat([bx[:, :1] + a_bar[:, :1] * state[1][:, None],
                        bx[:, 1:]], dim=1)
    hs = _linear_scan(a_bar, bx)
    y = torch.einsum('bsdn,bsn->bsd', hs, c_mat).to(x.dtype)
    y = (y + u_c * p['d_skip']) * F.silu(z)
    return L._mm(y, p['w_out']), (conv_state, hs[:, -1])


# ================================================================ Hymba model
MAMBA_AXES = {
    'w_in': ('embed', 'mlp'), 'conv_w': (None, 'mlp'),
    'w_bdt': ('mlp', None), 'w_dt': (None, 'mlp'), 'b_dt': ('mlp',),
    'a_log': ('mlp', None), 'd_skip': ('mlp',), 'w_out': ('mlp', 'embed'),
}


def hymba_axes(cfg: ArchConfig) -> dict:
    """The logical axes of ``init_hymba``'s parameters, leaf for leaf."""
    blk = {'ln1': L.norm_axes(cfg), 'attn': L.attention_axes(cfg),
           'mamba': MAMBA_AXES, 'attn_norm': ('embed',),
           'mamba_norm': ('embed',), 'ln2': L.norm_axes(cfg),
           'mlp': L.mlp_axes(cfg)}
    return {'embed': L.embedding_axes(cfg), 'blocks': stacked_axes(blk),
            'meta': (None, 'embed'), 'final_norm': L.norm_axes(cfg)}


def hymba_cache_axes(cfg: ArchConfig) -> List[dict]:
    """The logical axes of ``init_hymba_cache``'s tensors, a dict per
    layer in the port's layout (``kv_heads`` before ``kv_seq``; no
    ``pos``)."""
    kv = ('batch', 'kv_heads', 'kv_seq', 'head_dim_act')
    return [{'k': kv, 'v': kv, 'conv': ('batch', None, 'mlp'),
             'ssm': ('batch', 'mlp', None)} for _ in range(cfg.n_layers)]


def init_hymba_block(cfg: ArchConfig, gen: torch.Generator) -> Params:
    dtype, dev = cfg.dtype(), gen.device
    return {'ln1': L.init_norm(cfg, dtype, dev),
            'attn': L.init_attention(cfg, gen, dtype),
            'mamba': init_mamba(cfg, gen),
            'attn_norm': torch.ones((cfg.d_model,), dtype=dtype, device=dev),
            'mamba_norm': torch.ones((cfg.d_model,), dtype=dtype,
                                     device=dev),
            'ln2': L.init_norm(cfg, dtype, dev),
            'mlp': L.init_mlp(cfg, gen, dtype)}


def init_hymba(cfg: ArchConfig, generator: torch.Generator = None,
               device='cuda') -> Params:
    """Random weights for ``cfg`` on ``device`` from ``generator`` (a fresh
    one seeded 0 when None): ``{'embed', 'blocks' (layers, ...), 'meta'
    (128, d), 'final_norm'}``, the reference's tree."""
    dev = torch.device(device)
    gen = (torch.Generator(dev).manual_seed(0) if generator is None
           else generator)
    if gen.device.type != dev.type:
        raise ValueError(f'init_hymba: generator on {gen.device}, weights '
                         f'on {dev}')
    dtype = cfg.dtype()
    return {'embed': L.init_embedding(cfg, gen, dtype),
            'blocks': _stack_init(lambda: init_hymba_block(cfg, gen),
                                  cfg.n_layers),
            'meta': L.mk_param(gen, (N_META, cfg.d_model), dtype,
                               scale=0.02),
            'final_norm': L.init_norm(cfg, dtype, dev)}


def _window(cfg: ArchConfig, layer: int) -> Optional[int]:
    """The layer's attention window: none on ``global_layer_ids``."""
    return None if layer in cfg.global_layer_ids else cfg.sliding_window


def _fuse(cfg: ArchConfig, blk: Params, x, attn_out, mamba_out):
    """The two heads fused by normalised averaging, then the MLP; the
    residual back in x's dtype after each half."""
    dt = x.dtype
    x = (x + 0.5 * (L.rms_norm(attn_out, blk['attn_norm'])
                    + L.rms_norm(mamba_out, blk['mamba_norm']))).to(dt)
    h2 = L.apply_norm(cfg, blk['ln2'], x)
    return (x + L.mlp_block(cfg, blk['mlp'], h2)).to(dt)


def hymba_block(cfg: ArchConfig, blk: Params, x: torch.Tensor, cos_sin,
                window: Optional[int], state=None):
    """A full-sequence Hymba layer: causal attention over x with RoPE from
    ``cos_sin`` and ``window`` (None on a global layer; the reference
    traces ``inf`` there) beside the Mamba heads, fused by normalised
    averaging.  Returns (x, the Mamba state)."""
    h = L.apply_norm(cfg, blk['ln1'], x)
    attn_out = L.attention_block(cfg, blk['attn'], h, cos_sin=cos_sin,
                                 causal=True, window=window)
    mamba_out, state = mamba_mix(cfg, blk['mamba'], h, state=state)
    return _fuse(cfg, blk, x, attn_out, mamba_out), state


def forward_hymba(cfg: ArchConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V): the 128 meta tokens prepended,
    RoPE over positions 0 .. S + 127, the meta rows dropped before the
    unembedding."""
    x = L.embed(cfg, params['embed'], tokens)
    meta = params['meta'].to(x.dtype).expand(x.shape[0], -1, -1)
    x = torch.cat([meta, x], dim=1)
    cos_sin = L.rope_cos_sin(torch.arange(x.shape[1], device=x.device),
                             cfg.resolved_head_dim, cfg.rope_theta)
    body = _maybe_remat(cfg, lambda blk, x, w: hymba_block(
        cfg, blk, x, cos_sin, w)[0])
    for i, blk in enumerate(unbind(params['blocks'])):
        x = body(blk, x, _window(cfg, i))
    x = L.apply_norm(cfg, params['final_norm'], x)[:, N_META:]
    return L.unembed(cfg, params['embed'], x)


def init_hymba_cache(cfg: ArchConfig, batch: int, max_seq: int,
                     device='cuda') -> List[Params]:
    """A cache per layer (widths differ): ``{'k', 'v'}`` (B, Hkv, W, hd) in
    the activation dtype, a ring of W = max_seq slots on a global layer and
    min(window, max_seq) on the others; ``conv`` (B, K - 1, d) in the
    activation dtype and ``ssm`` (B, d, N) f32, zero.

    Deviation in layout from the reference's (B, W', Hkv, hd) with a
    ``pos`` row, W' = max_seq + 128 (global) or min(window, max_seq + 128):
    the reference writes token t to slot (t + 128) % W' and never fills
    the 128 meta slots, so they are always masked; the port writes token t
    to slot t % W (``layers.attention_decode``, K8 with kv_len alone),
    which holds the same keys (softmax ignores their order).
    ``convert.hymba_cache_from_numpy`` rolls the reference's slots."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.adtype()
    caches = []
    for layer in range(cfg.n_layers):
        w = min(_window(cfg, layer) or max_seq, max_seq)
        caches.append({
            'k': torch.zeros((batch, hk, w, hd), dtype=dt, device=device),
            'v': torch.zeros((batch, hk, w, hd), dtype=dt, device=device),
            'conv': torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_model),
                                dtype=dt, device=device),
            'ssm': torch.zeros((batch, cfg.d_model, cfg.ssm_state),
                               dtype=f32, device=device)})
    return caches


def hymba_decode_step(cfg: ArchConfig, params: Params, cache: List[Params],
                      tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B, 1) at position ``pos`` (a Python int).
    Each layer's K/V row goes to slot ``pos % W`` of its ring in place,
    K8 reads kv_len = min(pos + 1, W) keys, and RoPE takes position
    pos + 128, the reference's offset for the meta tokens (which, as in
    the reference, are in no cache: R5).  Each layer's ``conv`` and
    ``ssm`` entries are replaced by the new states.  Returns (logits (B,
    1, V), cache)."""
    pos = int(pos)
    x = L.embed(cfg, params['embed'], tokens)
    cos_sin = L.rope_cos_sin(
        torch.full((1,), pos + N_META, dtype=f32, device=tokens.device),
        cfg.resolved_head_dim, cfg.rope_theta)
    for i, blk in enumerate(unbind(params['blocks'])):
        c = cache[i]
        h = L.apply_norm(cfg, blk['ln1'], x)
        attn_out = L.attention_decode(cfg, blk['attn'], h, c, pos=pos,
                                      cos_sin=cos_sin,
                                      window=_window(cfg, i))
        mamba_out, (c['conv'], c['ssm']) = mamba_mix(
            cfg, blk['mamba'], h, state=(c['conv'], c['ssm']))
        x = _fuse(cfg, blk, x, attn_out, mamba_out)
    x = L.apply_norm(cfg, params['final_norm'], x)
    return L.unembed(cfg, params['embed'], x), cache
