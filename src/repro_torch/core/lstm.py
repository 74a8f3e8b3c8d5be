"""Canonical peephole LSTM (paper Eqs. 1-5): forward, serving and the
hand-written training backward, in PyTorch.

    i_t = sigma(W_xi x_t + W_hi h_{t-1} + w_ci . c_{t-1} + b_i)
    f_t = sigma(W_xf x_t + W_hf h_{t-1} + w_cf . c_{t-1} + b_f)
    c_t = f_t . c_{t-1} + i_t . tanh(W_xc x_t + W_hc h_{t-1} + b_c)
    o_t = sigma(W_xo x_t + W_ho h_{t-1} + w_co . c_t + b_o)
    h_t = o_t . tanh(c_t)

Port of ``repro.core.lstm`` with the same layouts: gate order (i, f, g, o),
``w_x`` (4, N_h, N_x), ``w_h`` (4, N_h, N_h), diagonal peepholes ``w_peep``
(3, N_h), bias ``b`` (4, N_h).

Backends (``BACKENDS``) and their TPU counterparts in the JAX package:

  ==================  ======================  ==============================
  port                JAX reference           engine
  ==================  ======================  ==============================
  ``torch_scan``      ``xla_scan``            plain PyTorch step loop
  ``cuda_seq``        ``pallas_seq``          K1, persistent layer kernel
                                              (``csrc/lstm_seq.cu``), one
                                              launch per layer per chunk
  ``cuda_seq_fused``  ``pallas_seq_fused``    K2, whole-stack wavefront
                                              (``csrc/lstm_stack_seq.cu``),
                                              one launch per chunk
  ``cuda_step``       ``pallas_step``         K5, one recurrent step
                                              (``csrc/lstm_gates_rec.cu``),
                                              T launches per layer call
  ==================  ======================  ==============================

Every backend is trainable: ``lstm_layer_fused`` and ``lstm_stack_apply``
are differentiable through ``torch.autograd.Function``s whose backward is
the reference's hand-written one — the scan keeps its gates
(``lstm_scan_fused``, backward ``lstm_bwd_core``); the kernel backends
save only the h/c trajectories and recompute the gates with one wide
product (``lstm_bwd_recompute_gates``, and across the stack
``lstm_stack_bwd_recompute_gates``).  The JAX package has no backward
kernel, so the backward is plain PyTorch with ``torch.einsum`` for its wide
products.

``auto`` does not copy the TPU's VMEM rule.  On CPU tensors it picks
``torch_scan``.  On CUDA tensors it picks ``cuda_seq_fused`` when the stack
is homogeneous (``stack_fused_compatible``), has at least two layers, and
the wavefront kernel's launch geometry is admissible (shared memory per CTA
within the card's limit, every CTA co-resident); otherwise ``cuda_seq``.
``cuda_step`` is a plain launch, so its admission is the shared-memory
bound of its launcher only; K5 has no masked form, so it is not a serving
backend on the card (a masked chunk on CUDA tensors raises).  An explicitly
chosen backend that is not admissible raises; it is never quietly
replaced.  On CPU tensors the kernel backends run their kernels' plain
PyTorch versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

GATES = 4  # i, f, g, o
I, F, G, O = 0, 1, 2, 3
PEEP_I, PEEP_F, PEEP_O = 0, 1, 2

BACKENDS = ('auto', 'torch_scan', 'cuda_seq', 'cuda_seq_fused', 'cuda_step')


@dataclasses.dataclass
class LSTMParams:
    w_x: torch.Tensor     # (4, N_h, N_x)
    w_h: torch.Tensor     # (4, N_h, N_h)
    w_peep: torch.Tensor  # (3, N_h) diagonal peepholes for i, f, o
    b: torch.Tensor       # (4, N_h)

    @property
    def n_h(self) -> int:
        return self.w_h.shape[-1]

    @property
    def n_x(self) -> int:
        return self.w_x.shape[-1]


@dataclasses.dataclass
class LSTMStackParams:
    layers: Tuple[LSTMParams, ...]
    w_out: Optional[torch.Tensor]   # (N_out, N_h) dense read-out
    b_out: Optional[torch.Tensor]   # (N_out,)


def init_lstm_params(n_x: int, n_h: int, generator: torch.Generator,
                     dtype=torch.float32, forget_bias: float = 1.0
                     ) -> LSTMParams:
    """Random layer weights on the CPU, drawn like the reference's init
    (uniform in [-1, 1) scaled by 1/sqrt(fan-in), peepholes by 0.1, forget
    bias 1); the bits differ from ``jax.random``."""
    def uni(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1
    b = torch.zeros((GATES, n_h), dtype=dtype)
    b[F] = forget_bias
    return LSTMParams(w_x=uni(GATES, n_h, n_x) / n_x ** 0.5,
                      w_h=uni(GATES, n_h, n_h) / n_h ** 0.5,
                      w_peep=uni(3, n_h) * 0.1, b=b)


def init_lstm_stack(n_x: int, n_h: int, n_layers: int,
                    n_out: Optional[int], generator: torch.Generator,
                    dtype=torch.float32) -> LSTMStackParams:
    """A stack of ``n_layers`` layers (``n_x -> n_h -> ... -> n_h``) plus an
    optional dense read-out, on the CPU."""
    layers = tuple(init_lstm_params(n_x if l == 0 else n_h, n_h, generator,
                                    dtype) for l in range(n_layers))
    w_out = b_out = None
    if n_out is not None:
        w_out = (torch.rand((n_out, n_h), generator=generator, dtype=dtype)
                 * 2 - 1) / n_h ** 0.5
        b_out = torch.zeros((n_out,), dtype=dtype)
    return LSTMStackParams(layers, w_out, b_out)


def stack_params_to(params: LSTMStackParams, device) -> LSTMStackParams:
    """The same stack with every tensor moved to ``device``."""
    mv = lambda a: None if a is None else a.to(device)
    return LSTMStackParams(
        tuple(LSTMParams(*(mv(getattr(l, f.name))
                           for f in dataclasses.fields(LSTMParams)))
              for l in params.layers),
        mv(params.w_out), mv(params.b_out))


# ---------------------------------------------------------------------------
# Paper-equation oracles
# ---------------------------------------------------------------------------

def lstm_cell(params: LSTMParams, x_t: torch.Tensor, h_prev: torch.Tensor,
              c_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM timestep.  x_t: (..., N_x); h_prev, c_prev: (..., N_h)."""
    pre = (torch.einsum('ghx,...x->...gh', params.w_x, x_t)
           + torch.einsum('ghk,...k->...gh', params.w_h, h_prev))
    i = torch.sigmoid(pre[..., I, :] + params.w_peep[PEEP_I] * c_prev
                      + params.b[I])
    f = torch.sigmoid(pre[..., F, :] + params.w_peep[PEEP_F] * c_prev
                      + params.b[F])
    g = torch.tanh(pre[..., G, :] + params.b[G])
    c_t = f * c_prev + i * g
    o = torch.sigmoid(pre[..., O, :] + params.w_peep[PEEP_O] * c_t + params.b[O])
    return o * torch.tanh(c_t), c_t


def lstm_layer(params: LSTMParams, xs: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               c0: Optional[torch.Tensor] = None):
    """Scan a layer over time.  xs: (T, ..., N_x) -> (hs (T, ..., N_h),
    (h_T, c_T)).  W_x @ x is hoisted out of the loop as one wide product,
    as in the reference."""
    batch_shape = xs.shape[1:-1]
    zeros = xs.new_zeros(batch_shape + (params.n_h,))
    h = zeros if h0 is None else h0
    c = zeros if c0 is None else c0
    pre_x = torch.einsum('ghx,t...x->t...gh', params.w_x, xs)
    hs = []
    for pre_x_t in pre_x:
        h, c = _cell_body(params.w_h, params.w_peep, params.b, pre_x_t, h, c)
        hs.append(h)
    return torch.stack(hs), (h, c)


# ---------------------------------------------------------------------------
# Hand-written training backward (the reference's ``lstm_bwd_core`` family):
# weight gradients accumulate outside the reverse-time loop as single wide
# contractions.
# ---------------------------------------------------------------------------

def _lstm_scan(w_h, w_peep, b, pre_x, h0, c0):
    """The unmasked scan, keeping its gates for the backward.  pre_x:
    (T, B, 4, N_h).  Returns (hs, cs, gates (T, B, 4, N_h))."""
    h, c = h0, c0
    hs, cs, gates = [], [], []
    for pre_x_t in pre_x:
        pre = pre_x_t + torch.einsum('ghk,...k->...gh', w_h, h)
        h, c, g = _gate_phase(pre, w_peep, b, c)
        hs.append(h)
        cs.append(c)
        gates.append(torch.stack(g, dim=-2))
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def lstm_bwd_core(w_h, w_peep, hs, cs, gates, h0, c0, dhs, dh_T, dc_T):
    """The shared reverse-time scan of the scan's backward and of the gate
    recompute.  hs, cs: (T, B, N_h) saved trajectories; gates (T, B, 4,
    N_h); dhs the cotangent of hs, (dh_T, dc_T) of the final state.
    Returns (dw_h, d_peep, db, dpre_x, dh0, dc0)."""
    h_prevs = torch.cat([h0[None], hs[:-1]])
    c_prevs = torch.cat([c0[None], cs[:-1]])
    dh_next, dc_next = dh_T, dc_T
    das = [None] * hs.shape[0]
    for t in range(hs.shape[0] - 1, -1, -1):
        i, f, g, o = gates[t].unbind(-2)
        dh = dhs[t] + dh_next
        tc = torch.tanh(cs[t])
        do = dh * tc
        da_o = do * o * (1 - o)
        dct = dh * o * (1 - tc * tc) + dc_next + da_o * w_peep[PEEP_O]
        da_i = dct * g * i * (1 - i)
        da_f = dct * c_prevs[t] * f * (1 - f)
        da_g = dct * i * (1 - g * g)
        dc_next = dct * f + da_i * w_peep[PEEP_I] + da_f * w_peep[PEEP_F]
        das[t] = torch.stack([da_i, da_f, da_g, da_o], dim=-2)
        dh_next = torch.einsum('ghk,...gh->...k', w_h, das[t])
    das = torch.stack(das)
    # weight gradients: single wide contractions outside the loop
    dw_h = torch.einsum('t...gh,t...k->ghk', das, h_prevs)
    d_peep = torch.stack([
        torch.einsum('t...h,t...h->h', das[..., I, :], c_prevs),
        torch.einsum('t...h,t...h->h', das[..., F, :], c_prevs),
        torch.einsum('t...h,t...h->h', das[..., O, :], cs)])
    db = das.sum(dim=tuple(range(das.ndim - 2)))
    return dw_h, d_peep, db, das, dh_next, dc_next


class _ScanFused(torch.autograd.Function):
    """The scan with its gates saved; backward ``lstm_bwd_core``.  Returns
    (hs, c_T); h_T is ``hs[-1]``, so its cotangent arrives inside dhs."""

    @staticmethod
    def forward(ctx, w_h, w_peep, b, pre_x, h0, c0):
        hs, cs, gates = _lstm_scan(w_h, w_peep, b, pre_x, h0, c0)
        ctx.save_for_backward(w_h, w_peep, hs, cs, gates, h0, c0)
        return hs, cs[-1].clone()

    @staticmethod
    def backward(ctx, dhs, dc_T):
        w_h, w_peep, hs, cs, gates, h0, c0 = ctx.saved_tensors
        return lstm_bwd_core(w_h, w_peep, hs, cs, gates, h0, c0, dhs,
                             torch.zeros_like(h0), dc_T)


def lstm_scan_fused(w_h, w_peep, b, pre_x, h0, c0):
    """The ``torch_scan`` layer with the hand-written backward.  pre_x:
    (T, B, 4, N_h); h0, c0: (B, N_h).  Returns (hs, (h_T, c_T))."""
    hs, c_T = _ScanFused.apply(w_h, w_peep, b, pre_x, h0, c0)
    return hs, (hs[-1], c_T)


def lstm_bwd_recompute_gates(w_h, w_peep, b, pre_x, hs, cs, h0, c0, grads):
    """Backward from the saved h/c trajectories only (no stored gates):
    the gates are recomputed with one wide product and the elementwise
    epilogue, then ``lstm_bwd_core`` runs.  grads: (dhs, (dh_T, dc_T)).
    Returns (dw_h, d_peep, db, dpre_x, dh0, dc0)."""
    dhs, (dh_T, dc_T) = grads
    h_prevs = torch.cat([h0[None], hs[:-1]])
    c_prevs = torch.cat([c0[None], cs[:-1]])
    pre = pre_x + torch.einsum('ghk,t...k->t...gh', w_h, h_prevs)
    i = torch.sigmoid(pre[..., I, :] + w_peep[PEEP_I] * c_prevs + b[I])
    f = torch.sigmoid(pre[..., F, :] + w_peep[PEEP_F] * c_prevs + b[F])
    g = torch.tanh(pre[..., G, :] + b[G])
    o = torch.sigmoid(pre[..., O, :] + w_peep[PEEP_O] * cs + b[O])
    gates = torch.stack([i, f, g, o], dim=-2)
    return lstm_bwd_core(w_h, w_peep, hs, cs, gates, h0, c0, dhs, dh_T, dc_T)


def lstm_stack_bwd_recompute_gates(w_in, w_h, peep, b, pre_x, hs, cs, h0s,
                                   c0s, grads):
    """Cross-layer gate-recompute backward of a homogeneous stack, in the
    port's stack layout: ``lstm_bwd_recompute_gates`` composed down the
    stack, each inner layer's hoisted input recomputed from the trajectory
    below it.  w_in: (L-1, 4, N_h, N_h) input weights of layers 1..L-1;
    w_h: (L, 4, N_h, N_h); pre_x: (T, B, 4, N_h) layer 0's hoisted input;
    hs, cs: (L, T, B, N_h); h0s, c0s: (L, B, N_h); grads: (d_ys (T, B, N_h)
    of the top layer, (d_hT, d_cT) each (L, B, N_h)).  Returns (dw_in,
    dw_h, d_peep, db, d_pre_x0, dh0s, dc0s)."""
    d_ys, (d_hT, d_cT) = grads
    L = w_h.shape[0]
    dw_in, dw_h, d_peep, db, dh0, dc0 = [], [], [], [], [], []
    d_hs = d_ys                     # cotangent flowing into the top layer
    d_pre_x0 = None
    for l in range(L - 1, -1, -1):
        pre_l = pre_x if l == 0 else torch.einsum(
            'ghx,tbx->tbgh', w_in[l - 1], hs[l - 1])
        dwh, dp, dbias, dpre, dh, dc = lstm_bwd_recompute_gates(
            w_h[l], peep[l], b[l], pre_l, hs[l], cs[l], h0s[l], c0s[l],
            (d_hs, (d_hT[l], d_cT[l])))
        for acc, v in ((dw_h, dwh), (d_peep, dp), (db, dbias), (dh0, dh),
                       (dc0, dc)):
            acc.append(v)
        if l > 0:
            dw_in.append(torch.einsum('tbgh,tbx->ghx', dpre, hs[l - 1]))
            d_hs = torch.einsum('ghx,tbgh->tbx', w_in[l - 1], dpre)
        else:
            d_pre_x0 = dpre
    stack = lambda xs: torch.stack(xs[::-1])
    return (stack(dw_in) if dw_in else torch.zeros_like(w_in), stack(dw_h),
            stack(d_peep), stack(db), d_pre_x0, stack(dh0), stack(dc0))


class _RecomputeGates(torch.autograd.Function):
    """A layer whose forward ``forward_fn(w_h, w_peep, b, pre_x, h0, c0) ->
    (hs, cs)`` is a kernel that keeps its gates on chip, and whose backward
    is ``lstm_bwd_recompute_gates`` from the saved trajectories.  Returns
    (hs, c_T); h_T is ``hs[-1]``."""

    @staticmethod
    def forward(ctx, forward_fn, w_h, w_peep, b, pre_x, h0, c0):
        hs, cs = forward_fn(w_h, w_peep, b, pre_x, h0, c0)
        ctx.save_for_backward(w_h, w_peep, b, pre_x, hs, cs, h0, c0)
        return hs, cs[-1].clone()

    @staticmethod
    def backward(ctx, dhs, dc_T):
        w_h, w_peep, b, pre_x, hs, cs, h0, c0 = ctx.saved_tensors
        return (None,) + lstm_bwd_recompute_gates(
            w_h, w_peep, b, pre_x, hs, cs, h0, c0,
            (dhs, (torch.zeros_like(h0), dc_T)))


def recompute_gates_layer(forward_fn: Callable, w_h, w_peep, b, pre_x, h0,
                          c0):
    """``forward_fn``'s layer (see ``_RecomputeGates``) made
    differentiable with the gate-recompute backward.  Returns (hs, (h_T,
    c_T))."""
    hs, c_T = _RecomputeGates.apply(forward_fn, w_h, w_peep, b, pre_x, h0,
                                    c0)
    return hs, (hs[-1], c_T)


def lstm_layer_fused(params: LSTMParams, xs: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     c0: Optional[torch.Tensor] = None, *,
                     backend: str = 'auto'):
    """``lstm_layer`` with the hand-written backward — the training path.
    xs: (T, B, N_x) -> (hs (T, B, N_h), (h_T, c_T)).  ``backend``:
    ``torch_scan`` (``lstm_scan_fused``), ``cuda_seq`` (K1,
    ``kernels.lstm_seq.lstm_layer_seq``), ``cuda_step`` (T launches of K5,
    ``kernels.lstm_gates.lstm_layer_fused``); ``cuda_seq_fused`` on one
    layer is ``cuda_seq``, and ``auto`` is ``cuda_seq`` on CUDA tensors,
    ``torch_scan`` on CPU tensors.  Forward allclose across backends,
    backward through the same gate-recompute family."""
    if backend not in BACKENDS:
        raise ValueError(f'unknown backend {backend!r}; one of {BACKENDS}')
    if xs.ndim != 3:
        raise ValueError('lstm_layer_fused expects (T, B, N_x) input')
    if backend == 'auto':
        backend = 'cuda_seq' if xs.is_cuda else 'torch_scan'
    if backend == 'cuda_seq_fused':
        backend = 'cuda_seq'        # a 1-layer stack IS the sequence kernel
    if backend == 'cuda_seq':
        from ..kernels.lstm_seq import lstm_layer_seq
        return lstm_layer_seq(params, xs, h0, c0)
    if backend == 'cuda_step':
        from ..kernels.lstm_gates import lstm_layer_fused as step_layer
        return step_layer(params, xs, h0, c0)
    zeros = xs.new_zeros((xs.shape[1], params.n_h))
    return lstm_scan_fused(params.w_h, params.w_peep, params.b,
                           hoisted_input(params.w_x, xs),
                           zeros if h0 is None else h0,
                           zeros if c0 is None else c0)


# ---------------------------------------------------------------------------
# Masked chunked serving primitives (the reference's DESIGN.md §7 contract)
# ---------------------------------------------------------------------------

def _gate_phase(pre, w_peep, b, c_prev):
    """The peephole gate epilogue from the gate sums ``pre`` (..., 4, N_h)
    (W_x x_t + W_h h_{t-1}, bias not yet added), in the reference's order:
    the CPU counterpart of ``_gate_phase`` in the reference's
    ``kernels/lstm_gates/kernel.py`` and of ``csrc/lstm_f32_epilogue.cuh``.
    Returns (h_new, c_new, (i, f, g, o))."""
    i = torch.sigmoid(pre[..., I, :] + w_peep[PEEP_I] * c_prev + b[I])
    f = torch.sigmoid(pre[..., F, :] + w_peep[PEEP_F] * c_prev + b[F])
    g = torch.tanh(pre[..., G, :] + b[G])
    c = f * c_prev + i * g
    o = torch.sigmoid(pre[..., O, :] + w_peep[PEEP_O] * c + b[O])
    return o * torch.tanh(c), c, (i, f, g, o)


def _cell_body(w_h, w_peep, b, pre_x_t, h, c_prev):
    """One step from its hoisted input product: W_h @ h plus the peephole
    gates — the one gate epilogue of every plain loop (``lstm_layer``, the
    kernels' plain versions).  Returns (h_new, c_new)."""
    pre = pre_x_t + torch.einsum('ghk,...k->...gh', w_h, h)
    h_new, c, _ = _gate_phase(pre, w_peep, b, c_prev)
    return h_new, c


def valid_len_mask(T: int, valid_len: torch.Tensor, batch: int
                   ) -> torch.Tensor:
    """The masking contract in one place: step ``t`` of stream ``b`` is
    live iff ``t < valid_len[b]``.  Returns a bool (T, B) mask on
    ``valid_len``'s device."""
    steps = torch.arange(T, device=valid_len.device)
    return steps[:, None] < valid_len.reshape(batch).to(torch.int64)[None, :]


def hoisted_input(w_x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The non-recurrent W_x @ x_t of every step, hoisted out of the
    recurrence: (T, B, N_x) -> (T, B, 4, N_h), the layout every backend
    consumes.  One product per step, each of the same (B, N_x) shape: a
    GEMM library may pick another algorithm, and so other bits, for another
    row count, and a product over all T*B rows would make a row's bits
    depend on how many steps share the call — chunked serving would then
    not be bit-equal to the monolithic call on the card."""
    return torch.stack([torch.einsum('ghx,bx->bgh', w_x, x_t) for x_t in xs])


def readout(w_out: torch.Tensor, b_out: torch.Tensor,
            h: torch.Tensor) -> torch.Tensor:
    """The dense read-out (logits) of a hidden sequence (T, B, N_h) ->
    (T, B, N_out), one product per step for the reason given in
    ``hoisted_input``."""
    return torch.stack([torch.einsum('oh,bh->bo', w_out, h_t) + b_out
                        for h_t in h])


def _lstm_scan_masked(w_h, w_peep, b, pre_x, h0, c0, mask):
    """Masked scan: a masked step is identity on (h, c) and re-emits the
    carried ``h``.  pre_x: (T, B, 4, N_h); mask: (T, B) bool.  The loop is
    K1's plain version (``kernels.lstm_seq.ref.lstm_seq_ref``), whose
    contract is this one.  Returns (hs (T, B, N_h), (h_T, c_T))."""
    from ..kernels.lstm_seq.ref import lstm_seq_ref
    hs, cs = lstm_seq_ref(pre_x, w_h, w_peep, b, h0, c0, mask)
    return hs, (hs[-1], cs[-1])


def lstm_layer_chunk(params: LSTMParams, xs: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     c0: Optional[torch.Tensor] = None, *,
                     valid_len: Optional[torch.Tensor] = None,
                     backend: str = 'auto'):
    """Stateful chunked layer step — the serving-engine primitive.

    xs: (T, B, N_x).  ``valid_len`` (B,) marks steps ``t >= valid_len[b]``
    as identity on the state (the carried ``h`` is re-emitted), so feeding a
    sequence chunk by chunk is bit-equal to one monolithic call on the same
    backend.  Without ``valid_len`` this is ``lstm_layer_fused``
    (differentiable).  ``backend``: ``torch_scan`` | ``cuda_seq`` |
    ``cuda_step`` | ``auto`` (CPU tensors: ``torch_scan``; CUDA tensors:
    ``cuda_seq``).  K5 has no masked form: ``cuda_step`` with a
    ``valid_len`` on CPU tensors runs the masked torch scan, the reference's
    dispatch rule for ``pallas_step`` (``repro.core.lstm.lstm_layer_chunk``);
    on CUDA tensors it raises, since the plain scan on the card would serve
    under a kernel backend's name.  Returns (hs (T, B, N_h), (h_T, c_T)).
    """
    if backend not in ('auto', 'torch_scan', 'cuda_seq', 'cuda_step'):
        raise ValueError(f'layer backend must be auto|torch_scan|cuda_seq|'
                         f'cuda_step, got {backend!r}')
    if xs.ndim != 3:
        raise ValueError('lstm_layer_chunk expects (T, B, N_x) input')
    if valid_len is None:
        return lstm_layer_fused(params, xs, h0, c0, backend=backend)
    T, B = xs.shape[0], xs.shape[1]
    if backend == 'auto':
        backend = 'cuda_seq' if xs.is_cuda else 'torch_scan'
    if backend == 'cuda_step' and xs.is_cuda:
        raise ValueError(_CUDA_STEP_UNMASKED)
    zeros = xs.new_zeros((B, params.n_h))
    h0 = zeros if h0 is None else h0
    c0 = zeros if c0 is None else c0
    if backend == 'cuda_seq':
        from ..kernels.lstm_seq import lstm_layer_seq
        return lstm_layer_seq(params, xs, h0, c0, valid_len=valid_len)
    mask = valid_len_mask(T, valid_len, B)
    return _lstm_scan_masked(params.w_h, params.w_peep, params.b,
                             hoisted_input(params.w_x, xs), h0, c0, mask)


def stack_carry_arrays(states, n_layers: int, batch: int, n_h: int,
                       like: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack per-layer serving carries into (L, B, N_h) kernel arrays.  A
    missing state list, a missing layer entry, or a ``None`` half zeroes
    THAT layer's carry only — the rule the layerwise loop follows, so the
    backends stay interchangeable.  Returns (h0s, c0s) with ``like``'s
    dtype and device."""
    zeros = like.new_zeros((batch, n_h))

    def gather(part):
        def one(l):
            st = None if states is None else states[l]
            v = None if st is None else st[part]
            return zeros if v is None else v
        return torch.stack([one(l) for l in range(n_layers)])

    return gather(0), gather(1)


_CUDA_STEP_UNMASKED = ('cuda_step is not a serving backend on the card: K5 '
                       'has no masked form (serve with cuda_seq or '
                       'cuda_seq_fused)')


def resolve_serving_backend(params: LSTMStackParams, backend: str, T: int,
                            B: int, device, *, masked: bool = True) -> str:
    """Resolve ``backend`` (incl. ``auto``) to the concrete backend a
    ``(T, B, N_x)`` chunked call on ``device`` runs, and check that it is
    admissible there — pure dispatch, no numerics of its own.  ``masked``
    says the call carries a ``valid_len`` (every serving chunk does);
    ``cuda_step`` on CUDA is admissible only unmasked, the training path.
    Raises ``ValueError`` for an explicit backend that is not admissible."""
    from ..kernels.lstm_seq import (seq_geometry, stack_fused_compatible,
                                    stack_geometry)
    if backend not in BACKENDS:
        raise ValueError(f'unknown backend {backend!r}; one of {BACKENDS}')
    device = torch.device(device)
    layers = params.layers
    n_h, L = layers[0].n_h, len(layers)
    compatible = stack_fused_compatible(params)
    if device.type != 'cuda':
        if backend == 'auto':
            return 'torch_scan'
        if backend == 'cuda_seq_fused' and not compatible:
            raise ValueError('cuda_seq_fused needs a homogeneous stack '
                             '(stack_fused_compatible)')
        return backend
    if backend == 'cuda_step' and masked:
        raise ValueError(_CUDA_STEP_UNMASKED)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fused = stack_geometry(n_h, L, B, sms)
    fused_ok = compatible and fused.admissible(sms)
    if backend == 'auto':
        backend = 'cuda_seq_fused' if fused_ok and L >= 2 else 'cuda_seq'
    if backend == 'cuda_seq_fused' and not fused_ok:
        raise ValueError(f'cuda_seq_fused is not admissible: homogeneous '
                         f'stack {compatible}, N_h={n_h}, L={L}, B={B}: '
                         f'{fused}')
    if backend == 'cuda_seq':
        for lp in layers:
            geom = seq_geometry(lp.n_h, B, sms)
            if not geom.admissible(sms):
                raise ValueError(f'cuda_seq is not admissible at '
                                 f'N_h={lp.n_h}, B={B}: {geom}')
    if backend == 'cuda_step':
        from ..kernels.lstm_gates import gates_rec_geometry
        for lp in layers:
            geom = gates_rec_geometry(lp.n_h, B, sms)
            if not geom.admissible():
                raise ValueError(f'cuda_step is not admissible at '
                                 f'N_h={lp.n_h}, B={B}: {geom}')
    return backend


# The reference's cold-cache rule for the int8 stack dispatch
# (``repro.core.lstm``): the wavefront needs at least two layers and a
# sequence long enough to amortise its residency (``_SEQ_MIN_T``), and below
# ``_Q_FUSED_MIN_NH`` hidden units the layerwise chain won in the reference's
# measurements.  The port has no schedule cache yet, so this rule decides.
_SEQ_MIN_T = 8
_Q_FUSED_MIN_NH = 256


def quantized_fused_admissible(n_h: int, n_layers: int, batch: int, device,
                               tile: int) -> bool:
    """True iff K4's launch geometry for this stack fits the card on
    ``device`` (shared memory per CTA within the limit, every CTA
    co-resident at one CTA per SM) — pure dispatch, no numerics."""
    from ..kernels.lstm_seq import stack_q_geometry
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    padded_h = -(-n_h // tile) * tile
    return stack_q_geometry(padded_h, tile, n_layers, batch,
                            sms).admissible(sms)


def select_quantized_stack_backend(n_h: int, n_layers: int, T: int,
                                   batch: int, *, device='cuda',
                                   tile: int = 96) -> str:
    """Int8 stack dispatch: ``'fused'`` (K4, ``lstm_stack_seq_quantized``)
    or ``'layerwise'`` (K3 per layer, ``lstm_layer_seq_quantized``).  Both
    are bit-identical; this picks the launch shape only.  The reference's
    cold-cache rule: ``'layerwise'`` if L < 2 or T < 8, else ``'fused'`` if
    N_h >= 256, else ``'layerwise'``.  On CUDA, ``'fused'`` also needs K4's
    launch geometry at engine tile ``tile`` (the silicon's 96 by default) to
    be admissible (``quantized_fused_admissible``)."""
    if n_layers < 2 or T < _SEQ_MIN_T or n_h < _Q_FUSED_MIN_NH:
        return 'layerwise'
    if (torch.device(device).type == 'cuda' and not
            quantized_fused_admissible(n_h, n_layers, batch, device, tile)):
        return 'layerwise'
    return 'fused'


def lstm_stack_chunk(params: LSTMStackParams, xs: torch.Tensor, states=None,
                     *, valid_len: Optional[torch.Tensor] = None,
                     backend: str = 'auto', stack_weights=None):
    """Stateful chunked stack application — ``lstm_stack_apply`` for
    serving.  One chunk of ``T`` frames through every layer, composing the
    per-layer ``(h, c)`` carries; the same ``valid_len`` masks every layer,
    so chunked output equals the monolithic ``lstm_stack_apply`` on the
    valid prefix (bit-equal on a fixed backend).  xs: (T, B, N_x); states:
    per-layer ``((h, c), ...)`` or None for zeros.  ``cuda_step`` with a
    ``valid_len`` runs the masked torch scan on CPU tensors and raises on
    CUDA tensors (``lstm_layer_chunk``).  On ``cuda_seq_fused``
    the whole chunk runs every layer in one wavefront launch, from
    ``stack_weights`` (``kernels.lstm_seq.stack_kernel_weights(params)``,
    built per call when None; other backends ignore it).  Returns
    (ys (T, B, N_out or N_h), new per-layer states)."""
    T, B = xs.shape[0], xs.shape[1]
    backend = resolve_serving_backend(params, backend, T, B, xs.device,
                                      masked=valid_len is not None)
    if backend == 'cuda_seq_fused':
        from ..kernels.lstm_seq import lstm_stack_seq
        h, finals = lstm_stack_seq(params, xs, states, valid_len=valid_len,
                                   weights=stack_weights)
    else:
        h = xs
        finals = []
        for l, lp in enumerate(params.layers):
            h0c0 = states[l] if states is not None else (None, None)
            h, (h_T, c_T) = lstm_layer_chunk(lp, h, *h0c0,
                                             valid_len=valid_len,
                                             backend=backend)
            finals.append((h_T, c_T))
        finals = tuple(finals)
    if params.w_out is not None:
        h = readout(params.w_out, params.b_out, h)
    return h, finals


def lstm_stack_apply(params: LSTMStackParams, xs: torch.Tensor,
                     states: Optional[Sequence] = None,
                     backend: str = 'auto'):
    """Full network over a whole sequence: stacked layers + the dense
    read-out (logits) — the training path.  xs: (T, B, N_x).  The unmasked
    case of ``lstm_stack_chunk``, and differentiable on every backend:
    layer by layer through ``lstm_layer_fused``, or on ``cuda_seq_fused``
    through one K2 launch under ``kernels.lstm_seq.lstm_stack_seq``'s
    cross-layer gate-recompute backward.  Returns (ys, final per-layer
    states)."""
    return lstm_stack_chunk(params, xs, states, backend=backend)
