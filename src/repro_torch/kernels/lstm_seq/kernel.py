"""K1 and K3 wrappers: the persistent whole-chunk LSTM layer kernels.

``lstm_seq`` (f32, ``csrc/lstm_seq.cu``) and ``lstm_seq_quantized`` (the
int8 silicon datapath, ``csrc/lstm_seq_q.cu``) launch their kernels on CUDA
tensors (a cooperative launch on PyTorch's current stream) and run their
plain versions (``ref``) on CPU tensors; there is no fallback between the
two.  K1-K4 pass their step counters (``step_counters``: one zeroed buffer
per device and stream, which each launch leaves zero) and a scratch for the
h_t planes the CTAs exchange (K1/K2: ``exchange_planes``, k-major f32;
K3/K4: ``q_exchange_planes``, int8 codes on 16-byte rows).  ``seq_geometry`` and
``seq_q_geometry`` are the launch geometries as pure functions of shapes,
which backend selection reads to decide admissibility without touching the
card.

A batch larger than the geometry admits (shared memory grows with B; the
CTA count does not) runs in blocks of the largest admitted B
(``largest_batch``, ``batch_blocks``, ``run_in_blocks``), the counterpart of
the reference kernels' batch-block grid axis: one launch per block on the
current stream, each with its own exchange scratch.  Rows never mix, so a
row of a blocked call has the bits of the same row in one launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import _build
from .ref import lstm_seq_quantized_ref, lstm_seq_ref

SMEM_PER_CTA_MAX = 232_448      # 227 KB: the opt-in limit of one H100 CTA


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """Launch shape of a persistent kernel: ``rows`` hidden rows per CTA,
    ``ctas`` CTAs, ``smem_bytes`` dynamic shared memory per CTA."""
    rows: int
    ctas: int
    smem_bytes: int

    def admissible(self, max_coresident: Optional[int] = None) -> bool:
        """True iff one CTA's shared memory fits the card's limit and all
        CTAs can be resident at once (a grid barrier needs both).
        Selection passes the SM count (one CTA per SM); a cooperative
        launch passes the occupancy the CUDA runtime reports; a plain launch
        (K5) passes nothing, and only shared memory is checked."""
        return (self.smem_bytes <= SMEM_PER_CTA_MAX
                and (max_coresident is None or self.ctas <= max_coresident))


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def largest_batch(geometry: Callable[[int], LaunchGeometry], batch: int,
                  max_coresident: Optional[int] = None) -> int:
    """The largest b <= ``batch`` whose ``geometry(b)`` is admissible, or 0
    when not even b = 1 is (the launch fails for a reason other than B).
    Admissibility only falls as b grows (shared memory grows with it, the
    CTA count does not), so a bisection finds it."""
    if geometry(batch).admissible(max_coresident):
        return batch
    if not geometry(1).admissible(max_coresident):
        return 0
    lo, hi = 1, batch - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if geometry(mid).admissible(max_coresident):
            lo = mid
        else:
            hi = mid - 1
    return lo


def batch_blocks(batch: int, block: int) -> List[Tuple[int, int]]:
    """Row ranges ``(lo, hi)`` of blocks of at most ``block`` streams that
    cover ``range(batch)`` once, in order."""
    if block < 1:
        raise ValueError(f'a batch block needs at least one stream, got '
                         f'{block}')
    return [(lo, min(lo + block, batch)) for lo in range(0, batch, block)]


def run_in_blocks(launch: Callable, block: int, ins: Sequence,
                  in_dims: Sequence[Optional[int]], outs: Sequence,
                  out_dims: Sequence[int]) -> None:
    """Call ``launch(ins, outs)`` once per batch block of at most ``block``
    streams.  ``in_dims`` / ``out_dims`` give each tensor's batch axis
    (None: not batched, passed whole).  A single block passes the tensors
    themselves; otherwise each block gets contiguous copies of its input
    rows and fresh outputs, which are copied into its rows of ``outs``
    after its launch, all on the current stream."""
    batch = outs[0].shape[out_dims[0]]
    blocks = batch_blocks(batch, block)
    if len(blocks) == 1:
        launch(list(ins), list(outs))
        return
    for lo, hi in blocks:
        rows = lambda x, d: x.narrow(d, lo, hi - lo)
        ins_b = [x if d is None else rows(x, d).contiguous()
                 for x, d in zip(ins, in_dims)]
        outs_b = [torch.empty(rows(o, d).shape, dtype=o.dtype,
                              device=o.device)
                  for o, d in zip(outs, out_dims)]
        launch(ins_b, outs_b)
        for o, ob, d in zip(outs, outs_b, out_dims):
            rows(o, d).copy_(ob)


def seq_splits(rows: int) -> int:
    """Warps that split K for one row in K1/K2's dot (``Layout.splits``)."""
    return 8 // rows if rows < 8 else 1


def seq_threads(rows: int, splits: Optional[int] = None) -> int:
    """Threads of one K1/K2 CTA: a producer warp, then ``rows * splits``
    dot warps, at most 16 (``splits`` defaults to ``seq_splits(rows)``)."""
    splits = seq_splits(rows) if splits is None else splits
    return 32 * (1 + min(16, rows * splits))


def seq_smem_bytes(batch: int, n_h: int, rows: int, families: int,
                   splits: Optional[int] = None) -> int:
    """Shared memory of one K1 (``families`` 1: W_h) or K2 CTA (2: W_h and
    W_in), the formula of ``layout`` in ``csrc/lstm_exchange.cuh``: two
    mbarriers (a 128-byte line); a family's h plane (N_h x 8 streams a
    chunk of 8, to a 128-byte boundary), weight rows (``rows`` x N_h x 4
    gates) and gate sums of every chunk and K split (``splits``, default
    ``seq_splits(rows)``); peep and bias, c, the step's pre_x rows and its
    mask row."""
    chunks = -(-batch // 8)
    splits = seq_splits(rows) if splits is None else splits
    return (128 + families * (_round_up(32 * chunks * n_h, 128)
                              + 16 * rows * n_h
                              + 4 * chunks * splits * rows * 32)
            + 4 * (8 * rows + rows * batch + 4 * rows * batch)
            + _round_up(batch + 8, 16))


def exchange_planes(n_layers: int, steps: int, batch: int, n_h: int,
                    device) -> torch.Tensor:
    """K1/K2's scratch for h_t k-major, what later steps stage: (L, T,
    ceil(B / 8), N_h, 8) floats, from PyTorch's caching allocator (no
    launch)."""
    return torch.empty((n_layers, steps, -(-batch // 8), n_h, 8),
                       dtype=torch.float32, device=device)


def seq_geometry(n_h: int, batch: int, sm_count: int) -> LaunchGeometry:
    """K1's geometry: R = ceil(N_h / SMs) rows per CTA, one CTA per row
    slice (``seq_smem_bytes`` with one weight family)."""
    rows = max(1, -(-n_h // sm_count))
    ctas = -(-n_h // rows)
    return LaunchGeometry(rows, ctas, seq_smem_bytes(batch, n_h, rows, 1))


# (device index, stream) -> K1/K2's int32 step counters (a progress counter
# per layer, then ``done``, each on its own 128-byte line); zero between
# launches (the last CTA of each launch resets them)
_COUNTERS: dict = {}
COUNTER_STRIDE = 32   # ``kCounterStride``


def step_counters(dev: torch.device, stream: int, n_layers: int
                  ) -> torch.Tensor:
    """Zero step counters for a launch of ``n_layers`` layers on
    ``stream``, allocated (and zeroed) only when the stream's buffer is
    missing or too short: launches on one stream run one after another and
    leave them zero, launches on two streams never share them."""
    n = (n_layers + 1) * COUNTER_STRIDE
    t = _COUNTERS.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = _COUNTERS[(dev.index, stream)] = torch.zeros(
            n, dtype=torch.int32, device=dev)
    return t


_P, _I = _build.P, _build.I
_SIGNATURES = {
    'lstm_seq_occupancy': [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
    'lstm_seq_launch': [_I] + [_P] * 11 + [_I] * 4 + [_P],
}


def check_inputs(named, shapes, device, dtypes=None) -> None:
    """Raise ``ValueError`` unless every tensor has its expected shape, lies
    on ``device``, is contiguous and has its dtype (``dtypes[name]``, else
    f32, the mask bool)."""
    for name, x in named.items():
        want_dtype = (dtypes[name] if dtypes and name in dtypes else
                      torch.bool if name == 'mask' else torch.float32)
        if tuple(x.shape) != tuple(shapes[name]):
            raise ValueError(f'{name}: shape {tuple(x.shape)}, expected '
                             f'{tuple(shapes[name])}')
        if x.device != device:
            raise ValueError(f'{name} is on {x.device}, expected {device}')
        if x.dtype != want_dtype:
            raise ValueError(f'{name}: dtype {x.dtype}, expected {want_dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


# (occupancy function, device index, shape ints, rows) -> co-resident CTAs;
# a property of the card and the compiled kernel, asked once per shape
_CORESIDENT = {}


def coresident_ctas(lib, occupancy_fn: str, device: torch.device,
                    geom: LaunchGeometry, *shape: int) -> int:
    """CTAs the card can hold at once for ``geom`` (blocks per SM from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` times the SMs).  The
    occupancy function takes ``(device, *shape, rows, &blocks)``."""
    key = (occupancy_fn, device.index, shape, geom.rows)
    if key not in _CORESIDENT:
        blocks = ctypes.c_int(0)
        _build.check(lib, getattr(lib, occupancy_fn)(
            device.index, *shape, geom.rows, ctypes.byref(blocks)),
            occupancy_fn)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _CORESIDENT[key] = blocks.value * sms
    return _CORESIDENT[key]


def seq_launch_cost(T: int, B: int, N: int, layers: int, weights: int,
                    first: bool = True):
    """(FLOPs, bytes, dtype) of one unmasked f32 K1 (``layers`` 1) or K2
    launch from its geometry, as ``chip_smoke.py``'s bound column reckons
    it: bytes every input read and every output written once (``weights``
    recurrent and inter-layer matrix elements), FLOPs every step's
    products (2L - 1 matrix families) and epilogues.  A K2 launch of a
    layer group above layer 0 (not ``first``) reads the h_t of the layer
    below it in place of ``pre_x`` and sums 2L families."""
    families = 2 * layers - (1 if first else 0)
    nbytes = 4 * (T * B * N * (4 if first else 1) + weights
                  + layers * (7 * N + 2 * B * N + 2 * T * B * N)) + T * B
    flops = T * B * (families * 2 * 4 * N * N + layers * 30 * N)
    return float(flops), float(nbytes), torch.float32


@torch.library.custom_op('repro_torch::lstm_seq', mutates_args=())
def lstm_seq_plain(pre_x: torch.Tensor, w_h: torch.Tensor,
                   peep: torch.Tensor, bias: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lstm_seq`` on CPU tensors, the op ``repro_torch::lstm_seq``: the
    plain version, and under fake tensors outputs of its shapes (a cost
    model charges the op by its launch geometry, ``seq_launch_cost``)."""
    return lstm_seq_ref(pre_x, w_h, peep, bias, h0, c0, mask)


@lstm_seq_plain.register_fake
def _(pre_x, w_h, peep, bias, h0, c0, mask):
    T, B, _, N = pre_x.shape
    return pre_x.new_empty((T, B, N)), pre_x.new_empty((T, B, N))


def lstm_seq(pre_x: torch.Tensor, w_h: torch.Tensor, peep: torch.Tensor,
             bias: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
             mask: torch.Tensor = None):
    """Whole-chunk masked peephole LSTM layer.

    pre_x: (T, B, 4, N_h) hoisted ``W_x @ x_t``; w_h: (4, N_h, N_h); peep:
    (3, N_h); bias: (4, N_h); h0, c0: (B, N_h); mask: (T, B) bool (None =
    every step live).  A masked step re-emits the carried h and keeps c.
    Returns (hs, cs), each (T, B, N_h).  CPU tensors run the plain version;
    CUDA tensors launch the kernel and count it in ``lstm_seq.launches``.
    """
    T, B, _, N = pre_x.shape
    if mask is None:
        mask = torch.ones((T, B), dtype=torch.bool, device=pre_x.device)
    if pre_x.device.type == 'cpu':
        return lstm_seq_plain(pre_x, w_h, peep, bias, h0, c0, mask)
    if pre_x.device.type != 'cuda':
        raise ValueError(f'lstm_seq runs on cuda or cpu, not {pre_x.device}')
    device = pre_x.device
    check_inputs(dict(pre_x=pre_x, w_h=w_h, peep=peep, bias=bias, h0=h0,
                      c0=c0, mask=mask),
                 dict(pre_x=(T, B, 4, N), w_h=(4, N, N), peep=(3, N),
                      bias=(4, N), h0=(B, N), c0=(B, N), mask=(T, B)),
                 device)
    hs = torch.empty((T, B, N), dtype=torch.float32, device=device)
    cs = torch.empty_like(hs)
    lib = _build.load('lstm_seq', _SIGNATURES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    block = largest_batch(lambda b: seq_geometry(N, b, sms), B, sms)
    geom = seq_geometry(N, max(block, 1), sms)
    if not block or not geom.admissible(coresident_ctas(
            lib, 'lstm_seq_occupancy', device, geom, block, N)):
        raise RuntimeError(f'lstm_seq: launch geometry {geom} does not fit '
                           f'the card (N_h={N}, B={B})')
    stream = torch.cuda.current_stream(device).cuda_stream
    counters = step_counters(device, stream, 1)

    def launch(ins, outs):
        pre_b, h0_b, c0_b, mask_b = ins
        b = mask_b.shape[1]
        # held until the launch is queued: freed earlier, its block could
        # become the stream's new counters
        xs = exchange_planes(1, T, b, N, device)
        err = lib.lstm_seq_launch(
            device.index, pre_b.data_ptr(), w_h.data_ptr(), peep.data_ptr(),
            bias.data_ptr(), h0_b.data_ptr(), c0_b.data_ptr(),
            mask_b.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
            xs.data_ptr(), counters.data_ptr(), T, b, N, geom.rows, stream)
        _build.check(lib, err, 'lstm_seq launch')
        lstm_seq.launches += 1

    run_in_blocks(launch, block, (pre_x, h0, c0, mask), (1, 0, 0, 1),
                  (hs, cs), (1, 1))
    return hs, cs


lstm_seq.launches = 0


# ---------------------------------------------------------------------------
# K3: the int8 silicon datapath, one layer
# ---------------------------------------------------------------------------

def check_tile(tile: int) -> None:
    """The int8 kernels read a tile's codes as whole 4-byte words."""
    if tile % 4:
        raise ValueError(f'the int8 kernels need a tile that is a multiple '
                         f'of 4, got {tile}')


Q_GROUP = 8          # hidden rows of a row group (``kGroup``)
Q_CHUNK = 8          # streams of an n8 chunk (``kChunk``)
Q_MAX_DOT_WARPS = 8  # ``kMaxDotWarps``


def q_row_stride(nbytes: int) -> int:
    """K3/K4's shared-memory row stride for ``nbytes`` of a row: an odd
    multiple of 16 bytes (``row_stride`` in ``csrc/lstm_q_epilogue.cuh``),
    so a fragment load's 8 rows fall in 8 distinct bank groups."""
    return _round_up(nbytes, 32) + 16


def q_dot_warps(rows: int, batch: int) -> int:
    """K3/K4's dot warps: a pair a (row group, 8-stream chunk) task, one
    m-tile (two gates) each, at most 8."""
    return min(Q_MAX_DOT_WARPS, 2 * (rows // Q_GROUP) * -(-batch // Q_CHUNK))


def q_threads(rows: int, batch: int) -> int:
    """Threads of one K3/K4 CTA: the dot warps, then a producer warp."""
    return 32 * (1 + q_dot_warps(rows, batch))


def q_smem_bytes(batch: int, padded_h: int, tile: int, rows: int,
                 cols: int, families: int, planes: int, padded_x: int = 0,
                 prefix: bool = False) -> int:
    """Shared memory of one K3 (``families`` 1 of ``cols`` = cols_x +
    cols_h column tiles, ``planes`` 1, two steps' x planes of
    ``padded_x``) or K4 CTA (2 families of cols_h tiles, 2 planes, no x
    plane, layer 0's acc_x ``prefix``), the formula of ``layout`` in
    ``csrc/lstm_q_epilogue.cuh``: two mbarriers (a 128-byte line); each h
    plane (streams rounded up to 8, at ``q_row_stride(padded_h)``, 32 bytes
    of slack, to a 128-byte line); the x planes the same way; each family's
    4 * ``rows`` weight rows (every column tile padded to a multiple of 32
    k, at ``q_row_stride``); an 8-byte hop chain per lane, task and
    m-tile; K4: two steps' 4 int32 of prefix per lane, task and m-tile; two
    rounds of 8 bytes per lane of each dot warp, which a pair trades; c
    codes, bias (int16) and peep of the rows; two mask rows; both LUTs."""
    chunks = -(-batch // Q_CHUNK)
    plane = lambda n: _round_up(Q_CHUNK * chunks * q_row_stride(n) + 32, 128)
    return (128 + planes * plane(padded_h)
            + (2 * plane(padded_x) if padded_x else 0)
            + families * 4 * rows * q_row_stride(cols * _round_up(tile, 32))
            + (80 if prefix else 16) * 32 * (rows // Q_GROUP) * chunks
            + 16 * 32 * q_dot_warps(rows, batch)
            + _round_up(rows * Q_CHUNK * chunks, 16) + _round_up(11 * rows, 16)
            + 2 * _round_up(Q_CHUNK * chunks, 16) + 512)


def q_exchange_planes(n_layers: int, steps: int, batch: int, padded_h: int,
                      device) -> torch.Tensor:
    """K3/K4's scratch for h_t, what later steps stage by one bulk copy:
    (L, T, B, ``q_row_stride(padded_h)``) int8 codes (16-byte rows, whatever
    padded_h), from PyTorch's caching allocator (no launch)."""
    return torch.empty((n_layers, steps, batch, q_row_stride(padded_h)),
                       dtype=torch.int8, device=device)


def word_aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its data is not 4-byte aligned (a view at
    an odd offset): the int8 kernels read codes and weights as words."""
    return x if x.data_ptr() % 4 == 0 else x.clone()


def seq_q_geometry(padded_x: int, padded_h: int, tile: int, batch: int,
                   sm_count: int) -> LaunchGeometry:
    """K3's geometry: row groups of 8 of the padded_h rows, R = 8 *
    ceil(groups / SMs) rows per CTA (one row group, 60 CTAs at full
    width), one CTA per row slice; shared memory as ``q_smem_bytes`` with
    one family of every column tile and one h plane."""
    groups = -(-padded_h // Q_GROUP)
    rows = Q_GROUP * -(-groups // sm_count)
    ctas = -(-padded_h // rows)
    return LaunchGeometry(rows, ctas, q_smem_bytes(
        batch, padded_h, tile, rows, (padded_x + padded_h) // tile, 1, 1,
        padded_x))


_SIGNATURES_Q = {
    'lstm_seq_q_occupancy': [_I] * 6 + [ctypes.POINTER(ctypes.c_int)],
    'lstm_seq_q_launch': [_I] + [_P] * 13 + [_I] * 6 + [_P],
}


def lstm_seq_quantized(xs_q: torch.Tensor, w_q: torch.Tensor,
                       peep_q: torch.Tensor, bias_q: torch.Tensor,
                       sig_lut: torch.Tensor, tanh_lut: torch.Tensor,
                       h0_q: torch.Tensor = None, c0_q: torch.Tensor = None,
                       mask: torch.Tensor = None, *, tile: int, cols_x: int):
    """Whole-chunk bit-accurate int8 LSTM layer (the silicon datapath).

    xs_q: (T, B, padded_x) int8 frame codes; w_q: (4, padded_h, padded_in)
    int8 dense engine-tile layout (``[W_x | W_h]``, the x-region padded to
    whole tiles); peep_q: (3, padded_h) int8; bias_q: (4, padded_h) int16 in
    ACC_FMT; sig_lut, tanh_lut: (256,) int8; h0_q, c0_q: (B, padded_h) int8
    carried codes (None = zero); mask: (T, B) bool (None = every step live;
    a masked step re-emits the carried h codes and keeps c).  Returns (hs,
    cs), each (T, B, padded_h) int8, bit-identical to scanning
    ``core.systolic.systolic_cell_quantized``.  CPU tensors run the plain
    version; CUDA tensors launch the kernel and count it in
    ``lstm_seq_quantized.launches``.
    """
    T, B, p_x = xs_q.shape
    _, p_h, p_in = w_q.shape
    if p_x != cols_x * tile or p_in != p_x + p_h or p_h % tile:
        raise ValueError(f'lstm_seq_quantized: padded_x={p_x}, '
                         f'w_q {tuple(w_q.shape)} do not fit tile={tile}, '
                         f'cols_x={cols_x}')
    dev = xs_q.device
    zeros = lambda: torch.zeros((B, p_h), dtype=torch.int8, device=dev)
    h0_q = zeros() if h0_q is None else h0_q
    c0_q = zeros() if c0_q is None else c0_q
    if mask is None:
        mask = torch.ones((T, B), dtype=torch.bool, device=dev)
    args = (xs_q, w_q, peep_q, bias_q, sig_lut, tanh_lut, h0_q, c0_q, mask)
    if dev.type == 'cpu':
        return lstm_seq_quantized_ref(*args, tile=tile, cols_x=cols_x)
    if dev.type != 'cuda':
        raise ValueError(f'lstm_seq_quantized runs on cuda or cpu, not {dev}')
    check_tile(tile)
    i8, i16 = torch.int8, torch.int16
    check_inputs(dict(xs_q=xs_q, w_q=w_q, peep_q=peep_q, bias_q=bias_q,
                      sig_lut=sig_lut, tanh_lut=tanh_lut, h0_q=h0_q,
                      c0_q=c0_q, mask=mask),
                 dict(xs_q=(T, B, p_x), w_q=(4, p_h, p_in), peep_q=(3, p_h),
                      bias_q=(4, p_h), sig_lut=(256,), tanh_lut=(256,),
                      h0_q=(B, p_h), c0_q=(B, p_h), mask=(T, B)),
                 dev, dict(xs_q=i8, w_q=i8, peep_q=i8, bias_q=i16,
                           sig_lut=i8, tanh_lut=i8, h0_q=i8, c0_q=i8))
    hs = torch.empty((T, B, p_h), dtype=torch.int8, device=dev)
    cs = torch.empty_like(hs)
    lib = _build.load('lstm_seq_q', _SIGNATURES_Q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block = largest_batch(
        lambda b: seq_q_geometry(p_x, p_h, tile, b, sms), B, sms)
    geom = seq_q_geometry(p_x, p_h, tile, max(block, 1), sms)
    if not block or not geom.admissible(coresident_ctas(
            lib, 'lstm_seq_q_occupancy', dev, geom, block, p_x, p_h, tile)):
        raise RuntimeError(f'lstm_seq_quantized: launch geometry {geom} does '
                           f'not fit the card (padded_h={p_h}, B={B})')
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = step_counters(dev, stream, 1)
    w_w = word_aligned(w_q)

    def launch(ins, outs):
        xs_b, h0_b, c0_b, mask_b = ins
        b = mask_b.shape[1]
        # held until the launch is queued: freed earlier, a block could
        # become the stream's new counters
        xs_w = word_aligned(xs_b)
        xch = q_exchange_planes(1, T, b, p_h, dev)
        err = lib.lstm_seq_q_launch(
            dev.index, xs_w.data_ptr(), w_w.data_ptr(), peep_q.data_ptr(),
            bias_q.data_ptr(), sig_lut.data_ptr(), tanh_lut.data_ptr(),
            h0_b.data_ptr(), c0_b.data_ptr(), mask_b.data_ptr(),
            outs[0].data_ptr(), outs[1].data_ptr(), xch.data_ptr(),
            counters.data_ptr(), T, b, p_x, p_h, tile, geom.rows, stream)
        _build.check(lib, err, 'lstm_seq_quantized launch')
        lstm_seq_quantized.launches += 1

    run_in_blocks(launch, block, (xs_q, h0_q, c0_q, mask), (1, 0, 0, 1),
                  (hs, cs), (1, 1))
    return hs, cs


lstm_seq_quantized.launches = 0
