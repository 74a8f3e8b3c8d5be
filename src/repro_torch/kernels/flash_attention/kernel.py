"""K8 wrapper: blockwise online-softmax attention on the card.

``flash_attention`` launches ``csrc/flash_attention.cu`` on CUDA tensors (a
plain launch on PyTorch's current stream) and runs its plain version
(``ref.attention_ref``) on CPU tensors; there is no fallback between the
two.  Any Sq and Sk (no padding to blocks), D <= 128, f32 or bf16.

``attention_geometry`` picks the kernel's schedule, one launch either way:
``tiled`` (one CTA per (batch x head, 64- or 128-row query tile); bf16 on
the tensor cores, f32 on the CUDA cores) or ``split`` (flash-decoding: one CTA
per (kv head, key range), every query head of the group in it, the
partials merged by the last CTA of each kv head, which also sets its
ticket back to 0, so one zeroed ticket buffer per device and stream serves
every split launch).

Training: ``return_lse=True`` also returns each row's log-sum-exp (f32,
(B, H, Sq); NEG_INF where a row sees no key), written by the tiled
schedules, so such a call never takes the split one.  The backward that
reads it is ``backward.flash_attention_bwd``; ``attention_bwd_geometry``
is its launch rule (tiles, the GQA group split of ``kv_kernel``, the
heaviest-first order).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple, Union

import torch

from .. import _build
from ..lstm_seq.kernel import check_inputs
from .ref import attention_ref, live_key_range

D_MAX = 128
POS_MAX = 1 << 28     # |positions| stay below 2 POS_MAX: int32 never wraps

_P, _I = _build.P, _build.I
_SIGNATURES = {'flash_attention_launch': [_I] + [_P] * 4 + [_I] * 6
               + [ctypes.c_float] + [_I] * 12 + [_P] * 6}
_DTYPES = (torch.float32, torch.bfloat16)

TILE_ROWS = 64     # query rows of one tiled CTA (the finest tile)
WIDE_ROWS = 128    # bf16 tiled CTAs, where the grid still fills the card
SPLIT_ROWS = 32    # packed rows (query rows x GQA group) of one split CTA
SPLIT_KEYS = 64    # a split covers whole multiples of these keys
SPLIT_MAX = 64     # splits per kv head (the merge keeps a weight for each)

# (device index, stream) -> the split schedule's int32 tickets, one per
# (batch, kv head); zero between launches (the kernel resets each one)
_TICKETS: dict = {}


def _tickets(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero tickets for launches on ``stream``, allocated
    (and zeroed) only when the stream's buffer is missing or too short."""
    t = _TICKETS.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[(dev.index, stream)] = torch.zeros(
            n, dtype=torch.int32, device=dev)
    return t


@dataclasses.dataclass(frozen=True)
class AttentionGeometry:
    """The schedule of one K8 launch.  ``split``: grid (n_splits, B *
    Hkv); split s covers keys [key_lo + s * split_keys, min(key_hi, ...))."""
    path: str            # 'tiled' or 'split'
    ctas: int
    tile_rows: int = TILE_ROWS   # query rows of a tiled CTA
    n_splits: int = 0
    key_lo: int = 0
    key_hi: int = 0
    split_keys: int = 0


def attention_geometry(B: int, H: int, Hkv: int, Sq: int, Sk: int,
                       window: Optional[int], kv_len: Optional[int],
                       offset: int, D: int, sms: int, *,
                       causal: bool = True, wide: bool = True,
                       split: bool = True) -> AttentionGeometry:
    """Pure rule: ``split`` when the tiled grid would fill fewer CTAs than
    the card has SMs and one CTA holds every packed row (Sq x H / Hkv <=
    ``SPLIT_ROWS``), else ``tiled``.  The split cuts the live key range
    (``live_key_range``: after the window, causality and kv_len) into whole
    ``SPLIT_KEYS`` tiles, up to two CTAs an SM (each holds under half an
    SM's shared memory), so at least ``sms`` CTAs when there are keys
    enough, and at most ``SPLIT_MAX`` splits per kv head.  D does not enter
    the rule (every D <= 128 has both schedules).  A tiled CTA takes
    ``WIDE_ROWS`` query rows where ``wide`` (the bf16 tensor-core kernel
    has both widths) and that grid still gives every SM two CTAs, else
    ``TILE_ROWS``.  ``split=False`` (a training call, which needs the
    log-sum-exp only the tiled schedules write) always takes ``tiled``."""
    del D
    tiled = -(-Sq // TILE_ROWS) * B * H
    if not split or tiled >= sms or Sq * (H // Hkv) > SPLIT_ROWS:
        wide_ctas = -(-Sq // WIDE_ROWS) * B * H
        if wide and wide_ctas >= 2 * sms:
            return AttentionGeometry('tiled', wide_ctas, WIDE_ROWS)
        return AttentionGeometry('tiled', tiled)
    lo, hi = live_key_range(Sq, Sk, causal=causal, window=window,
                            kv_len=kv_len, offset=offset)
    tiles = -(-(hi - lo) // SPLIT_KEYS)
    want = -(-2 * sms // (B * Hkv))             # two CTAs an SM fit
    per = max(1, -(-tiles // want), -(-tiles // SPLIT_MAX))   # tiles a split
    n_splits = max(1, -(-tiles // per))
    return AttentionGeometry('split', n_splits * B * Hkv, TILE_ROWS,
                             n_splits, lo, hi, per * SPLIT_KEYS)


def _row_ranges(Sq: int, Sk: int, offset: int, causal: bool,
                window: Optional[int], kv_len: Optional[int]):
    """(lo, hi) numpy arrays: query row i sees keys [lo[i], hi[i])."""
    import numpy as np
    pos = np.arange(Sq, dtype=np.int64) + offset
    kv = Sk if kv_len is None else max(0, min(Sk, kv_len))
    hi = np.minimum(kv, pos + 1) if causal else np.full(Sq, kv, np.int64)
    lo = (np.zeros(Sq, np.int64) if window is None
          else np.maximum(0, pos - window + 1))
    return lo, np.maximum(hi, lo)


def live_tile_area(Sq: int, Sk: int, rows: int, keys: int, offset: int,
                   causal: bool, window: Optional[int],
                   kv_len: Optional[int] = None) -> int:
    """Query x key elements of the (query tile of ``rows``, key tile of
    ``keys``) pairs that hold at least one valid pair: the work of a tiled
    schedule that skips dead tiles (each tile clipped to Sq, Sk)."""
    import numpy as np
    lo, hi = _row_ranges(Sq, Sk, offset, causal, window, kv_len)
    area = 0
    for r0 in range(0, Sq, rows):
        l, h = lo[r0:r0 + rows], hi[r0:r0 + rows]
        live = h > l
        if not live.any():
            continue
        k0 = int(l[live].min()) // keys * keys
        k1 = min(Sk, -(-int(h[live].max()) // keys) * keys)
        area += len(l) * (k1 - k0)
    return int(area)


def attention_cost(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
                   dtype: torch.dtype, *, causal: bool, window, kv_len,
                   offset: int, return_lse: bool, sms: int):
    """(FLOPs, bytes, dtype) of one K8 launch by its geometry
    (``attention_geometry``): FLOPs 4 D a (query, key) element of the
    tiles the schedule computes (the tiled schedule's live 64-key tiles
    of each query tile; every packed row against the split's key range);
    bytes q, the keys any query sees and the output (and lse) once."""
    geom = attention_geometry(B, H, Hkv, Sq, Sk, window, kv_len, offset, D,
                              sms, causal=causal,
                              wide=dtype == torch.bfloat16,
                              split=not return_lse)
    if geom.path == 'split':
        area = Sq * (geom.key_hi - geom.key_lo)
    else:
        area = live_tile_area(Sq, Sk, geom.tile_rows, 64, offset, causal,
                              window, kv_len)
    lo, hi = _row_ranges(Sq, Sk, offset, causal, window, kv_len)
    live = hi > lo
    keys = int(hi[live].max() - lo[live].min()) if live.any() else 0
    es = torch.finfo(dtype).bits // 8
    nbytes = es * (2 * B * H * Sq * D + 2 * B * Hkv * keys * D) + (
        4 * B * H * Sq if return_lse else 0)
    return float(4 * D * area * B * H), float(nbytes), dtype


def attention_bwd_cost(which: str, B: int, H: int, Hkv: int, Sq: int,
                       Sk: int, D: int, dtype: torch.dtype, *, causal: bool,
                       window, offset: int, sms: int):
    """(FLOPs, bytes, dtype) of one launch of K8's backward ``kv`` (dk,
    dv: 8 D a computed element) or ``q`` kernel (dq: 6 D), by the tiles of
    ``attention_bwd_geometry``; bytes as ``chip_smoke.py`` reckons them."""
    g = attention_bwd_geometry(B, H, Hkv, Sq, Sk, D, dtype, window, offset,
                               sms, causal=causal)
    if which == 'kv':
        area = live_tile_area(Sq, Sk, g.kv_rows, g.kv_keys, offset, causal,
                              window)
    else:
        area = live_tile_area(Sq, Sk, g.q_rows, g.q_keys, offset, causal,
                              window)
    lo, hi = _row_ranges(Sq, Sk, offset, causal, window, None)
    live = hi > lo
    keys = int(hi[live].max() - lo[live].min()) if live.any() else 0
    es = torch.finfo(dtype).bits // 8
    n_q, n_kv, rows = B * H * Sq * D, B * Hkv, B * H * Sq
    if which == 'kv':
        nbytes = es * (2 * n_q + 4 * n_kv * keys * D) + 8 * rows
        per = 8
    else:
        nbytes = es * (3 * n_q + 2 * n_kv * keys * D) + 8 * rows
        per = 6
    return float(per * D * area * B * H), float(nbytes), dtype


BWD_WARPS = 4              # warps a CTA of either backward kernel
BWD_ROWS = 16 * BWD_WARPS  # keys a kv_kernel CTA, query rows a q_kernel CTA
BWD_TILES_MAX = 65535      # tiles of either grid (its y axis)


@dataclasses.dataclass(frozen=True)
class AttentionBwdGeometry:
    """The schedule of one call of K8's backward pair
    (``csrc/flash_attention_bwd.cu``).  ``kv_kernel``: grid (B * Hkv *
    ``kv_split``, ``kv_tiles``), a CTA ``kv_keys`` keys and query tiles of
    ``kv_rows`` streamed through it; ``q_kernel``: grid (B * H,
    ``q_tiles``), a CTA ``q_rows`` query rows and key tiles of ``q_keys``.
    ``*_reverse``: the grid walks its rows from the last (``tile_ranges``;
    ``kv_ranges`` and ``q_ranges`` give each grid's rows in launch
    order)."""
    d_tile: int          # D padded to 32, 64 or 128
    warps: int           # warps a CTA of either kernel, 16 rows each
    kv_keys: int
    kv_rows: int
    kv_tiles: int
    kv_split: int        # CTAs a (kv head, key tile): 1 or the GQA group
    kv_ctas: int
    kv_reverse: bool
    q_rows: int
    q_keys: int
    q_tiles: int
    q_ctas: int
    q_reverse: bool

    def kv_ranges(self, Sk: int) -> Tuple[Tuple[int, int], ...]:
        """The keys [lo, hi) of each ``kv_kernel`` CTA, in launch order."""
        return tile_ranges(Sk, self.kv_keys, self.kv_reverse)

    def q_ranges(self, Sq: int) -> Tuple[Tuple[int, int], ...]:
        """The query rows [lo, hi) of each ``q_kernel`` CTA, in launch
        order."""
        return tile_ranges(Sq, self.q_rows, self.q_reverse)


def tile_ranges(n: int, rows: int, reverse: bool
                ) -> Tuple[Tuple[int, int], ...]:
    """Rows [0, n) in tiles of ``rows``, as the backward kernels walk their
    grid: from row 0, or where ``reverse`` from row n (tiles end at n,
    n - rows, ...; a ragged tile, if any, comes last and starts at 0)."""
    tiles = -(-n // rows)
    if reverse:
        return tuple((max(0, n - (i + 1) * rows), n - i * rows)
                     for i in range(tiles))
    return tuple((i * rows, min(n, (i + 1) * rows)) for i in range(tiles))


def bwd_key_pairs(j: int, Sq: int, offset: int, causal: bool,
                  window: Optional[int]) -> int:
    """Valid (query, key) pairs of key j: the query rows that see it."""
    lo = max(0, j - offset) if causal else 0
    hi = Sq if window is None else min(Sq, j - offset + window)
    return max(0, hi - lo)


def bwd_row_pairs(i: int, Sk: int, offset: int, causal: bool,
                  window: Optional[int]) -> int:
    """Valid (query, key) pairs of query row i: the keys it sees."""
    pos = i + offset
    hi = min(Sk, pos + 1) if causal else Sk
    lo = 0 if window is None else max(0, pos - window + 1)
    return max(0, hi - lo)


def _heavier_last(pairs, n: int) -> bool:
    """Whether the last ``BWD_ROWS`` of n rows have more valid pairs than
    the first."""
    first = sum(pairs(i) for i in range(min(n, BWD_ROWS)))
    return sum(pairs(i) for i in range(max(0, n - BWD_ROWS), n)) > first


def attention_bwd_geometry(B: int, H: int, Hkv: int, Sq: int, Sk: int,
                           D: int, dtype: torch.dtype,
                           window: Optional[int], offset: int, sms: int, *,
                           causal: bool = True,
                           split: Optional[bool] = None
                           ) -> AttentionBwdGeometry:
    """Pure rule for K8's backward pair.  Tiles: ``BWD_WARPS`` warps a CTA
    of either kernel, 16 rows a warp (``BWD_ROWS`` keys a ``kv_kernel``
    CTA, as many query rows a ``q_kernel`` CTA).  In bf16 ``kv_kernel``
    streams query tiles of 64 rows where D <= 64 and 32 at D 128 (so that
    dK and dV, 128 f32 registers a thread at D 128, leave room for the
    scores), ``q_kernel`` key tiles of 64; in f32 both stream tiles of 32
    (each is held twice, as its tf32 big and small parts, and two CTAs
    still fit an SM).  The split: where
    B * Hkv * key tiles gives fewer than two CTAs an SM and the GQA group
    is larger than 1, ``kv_kernel``'s grid gains the query head of the
    group (``kv_split`` = the group; the kernel sums the heads' partials in
    head order); ``split`` forces it on or off (for tests).  Order:
    heaviest first, each grid walks its rows from the end whose first tile
    has more valid pairs (``tile_ranges``: from the first key and from the
    last query row under a causal mask)."""
    if dtype not in _DTYPES:
        raise ValueError(f'attention_bwd_geometry: dtype {dtype}, expected '
                         f'one of {_DTYPES}')
    if D > D_MAX:
        raise ValueError(f'attention_bwd_geometry: D={D} above {D_MAX}')
    d_tile = 32 if D <= 32 else 64 if D <= 64 else 128
    f32 = dtype == torch.float32
    group = H // Hkv
    kv_tiles, q_tiles = -(-Sk // BWD_ROWS), -(-Sq // BWD_ROWS)
    if split is None:
        split = group > 1 and B * Hkv * kv_tiles < 2 * sms
    kv_split = group if split else 1
    key = lambda j: bwd_key_pairs(j, Sq, offset, causal, window)
    row = lambda i: bwd_row_pairs(i, Sk, offset, causal, window)
    kv_reverse = kv_tiles > 1 and _heavier_last(key, Sk)
    q_reverse = q_tiles > 1 and _heavier_last(row, Sq)
    return AttentionBwdGeometry(
        d_tile=d_tile, warps=BWD_WARPS, kv_keys=BWD_ROWS,
        kv_rows=32 if f32 or d_tile == 128 else 64, kv_tiles=kv_tiles,
        kv_split=kv_split, kv_ctas=B * Hkv * kv_split * kv_tiles,
        kv_reverse=kv_reverse, q_rows=BWD_ROWS, q_keys=32 if f32 else 64,
        q_tiles=q_tiles, q_ctas=B * H * q_tiles, q_reverse=q_reverse)


@torch.library.custom_op('repro_torch::flash_attention', mutates_args=())
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: Optional[int],
                          sm_scale: float, kv_len: Optional[int],
                          offset: int, return_lse: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` on CPU tensors, the op
    ``repro_torch::flash_attention``: the plain version, (out, lse) (lse
    empty without ``return_lse``), and under fake tensors outputs of its
    shapes (a cost model charges the op by its launch geometry,
    ``attention_cost``)."""
    kw = dict(causal=causal, window=window, sm_scale=sm_scale,
              kv_len=kv_len, offset=offset)
    if return_lse:
        return attention_ref(q, k, v, return_lse=True, **kw)
    return (attention_ref(q, k, v, **kw),
            q.new_empty((0,), dtype=torch.float32))


@flash_attention_plain.register_fake
def _(q, k, v, causal, window, sm_scale, kv_len, offset, return_lse):
    b, h, sq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty(
        (b, h, sq) if return_lse else (0,), dtype=torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    offset: Optional[int] = None, return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with H % Hkv == 0, all f32 or
    all bf16.  Returns (B, H, Sq, D) in q's dtype, and with
    ``return_lse`` also the rows' log-sum-exp, f32 (B, H, Sq).

    ``offset``: absolute position of query row 0 minus that of key row 0
    (default Sk - Sq when causal, else 0).  ``kv_len``: keys j < kv_len
    only.  ``window``: query position p attends keys j with p - j < window
    (also without ``causal``).  ``sm_scale`` defaults to D ** -0.5.  CPU
    tensors run the plain version; CUDA tensors launch the kernel and count
    it in ``flash_attention.launches``.
    """
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f'flash_attention: H={h} is not a multiple of '
                         f'Hkv={hkv}')
    scale = d ** -0.5 if sm_scale is None else sm_scale
    if offset is None:
        offset = sk - sq if causal else 0
    dev = q.device
    if dev.type == 'cpu':
        o, lse = flash_attention_plain(q, k, v, causal, window, scale,
                                       kv_len, offset, return_lse)
        return (o, lse) if return_lse else o
    if dev.type != 'cuda':
        raise ValueError(f'flash_attention runs on cuda or cpu, not {dev}')
    if q.dtype not in _DTYPES:
        raise ValueError(f'flash_attention: dtype {q.dtype}, expected one '
                         f'of {_DTYPES}')
    check_inputs(dict(q=q, k=k, v=v),
                 dict(q=(b, h, sq, d), k=(b, hkv, sk, d), v=(b, hkv, sk, d)),
                 dev, dict(q=q.dtype, k=q.dtype, v=q.dtype))
    if d > D_MAX or b * h > 65535 or max(sq, sk, abs(offset)) >= POS_MAX:
        raise ValueError(f'flash_attention: D={d} must be at most {D_MAX}, '
                         f'B*H={b * h} at most 65535, and Sq={sq}, Sk={sk}, '
                         f'|offset|={abs(offset)} below {POS_MAX}')
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    # a window beyond +-2 POS_MAX passes or masks every pair alike
    win = 0 if window is None else max(-2 * POS_MAX, min(2 * POS_MAX, window))
    kv = sk if kv_len is None else max(-1, min(sk, kv_len))
    vec = (d % (16 // q.element_size()) == 0
           and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    geom = attention_geometry(
        b, h, hkv, sq, sk, window, kv_len, offset, d,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        causal=causal, wide=q.dtype == torch.bfloat16, split=not return_lse)
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts = [None] * 4                 # m, l, acc partials and tickets
    if geom.path == 'split':
        rows = geom.n_splits * b * h * sq
        parts = [torch.empty(rows, dtype=torch.float32, device=dev),
                 torch.empty(rows, dtype=torch.float32, device=dev),
                 torch.empty(rows * d, dtype=torch.float32, device=dev),
                 _tickets(dev, stream, b * hkv)]
    lib = _build.load('flash_attention', _SIGNATURES)
    err = lib.flash_attention_launch(
        dev.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, hkv, sq, sk, d, float(scale), int(causal),
        int(window is not None), win, kv, offset,
        int(q.dtype == torch.bfloat16), int(vec), geom.tile_rows,
        geom.n_splits,
        geom.key_lo, geom.key_hi, geom.split_keys,
        *(0 if t is None else t.data_ptr() for t in parts),
        0 if lse is None else lse.data_ptr(), stream)
    _build.check(lib, err, 'flash_attention launch')
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
