"""Layer pipelining over systolic sub-arrays — contribution C3b, in PyTorch.

Port of ``repro.core.pipeline``.  The paper's best configuration (3x(5x5))
dedicates one 5x5 sub-array per LSTM layer: after the initial weight load
nothing is reconfigured, and frames stream through the three stages.  On a
(stage, row, col) ``SystolicMesh``, stage s owns layer s's weight tiles and
stage s - 1's hidden state is handed to stage s (``_ppermute``, the
board-level wiring between sub-arrays).  At microstep k, stage s processes
timestep k - s of layer s: a 1F pipeline with S - 1 bubbles at fill and
drain.  Every layer is padded to one ``SystolicPlan`` so the grid is
rectangular, and each step is the per-step baseline of
``core.systolic.systolic_lstm_shard_map`` (one engine per plan tile, the
x-region re-MACed every step).  The serving path's staged scale-out is
``core.systolic.systolic_lstm_stack_seq``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .lstm import LSTMParams
from .systolic import (PackedLSTM, ShardedPackedLSTM, SystolicMesh,
                       SystolicPlan, _ppermute, _require_staged_axes,
                       _shard_stage, _tile_step, pack_lstm)


def pack_pipeline(layers: Sequence[LSTMParams], tile: int
                  ) -> Tuple[PackedLSTM, SystolicPlan]:
    """Pack S layers into stacked tiles (S, R, C, 4, t, t) under one plan;
    a layer with a narrower input (layer 0: N_x = 123 against N_h = 421) is
    zero-padded on the input-column side."""
    n_h = layers[0].n_h
    if any(l.n_h != n_h for l in layers):
        raise ValueError('pipeline layers must share N_h')
    n_x_max = max(l.n_x for l in layers)
    plan = SystolicPlan(n_x_max, n_h, tile)
    packs = []
    for l in layers:
        w_x = torch.nn.functional.pad(l.w_x, (0, n_x_max - l.n_x))
        packs.append(pack_lstm(LSTMParams(w_x, l.w_h, l.w_peep, l.b), plan))
    return PackedLSTM(tiles=torch.stack([p.tiles for p in packs]),
                      peep=torch.stack([p.peep for p in packs]),
                      bias=torch.stack([p.bias for p in packs]),
                      plan_shape=packs[0].plan_shape), plan


def shard_pipeline(packed: PackedLSTM, mesh: SystolicMesh
                   ) -> ShardedPackedLSTM:
    """Place stage s's tile (r, c) on engine (s, r, c) and its row
    peepholes and biases on the engine finishing the row: ``tiles[s][r][c]``,
    ``peep[s][r]``, ``bias[s][r]``.  Placement only."""
    placed = [_shard_stage(packed, mesh, s, packed.tiles[s], packed.peep[s],
                           packed.bias[s]) for s in range(mesh.stage)]
    return ShardedPackedLSTM(*(tuple(p[i] for p in placed) for i in range(3)),
                             packed.plan_shape)


def systolic_pipeline(packed, mesh: SystolicMesh, xs: torch.Tensor
                      ) -> torch.Tensor:
    """Run S pipelined LSTM layers over xs (T, B, padded_x) -> (T, B, n_h)
    on xs's device; the mesh must be (S, plan.rows, plan.cols).  ``packed``
    is ``pack_pipeline``'s (placed here) or ``shard_pipeline``'s."""
    S, mr, mc = _require_staged_axes(mesh)
    if isinstance(packed, PackedLSTM):
        packed = shard_pipeline(packed, mesh)
    plan = packed.plan
    t = plan.tile
    if xs.shape[2] != plan.padded_x:
        raise ValueError(f'xs is (T, B, {xs.shape[2]}), the plan takes '
                         f'padded_x = {plan.padded_x}')
    if (mr, mc) != (plan.rows, plan.cols):
        raise ValueError(f'mesh rows x cols {mr}x{mc} is not the plan grid '
                         f'{plan.rows}x{plan.cols}')
    T, B = xs.shape[0], xs.shape[1]
    h = [xs.new_zeros((B, plan.padded_h)).to(mesh.lead(s)) for s in range(S)]
    c = [[xs.new_zeros((B, t)).to(mesh.finish(s, r)) for r in range(mr)]
         for s in range(S)]
    out = []
    for k in range(T + S - 1):
        h_prev = list(h)
        for s in range(min(k, S - 1) + 1):     # stage s starts at k = s
            if s == 0:
                x_in = (xs[k] if k < T
                        else xs.new_zeros((B, plan.padded_x)))
            else:
                handed = _ppermute(h_prev[s - 1], mesh.lead(s))
                x_in = torch.nn.functional.pad(
                    handed, (0, max(0, plan.padded_x - plan.padded_h))
                )[:, :plan.padded_x]

            def col_in(ci, x_in=x_in, h_s=h_prev[s]):
                if ci < plan.cols_x:
                    return x_in[:, ci * t:(ci + 1) * t]
                ci -= plan.cols_x
                return h_s[:, ci * t:(ci + 1) * t]

            h[s], c[s] = _tile_step(mesh, s, packed.tiles[s], packed.peep[s],
                                    packed.bias[s], col_in, c[s])
        out.append(h[S - 1])
    return torch.stack(out[S - 1:]).to(xs.device)[..., :plan.n_h]
