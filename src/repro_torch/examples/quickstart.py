"""Quickstart: the Chipmunk systolic LSTM core, on the port.

Builds the paper's CTC-3L-421H layer-1 geometry (123 -> 421, 96-unit
engines), runs it three ways — the dense oracle, the float systolic
dataflow, the bit-accurate int8 silicon path (its plain chain and K3,
``lstm_layer_seq_quantized``, which must agree bit for bit) — and reports
the paper's headline numbers from the calibrated performance model::

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from ..core import lstm, perf_model as pm, quant, systolic
from ..kernels.lstm_seq import lstm_layer_seq_quantized


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda',
                    help='torch device (cuda, cpu)')
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- the paper's layer-1 geometry --------------------------------------
    n_x, n_h = 123, 421                  # MFCC features -> hidden units
    params = lstm.init_lstm_params(n_x, n_h, torch.Generator().manual_seed(0))
    params = lstm.LSTMParams(*(a.to(dev) for a in (
        params.w_x, params.w_h, params.w_peep, params.b)))
    xs = (torch.randn((20, 4, n_x), generator=torch.Generator().manual_seed(1))
          * 0.5).to(dev)                 # (T, B, D)

    # 1) dense oracle (Eqs. 1-5 of the paper)
    hs_ref, _ = lstm.lstm_layer(params, xs)

    # 2) the systolic dataflow: 5x7 grid of 96x96 weight-stationary tiles
    plan = systolic.SystolicPlan(n_x, n_h, tile=systolic.N_LSTM_SILICON)
    packed = systolic.pack_lstm(params, plan)
    hs_sys = systolic.systolic_layer_tiled(packed, xs)
    sys_err = float((hs_sys - hs_ref).abs().max())
    print(f'systolic grid: {plan.rows} rows x {plan.cols} cols '
          f'({plan.rows * plan.cols} engines of {plan.tile}x{plan.tile})')
    print(f'float systolic vs dense:  max |err| = {sys_err:.2e}')

    # 3) the silicon datapath: int8 storage, saturating int16 hops, LUTs
    qp = systolic.quantize_packed(packed)
    xs_q = quant.quantize(xs, quant.STATE_FMT)
    hs_q = systolic.systolic_layer_quantized(qp, xs_q)
    err = (quant.dequantize(hs_q, quant.STATE_FMT) - hs_ref).abs()
    print(f'int8 silicon vs dense:    mean |err| = {float(err.mean()):.4f} '
          f'({float(err.mean()) / quant.STATE_FMT.scale:.2f} LSB of Q2.5)')
    k3_equal = torch.equal(lstm_layer_seq_quantized(qp, xs_q), hs_q)
    print(f'int8 K3 (lstm_layer_seq_quantized) == plain chain: {k3_equal}')
    if not k3_equal:
        raise SystemExit('K3 disagrees with the plain int8 chain')

    # --- the headline silicon numbers (calibrated model, Sec. 4.1) ---------
    row = pm.table2_row(pm.CTC_3L_421H, pm.TileConfig(3, 5, 5), 1.24)
    print(f'\npeak performance  @1.24V: {pm.peak_gops(1.24):5.1f} Gop/s '
          f'(paper: 32.3)')
    print(f'peak efficiency   @0.75V: {pm.efficiency_gops_per_mw(0.75):5.2f} '
          f'Gop/s/mW (paper: 3.08)')
    print(f'CTC-3L-421H on 3x(5x5)  : {row["exec_time_ms"]:.3f} ms/frame '
          f'(paper: 0.09, deadline '
          f'{"MET" if row["meets_deadline"] else "MISS"})')
    return dict(systolic_max_err=sys_err, int8_mean_err=float(err.mean()),
                k3_equal=k3_equal, exec_time_ms=row['exec_time_ms'])


if __name__ == '__main__':
    main()
