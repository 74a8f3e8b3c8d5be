"""The port's cost model (``repro_torch.op_cost``) and roofline
(``repro_torch.roofline``), on the CPU.

Exact counts on small programs traced under fake tensors: ten chained
256 x 256 matrix products are 2 * 256**3 * 10 FLOPs; an in-place write
into a slice moves the slice's bytes; an all-gather of a DTensor on a fake
mesh (a subprocess: one process group a process) moves the analytic
operand bytes; a loop weighted by ``steps`` counts its body and its
backward as many times as it turns; K8's charged FLOPs are 4 D times the
query x key elements of the live tiles of its schedule.  The roofline's
arithmetic on the card's constants; the stack-backend ranking is
deterministic, grows with layers and T, and sits at or above the lower
bound.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import op_cost
from repro_torch.kernels.flash_attention import kernel as k8
from repro_torch.launch import mesh
from repro_torch.roofline import RooflineTerms, analyze

SRC = os.path.join(os.path.dirname(__file__), '..', 'src')


def test_chained_matmuls_count_exactly():
    with op_cost.traced() as mode:
        with mode.hidden():
            w = torch.empty(256, 256)
            x = torch.empty(256, 256)
        for _ in range(10):
            x = x @ w
    rec = mode.record
    assert rec.flops == 2 * 256 ** 3 * 10
    assert dict(rec.flops_by_dtype) == {'float32': 2 * 256 ** 3 * 10}
    # each product reads two 256^2 f32 matrices and writes one
    assert rec.bytes == 10 * 3 * 256 * 256 * 4
    assert rec.peak_bytes == 2 * 256 * 256 * 4      # x and its successor


def test_inplace_slice_write_moves_the_slice():
    with op_cost.traced() as mode:
        with mode.hidden():
            big = torch.empty(1024, 1024)
            row = torch.empty(1024)
        big[3].copy_(row)
        big[5:7].zero_()
    # copy_: the source read and the slice written; zero_: the slice
    assert mode.record.bytes == 2 * 1024 * 4 + 2 * 1024 * 4
    assert mode.record.flops == 0


def test_steps_weight_a_loop_and_its_backward():
    """A loop of T steps traced once counts T bodies forward and T bodies'
    worth of backward: equal to the same loop run T times."""
    def run(weighted: bool):
        with op_cost.traced() as mode:
            with mode.hidden():
                w = torch.empty(64, 64, requires_grad=True)
                h0 = torch.empty(8, 64, requires_grad=True)
            ys, T, h = [], 12, h0
            it = op_cost.steps(range(T), h) if weighted else range(T)
            for _ in it:
                h = torch.tanh(h @ w)
                ys.append(h)
            y = op_cost.stack_steps(ys, T) if weighted else torch.stack(ys)
            torch.autograd.grad(y.sum(), (w, h0))
        return mode.record

    full, once = run(False), run(True)
    assert once.kernels == full.kernels == {}
    # every step alike (h0 takes a gradient): T products forward, 2 T back
    mm = lambda r: r.by_op[('op', 'mm')][0]
    assert mm(once) == mm(full) == 3 * 12 * 2 * 8 * 64 * 64


@pytest.mark.parametrize('causal,window,sq,sk', [
    (True, None, 300, 300), (True, 96, 257, 257), (False, None, 70, 190),
    (True, None, 1, 4096)])
def test_k8_charge_is_its_live_tiles(causal, window, sq, sk):
    """K8's charge: 4 D a (query, key) element of every (query tile, key
    tile) pair of its schedule that holds a valid pair, counted here by
    brute force over the mask."""
    B, H, Hkv, D = 2, 4, 2, 64
    off = sk - sq if causal else 0
    q = torch.empty(B, H, sq, D)
    k = torch.empty(B, Hkv, sk, D)
    geom = k8.attention_geometry(B, H, Hkv, sq, sk, window, None, off, D,
                                 mesh.SMS, causal=causal)
    pos = np.arange(sq)[:, None] + off
    key = np.arange(sk)[None, :]
    valid = (key <= pos) if causal else np.ones((sq, sk), bool)
    if window is not None:
        valid &= (pos - key) < window
    if geom.path == 'split':
        area = sq * (geom.key_hi - geom.key_lo)
    else:
        area = 0
        for r0 in range(0, sq, geom.tile_rows):
            for c0 in range(0, sk, 64):
                blk = valid[r0:r0 + geom.tile_rows, c0:c0 + 64]
                if blk.any():
                    area += blk.size
    with op_cost.traced() as mode:
        with mode.hidden():
            qf, kf, vf = (torch.empty(t.shape) for t in (q, k, k))
        out = k8.flash_attention(qf, kf, vf, causal=causal, window=window)
    assert out.shape == q.shape
    assert mode.record.kernels['flash_attention']['launches'] == 1
    assert mode.record.kernels['flash_attention']['flops'] == \
        4 * D * area * B * H
    assert mode.record.ops == 0                # the plain version is hidden


def test_all_gather_bytes_on_a_fake_mesh():
    """A DTensor (1024, 512) f32 sharded 16 ways on a (16, 16) fake mesh,
    made whole: one all-gather of each rank's (64, 512) shard."""
    code = textwrap.dedent('''
        import torch
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch import op_cost
        from repro_torch.launch.mesh import make_production_mesh
        m = make_production_mesh()
        with op_cost.traced() as mode:
            with mode.hidden():
                t = distribute_tensor(torch.empty(1024, 512), m,
                                      [Shard(0), Replicate()],
                                      src_data_rank=None)
            t.redistribute(m, [Replicate(), Replicate()])
        print(dict(mode.record.coll), m.size())
    ''')
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, '-c', code], env=env, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["{'all-gather':", '131072.0}', '256']


def test_roofline_terms_on_the_card():
    t = RooflineTerms(flops=989e12, hbm_bytes=3.35e12 * 0.5,
                      collective_bytes=450e9 * 0.25, per_collective={},
                      model_flops=494.5e12,
                      flops_by_dtype={'bfloat16': 989e12})
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(0.25)
    assert t.bottleneck == 'compute'
    assert t.step_time_lower_bound_s == pytest.approx(1.0)
    assert t.useful_flops_fraction == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(0.5)
    # each dtype at its own peak: 67 TFLOP/s of f32 take the same second
    f = RooflineTerms(flops=67e12 + 989e12, hbm_bytes=0, collective_bytes=0,
                      per_collective={},
                      flops_by_dtype={'float32': 67e12, 'bfloat16': 989e12})
    assert f.compute_s == pytest.approx(2.0)
    assert mesh.peak_rate(torch.float32) == 67e12
    assert mesh.peak_rate(torch.int8) == 1979e12
    assert set(t.to_dict()) == {
        'flops', 'hbm_bytes', 'collective_bytes', 'per_collective',
        'model_flops', 'compute_s', 'memory_s', 'collective_s',
        'bottleneck', 'useful_flops_fraction', 'roofline_fraction'}


def test_rank_stack_backends():
    """Deterministic; each backend's estimate grows with layers and with
    T; every estimate is at or above its launch's lower bound; the kernel
    backends are charged their launches (K1 a layer, K2 once)."""
    a = op_cost.rank_stack_backends(13, 32, 2, 16, 4)
    assert a == op_cost.rank_stack_backends(13, 32, 2, 16, 4)
    assert sorted(b for b, _ in a) == sorted(
        op_cost.NON_STAGED_STACK_BACKENDS)
    for b in op_cost.NON_STAGED_STACK_BACKENDS:
        est = lambda L, T: op_cost.estimate_backend_us(b, 13, 32, L, T, 4)
        assert est(2, 16) < est(3, 16) < est(4, 16)
        assert est(2, 16) < est(2, 32) < est(2, 64)
        rec = op_cost.stack_launch_cost(b, 13, 32, 2, 16, 4)
        assert est(2, 16) >= analyze(rec).step_time_lower_bound_s * 1e6
    k = op_cost.stack_launch_cost('cuda_seq', 13, 32, 3, 16, 4).kernels
    assert k['lstm_seq']['launches'] == 3
    k = op_cost.stack_launch_cost('cuda_seq_fused', 13, 32, 3, 16, 4).kernels
    assert k['lstm_stack_seq_kernel']['launches'] == 1


def test_top_contributors():
    with op_cost.traced() as mode:
        with mode.hidden():
            x = torch.empty(64, 64)
        y = x @ x
        torch.tanh(y)
    coll, mem, flops = op_cost.top_contributors(mode.record, k=2)
    assert coll == []
    assert flops[0][1] == 'mm' and flops[0][0] == 2 * 64 ** 3
    assert {n for _, n in mem} == {'mm', 'tanh'}
