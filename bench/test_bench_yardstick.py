"""The frozen yardstick against hand counts."""
import pytest

from bench import yardstick as y


def test_macs_per_frame():
    # 4*421*(123+421) + 2 * 4*421*842 + 62*421
    assert y.macs_per_frame(123, 421, 3, 62) == 3_778_054
    assert y.macs_per_frame(13, 32, 2, 16) == 4 * 32 * 45 + 4 * 32 * 64 + 16 * 32


@pytest.mark.parametrize('T, B, bound_ms', [(64, 105, 0.71488),
                                            (16, 105, 0.17872),
                                            (16, 8, 0.01362)])
def test_k2_bounds_at_the_kernel_rows(T, B, bound_ms):
    # every (step, stream) live: 5 families of 4 x 421 x 421 MACs and the
    # epilogue, at 67 TFLOP/s (PR 35's kernel rows)
    flops, nbytes = y.k2_call(T, B, T * B, 421, 3)
    assert flops == T * B * (5 * 8 * 421 ** 2 + 3 * 30 * 421)
    assert nbytes == 4 * (T * B * 4 * 421 + 5 * 4 * 421 ** 2
                          + 3 * (7 * 421 + 2 * B * 421 + 2 * T * B * 421)) + T * B
    got = y.bound_s(flops, nbytes, y.F32_FLOPS_PER_S) * 1e3
    assert got == pytest.approx(bound_ms, abs=5e-6)


def test_k4_bound_at_its_kernel_row():
    # T = 16, B = 8, every step live: bound by bytes (PR 19: 0.00142 ms)
    ops, nbytes = y.k4_call(16, 8, 128, 421, 3)
    assert nbytes == (4 * 16 * 8 * 4 * 421 + 5 * 4 * 421 ** 2 + 9 * 421
                      + 24 * 421 + 512 + 6 * 8 * 421 + 128 + 6 * 16 * 8 * 421)
    assert ops == 128 * (5 * 8 * 421 ** 2 + 90 * 421)
    got = y.bound_s(ops, nbytes, y.INT8_OPS_PER_S) * 1e3
    assert got == pytest.approx(0.00142, abs=5e-6)
    assert nbytes / y.HBM_BYTES_PER_S > ops / y.INT8_OPS_PER_S


def test_live_steps_only_count_operations():
    full, b_full = y.k2_call(16, 24, 16 * 24, 421, 3)
    half, b_half = y.k2_call(16, 24, 8 * 24, 421, 3)
    assert half == full / 2 and b_half == b_full
