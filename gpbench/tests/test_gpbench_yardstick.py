"""The yardsticks against cases worked by hand."""

import math

import pytest

from gpbench.yardstick import ops, peaks, steps


def test_bound_takes_the_larger_of_bytes_and_flops():
    t, by = ops.bound_s(3.35e12, 67e12 / 2)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = ops.bound_s(1.0, 67e12 * 2)
    assert by == "operations" and t == pytest.approx(2.0)


def test_op_work_by_hand():
    n, R = 1 << 20, 59
    # K3: rows in (4 B), weights in (4 B a bin), one sum out a row
    b, f = ops.op_work("pfft_quad", [(R, n), (n,)])
    assert b == R * n * 4 + n * 4 + R * 4
    assert f == R * n * (2.5 * 20 + 3)
    # its bound at 2^20, 59 rows: 251.7 MB at 3.35 TB/s = 75.1 us, bytes (the 0.0751 ms
    # of the kernel table)
    t, by = ops.bound_s(b, f)
    assert by == "bytes" and t == pytest.approx(75.12e-6, rel=1e-3)
    # K1 on one real row: 4 B in, 8 B out a point; 2.5 n log2 n
    assert ops.op_work("pfft", [(1, n)]) == (12 * n, 2.5 * n * 20)
    assert ops.op_work("pfft", [(2, n)], complex_in=True) == (32 * n, 2 * 5 * n * 20)
    assert ops.op_work("pifft_real", [(3, 8, n)]) == (24 * 12 * n, 24 * 2.5 * n * 20)
    # K4: rows in and out, the means in
    assert ops.op_work("fwht", [(4, 1024), (4,)]) == (4 * 1024 * 8 + 16, 4 * 1024 * 11)
    with pytest.raises(ValueError):
        ops.op_work("nope", [(1, 2)])


def test_step_flops_by_hand():
    lat = {"model": "FastGPLattice", "n": [1024], "d": 2, "alpha": 2}
    # a pair: 2 (5 + 8) + 1 + 2 + 2.5 * 10 + 3 = 57; the solver 1024 (7 + 2 * 25)
    assert steps.lattice_request_flops(lat, 4) == 4 * 1024 * 57 + 1024 * (7 + 50)
    # one pair of 1024: contraction 3 * 7, transforms 2 * 25, eigenvalues 4;
    # one block a point (M = 1): 3 * (2 + 2 + 2)
    assert steps.fit_step_flops(lat) == 1024 * (21 + 50 + 4) + 1024 * 18
    assert steps.hmc_gradient_flops(lat, 8) == 8 * steps.fit_step_flops(lat)
    mt = {"model": "FastGPDigitalNetB2", "n": [8, 4], "d": 1, "alpha": 2}
    # pairs (0,0), (0,1) of 8 points, (1,1) of 4: contraction 3 * 4, FWHT 2 n log2 n
    want = (8 * (12 + 2 * 3) + 4 * 8) + 8 * (12 + 2 * 3) + (4 * (12 + 2 * 2) + 4 * 4)
    want += 3 * 4 * (2 * 27 + 2 * 9 + 2 * 3)        # n_min 4, M = 3
    assert steps.fit_step_flops(mt) == want
    assert peaks.PEAK_FP32_S == 67e12 and peaks.PEAK_BYTES_S == 3.35e12
    assert math.isclose(ops.fwht_flops(8, 2), 2 * 8 * 4)
