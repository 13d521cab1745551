"""The frozen MSM work model on hand-worked cases, and the trace reduction
on a small synthetic trace."""

import pytest
import torch

from zkbench import trace
from zkbench.roofline import msm, peaks


def _limbs(values):
    """Python ints -> (1, N, 8) int32 limbs (32-bit, little-endian)."""
    rows = [[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for v in values]
    t = torch.tensor(rows, dtype=torch.int64)
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(
        torch.int32)[None]


def test_window_width_is_a_function_of_n():
    assert [msm.c_of(n) for n in (2, 4, 31, 32, 1 << 17)] == [1, 3, 3, 4, 12]
    assert msm.windows(12) == 22 and msm.windows(3) == 86


def test_multiply_results_per_addition():
    assert msm.MUL_RESULTS_PER_FIELD_MUL == 264
    assert msm.MUL_RESULTS_PER_ADD == 12 * 264


def test_nonzero_digits_hand_worked():
    # c = 3: 5 = 0b101 -> one nonzero window; 8 = 0b1000 -> window 1;
    # 2^255 -> window 85 (bit 255 = 3·85); 0 -> none; 7 + 7·8 -> two
    scal = _limbs([5, 8, 1 << 255, 0, 7 + 7 * 8])
    digits, active = msm.nonzero_digits(scal, 3)
    assert digits == 1 + 1 + 1 + 0 + 2
    assert active == 3                 # windows 0, 1 and 85 hold digits


def test_window_across_a_limb_boundary():
    # c = 12: window 2 covers bits 24..35, across limbs 0 and 1
    scal = _limbs([1 << 33])
    assert msm.nonzero_digits(scal, 12) == (1, 1)


def test_work_and_least_time():
    ops, nbytes = msm.work(n_points=40, nonzero=10, active=2,
                           bytes_in=1000, batch=1)
    c = msm.c_of(40)                                  # ⌈ln 40⌉ = 4
    assert c == 4
    assert ops == (10 + 2 * (2 * 15 + 4 + 1)) * 3168
    assert nbytes == 1000 + 96
    peak = {"mul32_per_s": 1e6, "hbm_bytes_per_s": 1e3}
    assert peaks.least_seconds(ops, nbytes, peak) == pytest.approx(
        max(ops / 1e6, nbytes / 1e3))


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "prove.quotient",
         "ts": 40, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 50,
         "dur": 20, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "void ec_add_kernel<0>()",
         "ts": 10, "dur": 20, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "binop_kernel<(Op)0>",
         "ts": 25, "dur": 10, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80,
         "dur": 10, "tid": 7},
    ]
    red = trace.reduce_events(ev)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx(35e-6)        # [10, 35), [80, 90)
    assert red["kernel_records"] == {"ec_add": 1, "mulmod": 1}
    gaps = dict(red["idle_gaps"])
    assert gaps["prove.quotient > aten::sort"] == pytest.approx(45e-6)
    assert gaps["host (no span)"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(65e-6)
