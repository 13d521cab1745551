"""The benchmark's frozen NTT work model (``zkbench/roofline/ntt.py``) on
hand-worked figures, and its readers (``zkbench/metrics/ntt_ms.py``,
``ntt_roofline_pct.py``) on the window's ``.ntt`` spans as
``utils.timing.LAYER_SPANS`` keeps them, by prove; None where there is
nothing to read: no span, no device time, no peak, no prove, or a program
that keeps no such spans."""

import importlib.util
import os

import pytest
import torch

from zkbench.harness import Run
from zkbench.roofline import ntt, peaks
from zkodst_tpu_torch import kernels
from zkodst_tpu_torch.utils import timing
from zkodst_tpu_torch.utils.timing import Phase

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the H100 SXM at 700 W as peaks.card() reads it
H100 = {"mul32_per_s": 132 * 64 * 1980e6, "hbm_bytes_per_s": 3.35e12}


def _reader(name):
    path = os.path.join(REPO, "zkbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(label, batch, n, launches, device_s, prove=0):
    return Phase(label, device_s, device_s=device_s, prove=prove,
                 counts={"batch": batch, "n": n, "launches": launches})


def _msm(prove):
    return Phase("prove.quotient.msm", 0.01, device_s=0.01, prove=prove,
                 counts={"points": 4, "windows": 2})


@pytest.fixture(autouse=True)
def _fresh_counters():
    kernels.reset_counts()
    yield
    kernels.reset_counts()


def test_work_hand_computed():
    # the quotient's coset NTT at k = 17: 15 columns of 2^19
    ops, nbytes = ntt.work(15, 1 << 19)
    assert ops == 15 * (1 << 18) * 19 * 264 == 19_723_714_560
    assert nbytes == 2 * 15 * (1 << 19) * 32 == 503_316_480
    assert ntt.work(1, 2) == (264, 128)


@pytest.mark.parametrize("batch,log_n,by", [
    (15, 22, "operations"),     # k = 20's coset NTT
    (15, 19, "operations"),     # k = 17's
    (1 << 20, 2, "bytes")])     # 2.06 results a byte a stage: under 5
def test_least_time_takes_the_larger_bound(batch, log_n, by):
    ops, nbytes = ntt.work(batch, 1 << log_n)
    least = peaks.least_seconds(ops, nbytes, H100)
    want = (ops / H100["mul32_per_s"] if by == "operations"
            else nbytes / H100["hbm_bytes_per_s"])
    assert least == pytest.approx(want)
    assert least == max(ops / H100["mul32_per_s"],
                        nbytes / H100["hbm_bytes_per_s"])
    one = [_span("prove.quotient.extend.ntt", batch, 1 << log_n, 13,
                 2 * least)]
    assert ntt.roofline_pct(one, H100) == pytest.approx(50.0)


def test_launches_bound_nothing():
    """The model is frozen on (batch, n): a transform that takes fewer
    passes has the same least time."""
    many = _span("prove.quotient.extend.ntt", 15, 1 << 22, 13, 0.028)
    few = _span("prove.quotient.extend.ntt", 15, 1 << 22, 3, 0.028)
    assert ntt.roofline_pct([many], H100) == ntt.roofline_pct([few], H100)


def test_share_sums_least_times_over_device_times():
    spans = [_span("prove.intt.ntt", 2, 1 << 10, 2, 1e-4),
             _span("prove.quotient.h.ntt", 4, 1 << 12, 4, 3e-4)]
    least = sum(peaks.least_seconds(*ntt.work(sp.counts["batch"],
                                              sp.counts["n"]), H100)
                for sp in spans)
    assert ntt.roofline_pct(spans, H100) == pytest.approx(
        100 * least / 4e-4)


def test_share_is_none_without_spans_time_or_peak():
    sp = _span("prove.intt.ntt", 2, 1 << 10, 2, 1e-4)
    assert ntt.roofline_pct([], H100) is None
    assert ntt.roofline_pct([sp], None) is None
    cpu = Phase("prove.intt.ntt", 0.01, counts=sp.counts)   # no device_s
    assert ntt.roofline_pct([cpu], H100) is None


def _kept():
    """LAYER_SPANS after a traced prove (1) and a window of two (2, 3):
    the window's `.ntt` spans sum to 4 and 6 ms of device time."""
    traced = [_span("prove.intt.ntt", 2, 1 << 10, 2, 0.050, prove=1),
              _msm(1)]
    window = [[_span("prove.intt.ntt", 2, 1 << 10, 2, 0.001, prove=2),
               _msm(2),
               _span("prove.quotient.h.ntt", 4, 1 << 12, 4, 0.003,
                     prove=2)],
              [_span("prove.intt.ntt", 2, 1 << 10, 2, 0.002, prove=3),
               _span("prove.quotient.h.ntt", 4, 1 << 12, 4, 0.004,
                     prove=3),
               _msm(3)]]
    timing.LAYER_SPANS.extend(traced + window[0] + window[1])
    return traced, window


def test_window_proves_groups_the_newest_proves_ntt_spans():
    traced, window = _kept()
    want = [[sp for sp in w if sp.label.endswith(".ntt")] for w in window]
    assert ntt.window_proves(2) == want
    assert ntt.window_proves(3) == [traced[:1]] + want
    assert ntt.window_proves(0) == []
    assert ntt.device_ms(want) == pytest.approx(5.0)


def test_device_ms_leaves_out_proves_without_a_device_time():
    cpu = [Phase("prove.intt.ntt", 0.01, counts={"batch": 1, "n": 4,
                                                   "launches": 1})]
    assert ntt.device_ms([cpu, []]) is None
    assert ntt.device_ms([]) is None
    assert ntt.device_ms(None) is None
    assert ntt.device_ms([cpu, [_span("prove.intt.ntt", 1, 4, 1, 0.002)]]) \
        == pytest.approx(2.0)


def test_ntt_ms_reader_reads_the_window_device_time():
    """The mean over the window's proves of each prove's summed `.ntt`
    device time: the work queued before a span's open, which its host
    `seconds` would count, is not in it."""
    _kept()
    window = [{"prove": 0.2, "prove.intt.ntt": 0.5},
              {"prove": 0.2, "prove.intt.ntt": 0.5}]
    assert _reader("ntt_ms")({"run": Run(window_phases=window)}) == \
        pytest.approx(5.0)
    assert _reader("ntt_ms")({"run": Run(window_phases=[])}) is None


def test_ntt_roofline_reader_reads_the_window_ntt_spans():
    _, window = _kept()
    spans = [sp for w in window for sp in w if sp.label.endswith(".ntt")]
    run = Run(window_phases=[{}, {}], card=H100)
    read = _reader("ntt_roofline_pct")
    assert read({"run": run}) == pytest.approx(
        ntt.roofline_pct(spans, H100))
    assert read({"run": Run(window_phases=[{}, {}], card=None)}) is None
    kernels.reset_counts()
    assert not timing.LAYER_SPANS
    timing.LAYER_SPANS.append(_msm(4))
    assert read({"run": run}) is None


@pytest.mark.parametrize("name", ["ntt_ms", "ntt_roofline_pct"])
def test_readers_give_none_for_a_program_without_the_spans(monkeypatch,
                                                           name):
    """A program with no LAYER_SPANS (one older than the NTT spans) reads
    None."""
    monkeypatch.delattr(timing, "LAYER_SPANS")
    run = Run(window_phases=[{"prove": 0.2}], card=H100)
    assert _reader(name)({"run": run}) is None
