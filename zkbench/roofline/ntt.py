"""A frozen model of the work of the NTT layer, counted from the counts
of the program's ``.ntt`` spans (one for each outermost transform:
``ops.ntt.ntt``, ``intt``, ``coset_ntt``, ``coset_intt``).

Work, for a transform of a batch of b columns of n field elements:

* b·(n/2)·log2 n radix-2 butterflies, each one field multiplication of 8
  × 32-bit limbs (Montgomery, CIOS): 264 32-bit multiply results, as
  :mod:`.msm` counts them (the additions and the scalings by n⁻¹ or g^i
  are not counted);
* bytes: one read and one write of the batch (b·n elements of 8 × 4
  bytes), the least any transform moves; the twiddles are not counted.

The model depends on (b, n) alone, not on how many passes the program
makes: the launches a span counts are kept as a count and bound nothing.
A transform's least time is the larger of its multiply results at the
card's peak and its bytes at its memory's (:func:`.peaks.least_seconds`).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from . import peaks
from .msm import MUL_RESULTS_PER_FIELD_MUL

ELEMENT_BYTES = 8 * 4


def work(batch: int, n: int):
    """(32-bit multiply results, bytes) of one transform."""
    butterflies = batch * (n // 2) * (n.bit_length() - 1)
    return (butterflies * MUL_RESULTS_PER_FIELD_MUL,
            2 * batch * n * ELEMENT_BYTES)


def window_proves(proves: int) -> Optional[List[List]]:
    """The ``.ntt`` spans of each of the newest `proves` proves that the
    program keeps in ``zkodst_tpu_torch.utils.timing.LAYER_SPANS`` (the
    spans that carry counts, with the id of their prove, since the
    counters' reset before the traced proves), oldest first. The window's
    proves are the run's last. None where the program keeps no such
    store."""
    try:
        from zkodst_tpu_torch.utils.timing import LAYER_SPANS
    except ImportError:
        return None
    by_prove: Dict[int, List] = {}
    for sp in LAYER_SPANS:
        by_prove.setdefault(sp.prove, []).append(sp)
    ids = sorted(by_prove)[-proves:] if proves > 0 else []
    return [[sp for sp in by_prove[i] if sp.label.endswith(".ntt")]
            for i in ids]


def device_ms(proves: Optional[List[List]]) -> Optional[float]:
    """The mean over `proves` of each prove's summed ``.ntt`` device time
    (each span's CUDA event pair), in ms; proves without such a span are
    left out. None where no prove has one."""
    per = [sum(sp.device_s for sp in spans) for spans in proves or []
           if spans and all(sp.device_s is not None for sp in spans)]
    return 1e3 * sum(per) / len(per) if per else None


def roofline_pct(spans: Iterable, peak: Optional[Dict]) -> Optional[float]:
    """The spans' least time under the model as a share of their device
    time (each span's ``device_s``), in %; spans without a device time are
    left out. None without a peak or without a span to read."""
    if peak is None:
        return None
    least = device = 0.0
    for sp in spans:
        if sp.device_s is None or sp.counts is None:
            continue
        c = sp.counts
        least += peaks.least_seconds(*work(c["batch"], c["n"]), peak)
        device += sp.device_s
    return 100.0 * least / device if device > 0 else None
