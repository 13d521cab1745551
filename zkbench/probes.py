"""The benchmark's own spans around calls into the program's layers.

* :func:`phase_spans`: each of the prover's phases (``prove.witness``,
  ``prove.multiopen``, …) also opens a ``torch.profiler`` span of its
  name, so a trace can say what the host was doing in an idle gap.
* :class:`MsmProbe`: CUDA events around each outermost call of the MSM
  layer's entries (``ops.msm.msm_many`` and ``msm_many_mont``) and a copy
  of the normal-form scalars that ``msm_many`` receives, from which the
  frozen work model (:mod:`.roofline.msm`) counts what the call needed.
"""

from __future__ import annotations

import contextlib
from typing import List

from .roofline import msm as msm_model


@contextlib.contextmanager
def phase_spans(metrics):
    """While open, every ``metrics.phase(label)`` is also a profiler span."""
    import torch

    orig = metrics.phase

    @contextlib.contextmanager
    def phase(label):
        with torch.profiler.record_function(label), orig(label):
            yield

    metrics.phase = phase
    try:
        yield
    finally:
        del metrics.phase


class MsmProbe:
    """Patches the MSM layer's entries of `msm_module` while open.

    ``msm_many_mont`` calls ``msm_many`` through the module's global name,
    so the patched ``msm_many`` sees that call again: only the outermost
    call of a nest is timed, and the work is counted once, on the
    normal-form scalars ``msm_many`` receives. The copy of the scalars is
    made inside a nested call's interval (one device copy, microseconds
    next to the MSM's milliseconds)."""

    def __init__(self, msm_module):
        self.mod = msm_module
        self.depth = 0
        self.events: List = []          # (start, end) of outermost calls
        self.calls: List = []           # (N, B, scalar copy, bytes in)

    def _wrap(self, fn, counts_work: bool):
        import torch

        def wrapped(points, scalars, *args, **kw):
            outer = self.depth == 0
            if counts_work:
                self.calls.append((points.shape[0], scalars.shape[0],
                                   scalars.detach().clone(),
                                   points.numel() * points.element_size()
                                   + scalars.numel()
                                   * scalars.element_size()))
            if outer:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            self.depth += 1
            try:
                return fn(points, scalars, *args, **kw)
            finally:
                self.depth -= 1
                if outer:
                    end.record()
                    self.events.append((start, end))
        return wrapped

    def __enter__(self):
        self.orig = (self.mod.msm_many, self.mod.msm_many_mont)
        self.mod.msm_many = self._wrap(self.orig[0], True)
        self.mod.msm_many_mont = self._wrap(self.orig[1], False)
        return self

    def __exit__(self, *exc):
        self.mod.msm_many, self.mod.msm_many_mont = self.orig

    def drain(self):
        """(seconds in the layer, multiply results, bytes) of the calls so
        far, after a synchronize; the scalar copies are freed."""
        import torch

        torch.cuda.synchronize()
        seconds = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        ops = nbytes = 0
        per_call = []
        for n, b, scal, bytes_in in self.calls:
            nz, active = msm_model.nonzero_digits(scal, msm_model.c_of(n))
            o, by = msm_model.work(n, nz, active, bytes_in, b)
            ops += o
            nbytes += by
            per_call.append((o, by))
        self.events.clear()
        self.calls.clear()
        return seconds, ops, nbytes, per_call
