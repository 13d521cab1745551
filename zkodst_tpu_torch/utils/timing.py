"""Phase timing and metrics, as ``zkodst_tpu/utils/timing.py``: labelled
wall-clock phases, recorded values, the run's JSON, and a profiler trace
around a block.

A phase on the card ends with ``torch.cuda.synchronize()`` so its time
covers the device work it enqueued, not only the enqueueing.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

SETUP = "setup"
PROVE = "prove"
VERIFY = "verify"


@dataclass
class Phase:
    label: str
    seconds: float


@dataclass
class Metrics:
    phases: List[Phase] = field(default_factory=list)
    values: Dict[str, float] = field(default_factory=dict)
    echo: bool = True                # print Start:/End: lines per phase

    @contextlib.contextmanager
    def phase(self, label: str):
        t0 = time.perf_counter()
        if self.echo:
            print(f"Start: [{label}]", flush=True)
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.phases.append(Phase(label, dt))
            if self.echo:
                print(f"End:   [{label}] {dt * 1e3:.1f} ms", flush=True)

    def record(self, key: str, value: float) -> None:
        self.values[key] = value

    def seconds(self, label: str) -> Optional[float]:
        """The last time of phase `label`, None if it never ran."""
        for ph in reversed(self.phases):
            if ph.label == label:
                return ph.seconds
        return None

    def to_json(self) -> str:
        return json.dumps({
            "phases": {p.label: round(p.seconds, 6) for p in self.phases},
            **self.values,
        })


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """Trace the block with ``torch.profiler`` (the CPU, and the card where
    there is one) and write a Chrome trace, ``trace.json``, into
    `trace_dir`. Does nothing when `trace_dir` is empty or None."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
