"""Phase timing: labeled wall-clock phases, as ``zkodst_tpu/utils/timing.py``.

A phase on the card ends with ``torch.cuda.synchronize()`` so its time
covers the device work it enqueued, not only the enqueueing.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List

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

    @contextlib.contextmanager
    def phase(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.phases.append(Phase(label, dt))
