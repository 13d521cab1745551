"""Spans, host-wait counters and metrics, as ``zkodst_tpu/utils/timing.py``:
labelled phases, recorded values, the run's JSON, and a profiler trace
around a block.

A span is a labelled interval of the program. :meth:`Metrics.phase`
opens one under its full label (``prove``, ``prove.quotient``, …);
:func:`span` opens one under whatever span is open, labelled with the
parent's label, a dot and its name (``prove.quotient.constraints``), and
does nothing when no span is open, so deep code needs no ``metrics``
argument. Every span closed is appended to ``Metrics.phases`` (a
:class:`SpanLog`, which holds the newest 32,768 to 65,536) with its host
open and close times, its parent, the id of the outermost span it
belongs to (one per prove), and the kernel launches and host waits made
between its open and close; :meth:`Metrics.tree` gives the spans of the
last prove (the CLI's ``prove`` prints them). While a profiler records,
a span is also a ``torch.profiler.record_function`` of its label, so a
trace puts each idle gap of the device down to the innermost span.

On the card a span records a CUDA event pair on the current stream and
does not synchronize: only an outermost span waits for the device at its
close, once. That wait maps every event of its tree onto the host clock
(from its open when the stream was idle then, else from the wait's end),
fills in each span's ``device_s`` and ``seconds`` and releases the
events. ``Phase.seconds`` runs from the span's open to the later of its
host close and the device's completion of its work.

:data:`COUNTERS` counts, process-wide, the host's waits for the device
(``host_waits``, and the seconds they blocked, ``host_wait_s``: reads
back, copies from the host larger than :data:`UPLOAD_MAX`, synchronizing
ops and the outermost spans' waits), the copies from the host that do
not wait (``uploads``, :func:`upload`) and the outermost ``prove`` spans
closed (``proves``). Both are counted on every device, so that CPU runs
count what the card does. :data:`LAYER_SPANS` keeps, beside them, the
spans that carry counts (an MSM's, a transform's), for readers that have
no ``Metrics``. ``kernels.reset_counts()`` clears them with the launch
counts.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

SETUP = "setup"
PROVE = "prove"
VERIFY = "verify"
KEEP_SPANS = 1 << 15     # a span log holds 32,768 to 65,536 of the newest
# bytes: a copy from the host up to this size is staged and does not wait.
# A steady prove's are small (constants, challenges, blinds, its inputs);
# set-up's SRS tables, generator candidates and key columns are larger and
# stay synchronous, as do the lookup tables' keys from k = 19 on (an
# (n, 2) int64 column, uploaded once per key at its first prove)
UPLOAD_MAX = 1 << 22
STAGING_SLOTS = 16       # slots of UPLOAD_MAX bytes in a card's ring

COUNTERS: Dict[str, float] = {"host_waits": 0, "host_wait_s": 0.0,
                              "uploads": 0, "proves": 0}
# the newest KEEP_SPANS spans that carry counts (each outermost MSM's and
# transform's: ``.msm``, ``.ntt``), closed since the counters' last
# reset, process-wide as COUNTERS; a span's device_s is filled in when
# its outermost span closes
LAYER_SPANS: collections.deque = collections.deque(maxlen=KEEP_SPANS)


def reset_counters() -> None:
    COUNTERS.update(host_waits=0, host_wait_s=0.0, uploads=0, proves=0)
    LAYER_SPANS.clear()


def count_wait(t0: float, n: int = 1) -> None:
    """Count `n` host waits that began at perf_counter() time `t0`."""
    COUNTERS["host_waits"] += n
    COUNTERS["host_wait_s"] += time.perf_counter() - t0


@contextlib.contextmanager
def host_wait(n: int = 1):
    """The block as `n` host waits for the device (an op that
    synchronizes: a boolean-mask index, a truth test of a tensor)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        count_wait(t0, n)


def read(t: torch.Tensor) -> np.ndarray:
    """`t` as a numpy array on the host: one host wait, counted."""
    t0 = time.perf_counter()
    out = t.detach().cpu().numpy()
    count_wait(t0)
    return out


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """Host tensor `t` on `device`, the one way a host tensor reaches the
    card. Up to :data:`UPLOAD_MAX` bytes it is one upload, counted: on the
    card `t` is copied into the device's :class:`_Staging` ring of pinned
    memory and from there enqueued on the current stream, so the host
    does not wait. A larger copy is a plain ``t.to(device)``, which from
    pageable memory drains the stream first: one host wait, counted."""
    device = torch.device(device)
    if t.nbytes > UPLOAD_MAX:
        t0 = time.perf_counter()
        out = t.to(device)
        count_wait(t0)
        return out
    COUNTERS["uploads"] += 1
    if device.type != "cuda":
        return t.to(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    ring = _STAGING.get(index)
    if ring is None:
        ring = _STAGING[index] = _Staging()
    return ring.put(t, device, index)


class _Staging:
    """A ring of pinned host memory for the copies to one card, allocated
    at its first upload and never grown: STAGING_SLOTS slots of
    UPLOAD_MAX bytes, each with its own CUDA event (not torch's caching
    host allocator, whose pool grows with the copies in flight). Copies
    are packed into the open slot. When one does not fit, or the current
    stream changes, the slot's event is recorded on the stream its copies
    went to, and the next slot opens once its event has passed: a slot is
    written again only after the copies from it have run. A steady prove
    stages well under a slot (its constants, challenges, blinds and
    inputs) and ends in a synchronize, so in a steady run the event has
    passed; where it has not, the wait is counted."""

    ALIGN = 256

    def __init__(self):
        self.buf = torch.empty(STAGING_SLOTS * UPLOAD_MAX, dtype=torch.uint8,
                               pin_memory=True)
        self.host = self.buf.numpy()            # the same bytes
        self.events = [torch.cuda.Event() for _ in range(STAGING_SLOTS)]
        self.slot = self.used = 0
        self.handle = self.stream = None        # the open slot's stream

    def put(self, t: torch.Tensor, device: torch.device,
            index: int) -> torch.Tensor:
        # numpy's copy and views, a raw stream handle: torch's copy_,
        # views and Stream objects cost several times their host time.
        # The copy's source is a numpy view: torch does not know it is
        # pinned (the driver does, so the copy is async), and the ring's
        # events, not torch's, keep the bytes until the copy has run
        src = t.numpy()
        n = src.nbytes
        handle = torch._C._cuda_getCurrentRawStream(index)
        if self.used + n > UPLOAD_MAX or handle != self.handle:
            if self.used:
                self._next_slot()
            self.handle = handle
            self.stream = torch.cuda.current_stream(device)
        at = self.slot * UPLOAD_MAX + self.used
        self.used += -(-n // self.ALIGN) * self.ALIGN
        staged = self.host[at:at + n].view(src.dtype).reshape(src.shape)
        np.copyto(staged, src)
        return torch.from_numpy(staged).to(device, non_blocking=True)

    def _next_slot(self) -> None:
        self.events[self.slot].record(self.stream)
        self.slot = (self.slot + 1) % STAGING_SLOTS
        self.used = 0
        ev = self.events[self.slot]
        if not ev.query():          # (one never recorded has passed)
            t0 = time.perf_counter()
            ev.synchronize()
            count_wait(t0)


_STAGING: Dict[int, _Staging] = {}      # device index -> its ring


@dataclass
class Phase:
    label: str
    seconds: float
    host_s: float = 0.0                 # open to close on the host
    device_s: Optional[float] = None    # its event pair's interval
    parent: Optional[str] = None
    prove: int = 0                      # id of its outermost span
    launches: int = 0
    waits: int = 0
    counts: Optional[Dict[str, int]] = None     # an MSM's or NTT's sizes


class _Span:
    __slots__ = ("metrics", "label", "root", "tree", "id", "t0",
                 "stream", "ev0", "ev1", "idle", "launches0", "waits0",
                 "phase")


_OPEN: contextvars.ContextVar = contextvars.ContextVar("zkodst_span",
                                                       default=None)
_IDS = itertools.count(1)
_NOTHING = contextlib.nullcontext()
_LAUNCH_COUNTS: Optional[Dict[str, int]] = None     # build.LAUNCHES


def _launches() -> int:
    global _LAUNCH_COUNTS
    if _LAUNCH_COUNTS is None:
        from ..kernels import build

        _LAUNCH_COUNTS = build.LAUNCHES
    return sum(_LAUNCH_COUNTS.values())


def _on_card() -> bool:
    return torch.cuda.is_initialized()


def _event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


@contextlib.contextmanager
def _opened(metrics, label: str, parent: Optional[_Span],
            counts: Optional[Dict[str, int]]):
    sp = _Span()
    sp.metrics, sp.label = metrics, label
    sp.root = sp if parent is None else parent.root
    sp.id = next(_IDS) if parent is None else sp.root.id
    sp.tree = [] if parent is None else None
    sp.launches0, sp.waits0 = _launches(), COUNTERS["host_waits"]
    sp.ev0 = sp.ev1 = None
    if _on_card():
        if parent is None or parent.root.stream is None:
            sp.stream = torch.cuda.current_stream()
            sp.idle = sp.stream.query()
        else:
            sp.stream = parent.root.stream
        sp.ev0 = _event(sp.stream)
    elif parent is None:
        sp.stream = None
    rf = (torch.profiler.record_function(label)
          if torch.autograd._profiler_enabled() else None)
    if rf is not None:
        rf.__enter__()
    token = _OPEN.set(sp)
    sp.t0 = time.perf_counter()
    try:
        yield sp
    finally:
        t1 = time.perf_counter()
        if sp.ev0 is not None:
            sp.ev1 = _event(sp.stream)
        _OPEN.reset(token)
        if rf is not None:
            rf.__exit__(None, None, None)
        sp.phase = Phase(label, t1 - sp.t0, host_s=t1 - sp.t0,
                         parent=None if parent is None else parent.label,
                         prove=sp.id, launches=_launches() - sp.launches0,
                         counts=counts)
        sp.root.tree.append((sp, t1))
        if parent is None:
            _resolve(sp)
        sp.phase.waits = int(COUNTERS["host_waits"] - sp.waits0)
        metrics.phases.append(sp.phase)
        if counts is not None:
            LAYER_SPANS.append(sp.phase)


def _resolve(root: _Span) -> None:
    """The outermost span's close: wait for the device once, map every
    event of the tree onto the host clock, release them."""
    tree, root.tree = root.tree, None
    if _on_card():
        if root.ev1 is None:            # the card came up inside the span
            root.ev1 = _event(torch.cuda.current_stream())
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        count_wait(t0)
        t_sync = time.perf_counter()
        root.phase.seconds = t_sync - root.t0
        if root.ev0 is not None and root.idle:
            def done(ev):
                return root.t0 + root.ev0.elapsed_time(ev) / 1e3
        else:
            def done(ev):
                return t_sync - ev.elapsed_time(root.ev1) / 1e3
        for sp, t1 in tree:
            if sp.ev0 is not None and sp is not root:
                sp.phase.seconds = max(t1, done(sp.ev1)) - sp.t0
            if sp.ev0 is not None:
                sp.phase.device_s = sp.ev0.elapsed_time(sp.ev1) / 1e3
            sp.ev0 = sp.ev1 = None
    if root.label == PROVE:
        COUNTERS["proves"] += 1


def span(name: str, **counts: int):
    """A sub-span of the open span, labelled ``<parent>.<name>``, with
    `counts` kept on its phase. Does nothing when no span is open."""
    parent = _OPEN.get()
    if parent is None:
        return _NOTHING
    return _opened(parent.metrics, f"{parent.label}.{name}", parent,
                   counts or None)


class SpanLog:
    """The spans closed, oldest first, as a list that holds between `keep`
    and twice `keep` of the newest: its length and indices count every
    span ever appended, so that ``log[n:]``, `n` its length before a
    prove, reads that prove's spans while they are held."""

    def __init__(self, keep: int = KEEP_SPANS):
        self.keep, self.first = keep, 0
        self._held: List[Phase] = []

    def append(self, ph: Phase) -> None:
        if len(self._held) >= 2 * self.keep:
            del self._held[:self.keep]
            self.first += self.keep
        self._held.append(ph)

    def __len__(self) -> int:
        return self.first + len(self._held)

    def __iter__(self):
        return iter(self._held)

    def __reversed__(self):
        return reversed(self._held)

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, _ = i.indices(len(self))
            return self._held[max(start - self.first, 0):
                              max(stop - self.first, 0)]
        if i < 0:
            i += len(self)
        if i < self.first:
            raise IndexError(f"span {i} was dropped (held from "
                             f"{self.first})")
        return self._held[i - self.first]


@dataclass
class Metrics:
    phases: SpanLog = field(default_factory=SpanLog)
    values: Dict[str, float] = field(default_factory=dict)
    echo: bool = True                # print Start:/End: lines per phase

    @contextlib.contextmanager
    def phase(self, label: str):
        """A span under its full `label`, nested in the open span if any;
        echoed as Start:/End: lines."""
        if self.echo:
            print(f"Start: [{label}]", flush=True)
        parent = _OPEN.get()
        with _opened(self, label, parent, None) as sp:
            yield
        if self.echo:
            print(f"End:   [{label}] {sp.phase.seconds * 1e3:.1f} ms",
                  flush=True)

    def record(self, key: str, value: float) -> None:
        self.values[key] = value

    def seconds(self, label: str) -> Optional[float]:
        """The last time of phase `label`, None if it never ran."""
        for ph in reversed(self.phases):
            if ph.label == label:
                return ph.seconds
        return None

    def tree(self, label: str = PROVE) -> List[Dict]:
        """The spans of the last outermost span `label` closed, in the
        order they closed, each as a dict of its :class:`Phase`; empty if
        none closed."""
        root = next((p for p in reversed(self.phases)
                     if p.label == label and p.parent is None), None)
        return [] if root is None else \
            [asdict(p) for p in self.phases if p.prove == root.prove]

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
