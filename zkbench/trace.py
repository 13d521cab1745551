"""A ``torch.profiler`` trace of a few steady proves, reduced to what the
benchmark reports: the device's busy seconds (the union of its kernel,
copy and fill intervals) in the traced window, the device operations
that took most time, the longest idle gaps by what the host was doing,
and the port's kernel records by wrapper, which are held against the
program's own launch counts over the same proves: CUPTI on an H100
sometimes drops a run of kernel records, and a trace with holes is
taken again rather than read.

One process's profiler sees only its own kernels. Where several client
processes share the card, each traces the same window
(:func:`trace_until`) and the parent merges their intervals on the
machine's monotonic clock (:func:`merge`), so one client's kernels are
not counted as the card's idle time in another's trace."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW_SPAN = "zkbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10

# a device kernel's name -> the wrapper that launches it; the binop
# kernel's operation (0 mul, 1 add, 2 sub) picks among three wrappers
KERNEL_WRAPPERS = {
    "chain_cumprod_kernel": "chain_cumprod",
    "cumprod_tile_kernel": "cumprod_tile",
    "ntt_tail_kernel": "ntt_tail", "ntt_head_kernel": "ntt_head",
    "ec_add_kernel": "ec_add", "seg_step_kernel": "seg_step",
    "seg_scan_tiles_kernel": "seg_scan_tiles",
    "chain_scan_kernel": "chain_scan_local",
    "scale_reduce_kernel": "scale_reduce",
    "blake2f_place_kernel": "blake2f_advice",
    "blake2f_compress_kernel": "blake2f_compress"}
BINOPS = {"0": "mulmod", "1": "addmod", "2": "submod", "kMul": "mulmod",
          "kAdd": "addmod", "kSub": "submod"}


def wrapper_of(kernel: str) -> Optional[str]:
    if "binop_kernel" in kernel:
        op = re.search(r"Op\)(\d)|OpE(\d)|\b(kMul|kAdd|kSub)\b", kernel)
        return BINOPS[next(g for g in op.groups() if g)] if op else "binop?"
    return next((w for k, w in KERNEL_WRAPPERS.items() if k in kernel),
                None)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events: List[Dict]) -> Dict:
    """Chrome-trace events -> {busy_s, window_s, device_ops, idle_gaps,
    kernel_records}."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in xs if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    dev, by_name = [], defaultdict(float)
    records = Counter()
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[e["name"]] += (t - s) / 1e6
        if e.get("cat") == "kernel":
            w = wrapper_of(e["name"])
            if w is not None:
                records[w] += 1
    busy = _union(dev)
    gaps = _gaps(busy, w0, w1)
    spans = [e for e in xs if e.get("cat") == "user_annotation"
             and e.get("tid") == win.get("tid") and e is not win]
    ops = sorted((e for e in xs if e.get("cat") in HOST_OPS
                  and e.get("tid") == win.get("tid")),
                 key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in ops]
    idle = defaultdict(float)
    for s, t in gaps:
        idle[_host_label(spans, ops, starts, (s + t) / 2)] += (t - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(t - s for s, t in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n[:120], v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]],
            "kernel_records": dict(records)}


def _gaps(busy, w0: float, w1: float) -> List:
    """The idle [start, end) stretches of [w0, w1] between merged busy
    intervals."""
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps


def _covers(e: Dict, at: float) -> bool:
    return float(e["ts"]) <= at < float(e["ts"]) + float(e["dur"])


def _host_label(spans: List[Dict], ops: List[Dict], starts: List[float],
                at: float, back: int = 64) -> str:
    """The innermost span and the innermost host operation (of the last
    `back` to start) running at `at`."""
    span = max((e for e in spans if _covers(e, at)),
               key=lambda e: float(e["ts"]), default=None)
    i = bisect.bisect_right(starts, at)
    op = next((ops[j] for j in range(i - 1, max(-1, i - 1 - back), -1)
               if _covers(ops[j], at)), None)
    parts = [x["name"] for x in (span, op) if x is not None]
    return " > ".join(parts) if parts else "host (no span)"


def trace_proves(prove: Callable[[int], None], proves: int,
                 launches: Callable[[], Dict[str, int]],
                 reset: Callable[[], None], tries: int = 3,
                 log=print) -> Dict:
    """prove(j) for j < `proves` under the profiler, up to `tries` times
    until the trace's kernel records equal the program's launch counts.
    Returns the reduced trace with ``lost`` (the records the last trace
    lacks, {} when whole) and ``retakes``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(tries):
        torch.cuda.synchronize()
        reset()
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                for j in range(proves):
                    prove(attempt * proves + j)
                torch.cuda.synchronize()
        counted = {k: v for k, v in launches().items() if v}
        red = reduce_events(_events(prof))
        lost = _lost(counted, red["kernel_records"])
        red.update(lost=lost, retakes=attempt, counted=counted)
        if not lost:
            return red
        log(f"trace {attempt + 1}: the profiler's kernel records differ "
            f"from the launch counts by {lost}; taking it again")
    return red


def _lost(counted: Dict[str, int], records: Dict[str, int]) -> Dict:
    """The launches the trace's kernel records lack (or have beyond the
    counts), by wrapper."""
    return {k: counted.get(k, 0) - records.get(k, 0)
            for k in set(counted) | set(records)
            if counted.get(k, 0) != records.get(k, 0)}


def _events(prof) -> List[Dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.remove(path)


def trace_until(prove: Callable[[int], None],
                arm: Callable[[], Tuple[float, float]],
                launches: Callable[[], Dict[str, int]],
                reset: Callable[[], None]) -> Dict:
    """One client's share of a trace of several prover processes on one card:
    once the profiler has started, arm() gives the common window (start,
    until) on ``time.perf_counter``, which is CLOCK_MONOTONIC and so one
    clock for every process of the machine; prove(j) for j = 0, 1, …
    from `start` until `until`. Returns, on that clock, the window's
    open, this process's device intervals (start, end, name) and its
    spans (name, start, end), with its launch counts (``counted``), its
    kernel records held against them (``lost``) and the proves made. The
    trace's own times are mapped onto the clock through the window
    span's open."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    reset()
    j = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start, until = arm()
        while time.perf_counter() < start:
            time.sleep(0.001)
        t_open = time.perf_counter()
        with record_function(WINDOW_SPAN):
            while time.perf_counter() < until:
                prove(j)
                j += 1
            torch.cuda.synchronize()
    counted = {k: v for k, v in launches().items() if v}
    xs = [e for e in _events(prof) if e.get("ph") == "X" and "dur" in e]
    win = next(e for e in xs if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation")
    off = t_open - float(win["ts"]) / 1e6

    def clock(e):
        s = float(e["ts"]) / 1e6 + off
        return s, s + float(e["dur"]) / 1e6

    device, records = [], Counter()
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            device.append((*clock(e), e["name"][:120]))
            w = wrapper_of(e["name"]) if e.get("cat") == "kernel" else None
            if w is not None:
                records[w] += 1
    spans = [(e["name"], *clock(e)) for e in xs
             if e.get("cat") == "user_annotation"
             and e.get("tid") == win.get("tid") and e is not win]
    return {"open": t_open, "until": until, "device": device,
            "spans": spans, "counted": counted,
            "lost": _lost(counted, records), "proves": j}


def _shares(intervals) -> Dict[str, float]:
    """Each (start, end, name)'s share of the union of the intervals, by
    name: every stretch of time split evenly among the intervals in
    flight over it. Two contexts' kernels that a trace shows overlapping
    ran in turns (time-slicing), so neither is credited with the whole
    stretch, and the shares sum to the union's length."""
    edges = sorted((t, k, i) for i, (s, e, _) in enumerate(intervals)
                   for t, k in ((s, 1), (e, 0)))
    out: Dict[str, float] = defaultdict(float)
    live: set = set()
    prev = None
    for t, k, i in edges:
        if live and t > prev:
            each = (t - prev) / len(live)
            for j in live:
                out[intervals[j][2]] += each
        prev = t
        (live.add if k else live.discard)(i)
    return out


def merge(traces: List[Dict]) -> Dict:
    """The clients' shares of one trace (:func:`trace_until`) as one
    card's: busy seconds (the union of every client's device intervals)
    in the window in which every client was tracing; the device
    operations that took most of that busy time, each stretch of it split
    evenly among the operations in flight (:func:`_shares`); the longest
    idle gaps by what each client's host was doing (its innermost span);
    and the launch counts and proves summed over the clients."""
    w0 = max(t["open"] for t in traces)
    w1 = min(t["until"] for t in traces)
    lost = {f"client {c}: {k}": v for c, t in enumerate(traces)
            for k, v in t["lost"].items()}
    if w1 <= w0:            # a client's profiler opened after the window
        lost["no common window"] = 1
        w1 = w0
    dev = []
    for t in traces:
        for s, e, name in t["device"]:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                dev.append((s, e, name))
    busy = _union((s, e) for s, e, _ in dev)
    idle = defaultdict(float)
    for s, e in _gaps(busy, w0, w1):
        at = (s + e) / 2
        label = " | ".join(
            f"client {c}: " + max(((sp[1], sp[0]) for sp in t["spans"]
                                   if sp[1] <= at < sp[2]),
                                  default=(0, "host (no span)"))[1]
            for c, t in enumerate(traces))
        idle[label] += e - s
    counted = Counter()
    for t in traces:
        counted.update(t["counted"])
    return {"busy_s": sum(e - s for s, e in busy), "window_s": w1 - w0,
            "device_ops": [[n, v] for n, v in sorted(
                _shares(dev).items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[n, v] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]],
            "lost": lost, "counted": dict(counted),
            "proves": sum(t["proves"] for t in traces)}
