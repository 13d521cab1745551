"""A ``torch.profiler`` trace of a few steady proves, reduced to what the
benchmark reports: the device's busy seconds (the union of its kernel,
copy and fill intervals) in the traced window, the device operations
that took most time, the longest idle gaps by what the host was doing,
and the port's kernel records by wrapper, which are held against the
program's own launch counts over the same proves: CUPTI on an H100
sometimes drops a run of kernel records, and a trace with holes is
taken again rather than read."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional

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
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if w1 > prev:
        gaps.append((prev, w1))
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
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        red = reduce_events(events)
        rec = red["kernel_records"]
        lost = {k: counted.get(k, 0) - rec.get(k, 0)
                for k in set(counted) | set(rec)
                if counted.get(k, 0) != rec.get(k, 0)}
        red.update(lost=lost, retakes=attempt, counted=counted)
        if not lost:
            return red
        log(f"trace {attempt + 1}: the profiler's kernel records differ "
            f"from the launch counts by {lost}; taking it again")
    return red
