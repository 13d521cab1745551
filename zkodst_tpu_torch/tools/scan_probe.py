"""Probe what bounds the two scans on a CUDA card, for PERF.md.

    python3 -m zkodst_tpu_torch.tools.scan_probe

1. Time per step of dependent chains in one warp alone on the card
   (``cuda/csrc/probe_ec.cu``): a
   chain of complete adds, each add's 12 products in one thread or split
   over 2 or 4 lanes (kernel 10's ``SplitLayer``), and a chain of
   Montgomery products, one or two independent chains in one thread.
2. ``seg_scan_tiles`` at the main path's shapes, rows without starts (its
   slow case) and with sparse starts: the wrapper's layout (a row spread
   over a cluster of blocks) against one block a row (the same kernel at
   cluster size 1, which needs runs twice as long where a row would
   exceed one block).
3. ``chain_cumprod`` at the main path's shapes against the same scan with
   each chunk staged through shared memory by coalesced ``cp.async``
   copies, with one or two chunk buffers (``cuda/csrc/probe_mulmod.cu``);
   the outputs must be equal.
4. ``cumprod_tile`` at m = 2048 on a cluster of 1, 2, 4, 8 and 16 blocks:
   a contiguous (2048, 8) column, and the path's call (the exclusive
   products of the run totals of a chain of 73·2^17 elements, read at a
   stride), both directions, each held to its twin; and the chain floor,
   its products in series times one warp's time per product (1.).

The probe sources are built here with nvcc, in parallel. Prints a line
per reading and, last, one JSON object of them all with the card's name
and power limit. Times are medians of CUDA-event timings, each launch
queued behind a spin kernel.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from ..kernels import build, ec, mulmod
from ..ops.field import FQ, FR

STEPS_ADD, STEPS_MUL = 1000, 12000
# (rows, lanes) of seg_scan_tiles on the flagship main path
PATH_SHAPES = [(80, 2048), (70, 2048), (60, 2048), (20, 2048), (80, 512),
               (70, 512), (60, 512), (20, 512), (896, 16), (896, 8)]


def _time_ms(fn, reps: int = 7) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _field_words(g, shape, F=FQ) -> torch.Tensor:
    """Random canonical limbs of F, int32, on the card."""
    x = torch.randint(0, 1 << 32, shape + (8,), device="cuda",
                      dtype=torch.int64, generator=g)
    x[..., 7] %= F.p >> 224
    return (x - ((x >= 1 << 31).to(torch.int64) << 32)).to(torch.int32)


def _probe_libs() -> dict:
    """Build probe_ec.cu and probe_mulmod.cu in parallel and load them."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("probe_ec", "probe_mulmod"):
        out = build.BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        procs[name] = (out, subprocess.Popen(
            [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(build.CSRC), "-o", str(out),
             str(build.CSRC / f"{name}.cu")]))
    libs = {}
    for name, (out, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc failed on {name}.cu")
        libs[name] = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in ("zk_probe_add_chain", "zk_probe_mul_chain"):
        getattr(libs["probe_ec"], fn).argtypes = [P, P, I, I, P]
    libs["probe_mulmod"].zk_probe_chain_staged.argtypes = [
        P, P, ctypes.c_longlong, ctypes.c_longlong, I, I, P]
    return libs


def _launch(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__}: cudaError {err}")


def latency(lib, g) -> dict:
    """µs per dependent step of each chain."""
    p = _field_words(g, (6,))
    o = torch.empty(32 * 24, dtype=torch.int32, device="cuda")
    out = {}
    for name, fn, arg, steps in (
            [(f"add_{k}_lanes_us", lib.zk_probe_add_chain, k, STEPS_ADD)
             for k in (1, 2, 4)] +
            [(f"mul_{k}_chains_us", lib.zk_probe_mul_chain, k, STEPS_MUL)
             for k in (1, 2)]):
        out[name] = _time_ms(lambda: _launch(
            fn, p.data_ptr(), o.data_ptr(), steps, arg)) * 1e3 / steps
        print(f"{name}: {out[name]:.4f} µs a step", flush=True)
    return out


def layouts(g) -> list:
    """seg_scan_tiles ms in the wrapper's layout and in one block a row."""
    recs = []
    for B, n in PATH_SHAPES:
        P = _field_words(g, (B, 3, n)).permute(0, 1, 3, 2).reshape(B, 24, n)
        for starts in ("none", "sparse"):
            f = (torch.rand((B, n), device="cuda", generator=g) < 0.12
                 if starts == "sparse" else
                 torch.zeros((B, n), dtype=torch.bool, device="cuda"))
            rec = {"shape": [B, n], "starts": starts}
            for name, row, block in (("cluster", ec.SCAN_ROW_THREADS,
                                      ec.SCAN_BLOCK),
                                     ("one_block", 128, 256)):
                saved = ec.SCAN_ROW_THREADS, ec.SCAN_BLOCK
                ec.SCAN_ROW_THREADS, ec.SCAN_BLOCK = row, block
                try:
                    rec[f"{name}_layout"] = list(ec._scan_layout(B, n))
                    rec[f"{name}_ms"] = _time_ms(
                        lambda: ec.seg_scan_tiles(P, f))
                finally:
                    ec.SCAN_ROW_THREADS, ec.SCAN_BLOCK = saved
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    return recs


def staging(lib, g) -> list:
    """chain_cumprod ms read in place against staged through shared memory
    with 1 and 2 chunk buffers, at the path's shapes (W = 2048)."""
    recs = []
    for n in (73 << 17, 10 << 19, 1 << 17):
        x = _field_words(g, (n,), FR)
        want = mulmod.chain_cumprod(FR, x, 2048)
        rec = {"elements": n, "W": 2048,
               "in_place_ms": _time_ms(
                   lambda: mulmod.chain_cumprod(FR, x, 2048))}
        for stages in (1, 2):
            o = torch.empty_like(x)
            go = lambda: _launch(lib.zk_probe_chain_staged, x.data_ptr(),
                                 o.data_ptr(), 2048, n // 2048, 0, stages)
            rec[f"staged_{stages}_ms"] = _time_ms(go)
            if not torch.equal(o, want):
                raise RuntimeError(f"staged chain_cumprod ({stages} "
                                   f"buffers) differs at n={n}")
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def tile_clusters(g, us_per_product: float) -> dict:
    """cumprod_tile ms at m = 2048 on each cluster size, and its floor."""
    W, S = 2048, 73 << 17 >> 11
    col = _field_words(g, (W,), FR)
    local = _field_words(g, (W * S,), FR)
    calls = {"column": (col, {}),
             "path_prefix": (local, dict(m=W, stride=S, offset=S - 1,
                                         exclusive=True)),
             "path_suffix": (local, dict(m=W, stride=S, offset=0,
                                         reverse=True, exclusive=True))}
    recs = []
    saved = mulmod.TILE_CLUSTER
    try:
        for cluster in (1, 2, 4, 8, 16):
            mulmod.TILE_CLUSTER = cluster
            rec = {"cluster": cluster,
                   "threads": mulmod.tile_layout(W)[1]}
            for name, (x, kw) in calls.items():
                got = mulmod.cumprod_tile(FR, x, **kw)
                if not torch.equal(got.cpu(), mulmod.cumprod_tile_plain(
                        FR, x, **kw).cpu()):
                    raise RuntimeError(f"cumprod_tile {name} differs from "
                                       f"its twin at cluster {cluster}")
                rec[f"{name}_ms"] = _time_ms(
                    lambda: mulmod.cumprod_tile(FR, x, **kw))
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    finally:
        mulmod.TILE_CLUSTER = saved
    chain = mulmod.tile_serial_products(W)
    floor = {"products_in_series": chain,
             "us_per_product": us_per_product,
             "chain_floor_ms": chain * us_per_product / 1e3}
    print(json.dumps(floor), flush=True)
    return {"by_cluster": recs, **floor}


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = _probe_libs()
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    lat = latency(libs["probe_ec"], g)
    print(json.dumps({"card": card, "latency": lat,
                      "cumprod_tile": tile_clusters(
                          g, lat["mul_1_chains_us"]),
                      "seg_scan_tiles": layouts(g),
                      "chain_cumprod": staging(libs["probe_mulmod"], g)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
