"""Time kernel 9 (``seg_step``) at the MSM's shapes on a CUDA card, for
PERF.md: one JSON line a reading and, last, one of them all with the
card's name and power limit.

    python3 -m zkodst_tpu_torch.tools.step_timing

Inputs are random field words (the complete addition is the same
instructions whatever its operands), made on the card from a seed:

- the natural form (``seg_step(p, q, keep)``), which every tree of the
  port has: the windows' carry step of a KZG commitment at c = 13,
  (20, 24, 8192) with a quarter of its elements adding, of an IPA or Pasta
  MSM, (40, 24, 8192) likewise, and the suffix scan's step, (80, 24,
  8192) with all but chain 0's 16 elements adding; BN254 and pallas;
- where the tree has them (``ec.SEG_TILE``), the forms the MSM calls: the
  windows' step gathered and in place (each element reads one of 2048
  chain carries) and the suffix scan's chains form in place (512 chains
  of 16, chain-major), each at the tiles of TILES (0: the tile the
  kernel picks for the form: a block a round in the chains form, one
  wave of blocks in the others).

Each reading has its bound: the larger of the bytes the form moves over
3.35 TB/s and its adds' 32-bit multiply results over SMs × 64 × the
maximum SM clock. To compare two checkouts, run this file from each in
turns (parent, change, change, parent) with that checkout first on the
path; the package it times is the one it imports:

    PYTHONPATH=. python3 <this checkout>/zkodst_tpu_torch/tools/step_timing.py

Times are medians of CUDA-event timings, each call queued behind a spin
kernel so that the wrapper's host time does not count.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
POINT_BYTES = 96
EC_ADD_OPS = 12 * (2 * 2 * 64 + 8)      # 32-bit multiply results an add
# (name, rows, share of elements adding) at n = 8192
CALLS = [("kzg_windows", 20, 0.25), ("ipa_windows", 40, 0.25),
         ("suffix_scan", 80, None)]
TILES = [0, 128, 512, 2048]
N, W_WINDOWS, W_SUFFIX = 8192, 2048, 512


def _time_ms(fn, reps: int = 7) -> float:
    import torch

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


def _words(g, rows, n):
    """Random canonical limbs of both curves' fields as packed (rows, 24,
    n) int32."""
    import torch

    x = torch.randint(0, 1 << 32, (rows, 24, n), device="cuda",
                      dtype=torch.int64, generator=g)
    x[:, 7::8] %= 0x30000000               # below both moduli
    return (x - ((x >= 1 << 31).to(torch.int64) << 32)).to(torch.int32)


def _bound_ms(nbytes, adds, rate) -> float:
    return max(nbytes / HBM_BYTES_PER_S, adds * EC_ADD_OPS / rate) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("step_timing: CUDA is not available", file=sys.stderr)
        return 1
    from zkodst_tpu_torch import bench
    from zkodst_tpu_torch.kernels import ec
    from zkodst_tpu_torch.ops import curve

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    rate = bench.int32_rate(dev)
    forms = hasattr(ec, "SEG_TILE")
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    recs = []
    for name, rows, share in CALLS:
        p, q = _words(g, rows, N), _words(g, rows, N)
        if share is None:               # chain 0 of 512 keeps its 16
            keep = torch.zeros((rows, N), dtype=torch.bool, device="cuda")
            keep[:, :N // W_SUFFIX] = True
        else:
            keep = torch.rand((rows, N), device="cuda", generator=g) >= share
        adds = int((~keep).sum())
        natural = (rows * N + 3 * POINT_BYTES * adds
                   + 2 * POINT_BYTES * (rows * N - adds))
        for cv in (curve.BN254, curve.PASTA):
            rec = {"call": name, "curve": cv.name, "shape": [rows, 24, N],
                   "adds": adds, "density": adds / (rows * N),
                   "natural_ms": _time_ms(
                       lambda: ec.seg_step(p, q, keep, cv)),
                   "natural_bound_ms": _bound_ms(natural, adds, rate)}
            if forms:
                saved = ec.SEG_TILE
                if share is None:
                    fs = torch.full((rows, W_SUFFIX), N // W_SUFFIX,
                                    dtype=torch.int64, device="cuda")
                    fs[:, 0] = 0
                    carry = q[:, :, :W_SUFFIX].contiguous()
                    x = p.clone()
                    run = lambda: ec.seg_step(x, carry, curve=cv, fs=fs,
                                              out=x)
                    nbytes = fs.numel() * 8 + 3 * POINT_BYTES * adds
                    rec["form"] = "chains, in place"
                else:
                    carry = q[:, :, :W_WINDOWS].contiguous()
                    tl = torch.sort(torch.randint(
                        0, W_WINDOWS, (rows, N), device="cuda",
                        generator=g), dim=1).values
                    x = p.clone()
                    run = lambda: ec.seg_step(x, carry, keep, cv, out=x,
                                              q_index=tl)
                    nbytes = rows * N + (8 + 3 * POINT_BYTES) * adds
                    rec["form"] = "gathered, in place"
                rec["form_bound_ms"] = _bound_ms(nbytes, adds, rate)
                try:
                    for tile in TILES:
                        ec.SEG_TILE = tile
                        rec[f"tile_{tile}_ms"] = _time_ms(run)
                finally:
                    ec.SEG_TILE = saved
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    print(json.dumps({"card": card, "int32_rate": rate,
                      "seg_tile": getattr(ec, "SEG_TILE", None),
                      "readings": recs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
