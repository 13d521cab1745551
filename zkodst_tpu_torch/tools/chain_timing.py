"""Time kernel 11 (``chain_scan_local``) on the MSM windows' pass on a
CUDA card, for PERF.md: one JSON line a curve and, last, one of them all
with the card's name and power limit.

    python3 -m zkodst_tpu_torch.tools.chain_timing

The inputs are a window pass of ``msm_many`` at 2^17 points: random field
words as the (n, 3, 8) point table (the complete addition is the same
instructions whatever its operands) and the digits of random 253-bit
scalars as c = 13 windows, sorted as ``msm_many`` sorts them: 80 rows
(4 scalar vectors × 20 windows) on BN254, 40 on pallas, W = 2048 chains
of 64. Two ways to the same chain-major local scan, held equal limb for
limb:

- the points gathered per window, as the MSM did before kernel 11 read
  them through the index: the table packed (24, n), the sorted indices
  and starts transposed chain-major, the points gathered into a (24,
  rows, n) tensor and copied to (rows, 24, n) order, then the dense form;
- the gathered form: the kernel reads each point through the sorted
  index from the table, the flags in sorted order.

Each is timed as a whole and by part, with the bound of the kernel's
adds (32-bit multiply results over SMs × 64 × the maximum SM clock; the
kernel moves ~0.2 kB an add, far under the bytes' bound). The ptxas
registers of each instance come from the build. Times are medians of
CUDA-event timings, each queued behind a spin kernel so that the
wrappers' host time does not count.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys

EC_ADD_OPS = 12 * (2 * 2 * 64 + 8)      # 32-bit multiply results an add
N, W, C_BITS, NWIN = 1 << 17, 2048, 13, 20
ROWS = {"bn254": 80, "pallas": 40}      # the MSM's largest pass a curve


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


def _table(g, n):
    """Random canonical limbs of both curves' fields as (n, 3, 8) int32."""
    import torch

    x = torch.randint(0, 1 << 32, (n, 3, 8), device="cuda",
                      dtype=torch.int64, generator=g)
    x[..., 7] %= 0x30000000                # below both moduli
    return (x - ((x >= 1 << 31).to(torch.int64) << 32)).to(torch.int32)


def _registers(ptxas: str) -> dict:
    """ptxas' registers and spilled bytes of each chain_scan_kernel
    instance, by its template arguments."""
    out, key = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            key = None if "chain_scan_kernel" not in fn else (
                ("pallas" if "Pallas" in fn else "bn254") + "."
                + ("gathered" if "Lb1E" in fn else "dense"))   # <C, true>
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if key and m:
            out[f"{key}.spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out[f"{key}.registers"] = int(m.group(1))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chain_timing: CUDA is not available", file=sys.stderr)
        return 1
    from zkodst_tpu_torch import bench
    from zkodst_tpu_torch.kernels import build, ec
    from zkodst_tpu_torch.ops import curve, msm

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    rate = bench.int32_rate(dev)
    g = torch.Generator(device="cuda")
    g.manual_seed(23)
    table = _table(g, N)
    recs = []
    for cv in (curve.BN254, curve.PASTA):
        rows = ROWS[cv.name]
        sc = torch.randint(0, 1 << 32, (rows // NWIN, N, 8), device="cuda",
                           dtype=torch.int64, generator=g)
        sc[..., 7] &= (1 << 29) - 1
        skeys, sidx = msm._sort_windows(sc, C_BITS, NWIN)
        starts = msm._starts(skeys)
        S = N // W

        def chain_major(x):
            return x.reshape(rows, W, S).transpose(1, 2).reshape(rows, N)

        def old_glue():
            pts = curve.pack(table)[0]
            sidx_p, starts_p = chain_major(sidx), chain_major(starts)
            return pts[:, sidx_p].permute(1, 0, 2).contiguous(), starts_p

        pts = curve.pack(table)[0]
        sidx_p, starts_p = chain_major(sidx), chain_major(starts)
        dense_in, _ = old_glue()
        old = ec.chain_scan_local(dense_in, starts_p, W, curve=cv)
        new = ec.chain_scan_local(table, starts, W, curve=cv, index=sidx)
        torch.cuda.synchronize()
        adds = int((~starts).sum()) - int((~starts[:, ::S]).sum())
        rec = {"curve": cv.name, "shape": [rows, 24, N], "W": W,
               "equal": bool(torch.equal(old, new)),
               "adds": adds,
               "bound_ms": adds * EC_ADD_OPS / rate * 1e3,
               "old_pack_ms": _time_ms(lambda: curve.pack(table)),
               "old_transposes_ms": _time_ms(
                   lambda: (chain_major(sidx), chain_major(starts))),
               "old_gather_copy_ms": _time_ms(
                   lambda: pts[:, sidx_p].permute(1, 0, 2).contiguous()),
               "old_dense_kernel_ms": _time_ms(
                   lambda: ec.chain_scan_local(dense_in, starts_p, W,
                                               curve=cv)),
               "old_total_ms": _time_ms(
                   lambda: ec.chain_scan_local(*old_glue(), W, curve=cv)),
               "gathered_kernel_ms": _time_ms(
                   lambda: ec.chain_scan_local(table, starts, W, curve=cv,
                                               index=sidx))}
        del dense_in, old, new
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    print(json.dumps({"card": card, "int32_rate": rate,
                      "registers": _registers(build.build().ptxas["ec"]),
                      "readings": recs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
