"""The CLI's ``bench`` command: staged JSON lines, the last complete line
wins. Counterpart of the repository's root ``bench.py``, on the card.

  line 1: blake2f_witness_throughput   B = 8192 EIP-152 compressions
          through ``kernels/blake2.blake2f_compress`` (kernel 14 on the
          card, ``ops/blake2.blake2f`` off it; always printed first)
  line 2: blake2f_prove_throughput     n_inst ÷ the best of N warm proves
          at k = 17 (setup from the cache), verify, the last timed
          prove's phases
  line 3: blake2f_prove_throughput     line 2 plus the golden check of the
          seed-2 proof, the flagship mock check, the halo2ce golden check
          where its fixture exists, and the DP-scale run: back-to-back
          independent proves on this one card until
          ZKODST_BENCH_SCALE_INSTANCES instances are proved

Off the card (``--device cpu``) only line 1 runs, unless
ZKODST_BENCH=prove. On the card a failure of the prove stage raises after
line 1 has printed; a failure of a line-3 check prints the line with
``stage3_failure`` and returns 1. Times are seconds, unrounded. Line 3's
``launches`` are the twelve ported Pallas kernels' counts from setup on;
its ``blake2f_launches`` are kernels 13 and 14's in line 1 (``line1``)
and from setup on (``from_setup``).

Environment: ZKODST_BENCH=auto|prove|witness, ZKODST_BENCH_DEADLINE (s,
default 3600), ZKODST_BENCH_INSTANCES (default 37), ZKODST_BENCH_REPEATS
(default 5), ZKODST_BENCH_SCALE_INSTANCES (default 1024; 0 disables),
ZKODST_PROFILE=<dir> (a ``torch.profiler`` trace of the last timed prove).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
import traceback

import numpy as np
import torch

from . import api, kernels
from .circuit import mock
from .kernels import blake2 as kblake2
from .ops import blake2, u64
from .utils.device import resolve
from .utils.timing import profiler_trace, upload

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "golden")
# 32-bit integer operations per compression (the reference's count): 12
# rounds × 2 vectorized G steps × 4 u64 lanes × ~76 operations on the
# 32-bit pairs (6 adds ≈ 6, 4 xors ≈ 2, 4 rotations ≈ 8 a lane), plus the
# message schedule's gathers and the finalization ≈ 8.2e3
OPS_PER_COMPRESSION = 8.2e3
INT32_PER_SM_CLOCK = 64          # 32-bit integer multiply-adds / SM / clock


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _smi(dev: torch.device, query: str) -> str:
    """One ``nvidia-smi --query-gpu`` answer for the card of `dev`."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
         "-i", str(index)], capture_output=True, text=True,
        check=True).stdout.strip()


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    device's type off the card."""
    return _smi(dev, "name,power.limit") if dev.type == "cuda" else dev.type


def int32_rate(dev: torch.device) -> float:
    """The card's 32-bit integer operations per second: SMs × 64 a clock
    × the maximum SM clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(_smi(dev, "clocks.max.sm").split()[0])
    return sms * INT32_PER_SM_CLOCK * mhz * 1e6


def eip152_batch(dev: torch.device, batch: int):
    """`batch` copies of the EIP-152 vector's h, m, t (int64 pairs) and f
    (bool) on `dev`, each contiguous."""
    v = blake2.EIP152_VECTOR

    def pairs(words, n):
        one = torch.from_numpy(u64.from_ints(words).astype(np.int64))
        return upload(one, dev).expand(batch, n, 2).contiguous()

    return (pairs(v["h"], 8), pairs(v["m"], 16), pairs(v["t"], 2),
            torch.ones((batch,), dtype=torch.bool, device=dev))


def bench_witness(dev: torch.device, batch: int = 8192, iters: int = 20,
                  oracle_calls: int = 50):
    """`batch` copies of the EIP-152 vector through
    ``kblake2.blake2f_compress`` on `dev`: one call to warm up, `iters`
    timed, then `oracle_calls` of the Python-int oracle. Returns (line 1,
    the last call's h' (batch, 8, 2))."""
    v = blake2.EIP152_VECTOR
    h, m, t, f = eip152_batch(dev, batch)
    out = kblake2.blake2f_compress(h, m, t, f, 12)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = kblake2.blake2f_compress(h, m, t, f, 12)
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(oracle_calls):
        blake2.blake2f_py(list(v["h"]), list(v["m"]), v["t"], v["f"])
    py_tput = oracle_calls / (time.perf_counter() - t0)
    util = (100 * (batch / dt) * OPS_PER_COMPRESSION / int32_rate(dev)
            if dev.type == "cuda" else None)
    return {
        "metric": "blake2f_witness_throughput",
        "value": batch / dt,
        "unit": "compressions/s",
        "diag": {"vs_python_oracle_x": batch / dt / py_tput,
                 "int32_util_pct": util,
                 "device": card(dev)},
    }, out


def _remaining(deadline: float) -> float:
    return deadline - time.monotonic()


def bench_prove(dev: torch.device, cache_dir: str, deadline: float):
    """Setup from `cache_dir`, a warm-up prove (seed 1), then up to
    ZKODST_BENCH_REPEATS timed proves (seeds 2, 3, ...; fewer when the
    deadline nears), verify. Returns (line 2, the seed-2 proof, the
    pipeline, the inputs (h, m, t, f))."""
    n_inst = int(os.environ.get("ZKODST_BENCH_INSTANCES", "37"))
    n_timed = int(os.environ.get("ZKODST_BENCH_REPEATS", "5"))
    srs_cached = os.path.exists(os.path.join(cache_dir, "srs_bn254_k17.npz"))
    t0 = time.perf_counter()
    pipe = api.setup_blake2f(k=17, n_inst=n_inst, cache_dir=cache_dir,
                             echo=False, device=dev)
    setup_s = time.perf_counter() - t0
    h, m, t, f = api.eip152_inputs(pipe.n_inst)
    t0 = time.perf_counter()
    pipe.prove(h, m, t, f, seed=1)
    warmup_s = time.perf_counter() - t0
    times, proof, inst, first_proof = [], None, None, None
    for i in range(n_timed):
        prof_dir = (os.environ.get("ZKODST_PROFILE")
                    if i == n_timed - 1 else None)
        t0 = time.perf_counter()
        with profiler_trace(prof_dir):
            proof, inst = pipe.prove(h, m, t, f, seed=2 + i)
        times.append(time.perf_counter() - t0)
        if i == 0:
            first_proof = proof
        if _remaining(deadline) < 2 * times[-1]:
            break
    t0 = time.perf_counter()
    if not pipe.verify(inst, proof):
        raise AssertionError("benchmark proof failed verification")
    verify_s = time.perf_counter() - t0
    phases = {ph.label[len("prove."):]: ph.seconds
              for ph in pipe.metrics.phases if ph.label.startswith("prove.")}
    result = {
        "metric": "blake2f_prove_throughput",
        "value": pipe.n_inst / min(times),
        "unit": "instances/s",
        "diag": {
            "instances_per_proof": pipe.n_inst,
            "setup_s": setup_s,
            "warmup_prove_s": warmup_s,
            "timed_proves_s": times,
            "median_prove_s": sorted(times)[len(times) // 2],
            "verify_s": verify_s,
            "srs_cache_hit": srs_cached,
            "last_prove_phases_s": phases,
            "device": card(dev),
        },
    }
    return result, first_proof, pipe, (h, m, t, f)


def _check_flagship_golden(proof: bytes, n_inst: int) -> str:
    """The seed-2 proof against ``tests/golden/flagship_proof_v1.json``:
    "match", "no fixture", "skipped (n_inst=...)"; raises on a
    difference."""
    path = os.path.join(GOLDEN_DIR, "flagship_proof_v1.json")
    if not os.path.exists(path):
        return "no fixture"
    with open(path) as fh:
        golden = json.load(fh)
    if n_inst != 37:
        return f"skipped (n_inst={n_inst})"
    got = hashlib.sha256(proof).hexdigest()
    if got != golden["proof_sha256"]:
        raise AssertionError(
            f"flagship proof diverged from the committed golden: sha256 "
            f"{got} != {golden['proof_sha256']}")
    return "match"


def _check_halo2ce_golden(pipe, h, m, t, f) -> str:
    """One flagship prove in the halo2ce transcript mode against
    ``tests/golden/flagship_proof_halo2ce_v1.json``, verified; "no
    fixture" when that file is absent."""
    if pipe.n_inst != 37:
        return f"skipped (n_inst={pipe.n_inst})"
    path = os.path.join(GOLDEN_DIR, "flagship_proof_halo2ce_v1.json")
    if not os.path.exists(path):
        return "no fixture"
    with open(path) as fh:
        golden = json.load(fh)
    proof, inst = pipe.prove(h, m, t, f, seed=golden["blind_seed"],
                             transcript_mode="halo2ce")
    got = hashlib.sha256(proof).hexdigest()
    if got != golden["proof_sha256"]:
        raise AssertionError(
            f"halo2ce flagship proof diverged from the committed golden: "
            f"sha256 {got} != {golden['proof_sha256']}")
    if not pipe.verify(inst, proof, transcript_mode="halo2ce"):
        raise AssertionError("halo2ce flagship proof failed verification")
    return "match"


def _flagship_circuit_check(pipe, h, m, t, f) -> float:
    """The mock check on the pipeline's circuit: it must pass on the
    honest witness and fail with bit 0 of the middle nonzero cell of the
    first advice column flipped. Returns its wall seconds."""
    t0 = time.perf_counter()
    adv, inst = pipe.witness(h, m, t, f)
    circ, dev = pipe.built.circ, pipe.built.device
    if mock.check(circ, adv, inst, dev):
        raise AssertionError(
            "flagship circuit mock check FAILED on the honest witness")
    col = circ.advice_names[0]
    rows = torch.nonzero(adv[col][:, 0]).flatten()
    bad = dict(adv)
    bad[col] = adv[col].clone()
    bad[col][int(rows[len(rows) // 2]), 0] ^= 1
    if not mock.check(circ, bad, inst, dev):
        raise AssertionError(
            "mock check MISSED a corrupted witness cell (negative test)")
    return time.perf_counter() - t0


def _dp_scale(pipe, best_prove_s: float, done_proves: int,
              done_wall_s: float, deadline: float):
    """Back-to-back independent proofs on this card until
    ZKODST_BENCH_SCALE_INSTANCES instances are proved, the timed proves
    counted; the last one verified. Returns the aggregate, a skip, or
    None when the target is 0."""
    target = int(os.environ.get("ZKODST_BENCH_SCALE_INSTANCES", "1024"))
    if target <= 0:
        return None
    n_proofs = max(0, -(-target // pipe.n_inst) - done_proves)
    if _remaining(deadline) < 1.3 * n_proofs * best_prove_s + 30:
        return {"skipped": f"deadline ({n_proofs} proves needed)"}
    h, m, t, f = api.eip152_inputs(pipe.n_inst)
    t0 = time.perf_counter()
    proof, inst = None, None
    for i in range(n_proofs):
        proof, inst = pipe.prove(h, m, t, f, seed=100 + i)
    wall = time.perf_counter() - t0
    if inst is not None and not pipe.verify(inst, proof):
        raise AssertionError("DP-scale proof failed verification")
    total = (n_proofs + done_proves) * pipe.n_inst
    return {
        "proofs": n_proofs + done_proves,
        "instances_total": total,
        "wall_s": wall + done_wall_s,
        "instances_per_s": total / (wall + done_wall_s),
    }


def main(device=None, cache_dir: str = ".zkodst_cache") -> int:
    """Print the staged lines; the exit code: 0, or 1 after a line-3
    check failed. `device`: CUDA unless the caller names another."""
    deadline = time.monotonic() + float(
        os.environ.get("ZKODST_BENCH_DEADLINE", "3600"))
    mode = os.environ.get("ZKODST_BENCH", "auto")
    dev = resolve(device)
    kernels.reset_counts()
    wit, _ = bench_witness(dev)
    line1_launches = kernels.blake2f_counts()
    print(json.dumps(wit), flush=True)
    if mode == "witness" or (dev.type != "cuda" and mode != "prove"):
        return 0
    kernels.reset_counts()
    result, first_proof, pipe, (h, m, t, f) = bench_prove(dev, cache_dir,
                                                          deadline)
    print(json.dumps(result), flush=True)
    diag = result["diag"]
    try:
        diag["flagship_golden"] = _check_flagship_golden(first_proof,
                                                         pipe.n_inst)
        if _remaining(deadline) > 60:
            diag["mock_check_s"] = _flagship_circuit_check(pipe, h, m, t, f)
        times = diag["timed_proves_s"]
        if _remaining(deadline) > 3 * min(times) + 30:
            diag["halo2ce_golden"] = _check_halo2ce_golden(pipe, h, m, t, f)
        dp = _dp_scale(pipe, min(times), len(times), sum(times), deadline)
        if dp is not None:
            diag["dp_scale"] = dp
    except Exception as e:  # noqa: BLE001 — any check's failure: in the line
        traceback.print_exc()
        diag["stage3_failure"] = f"{type(e).__name__}: {e}"
    diag["launches"] = kernels.counts()
    diag["blake2f_launches"] = {"line1": line1_launches,
                                "from_setup": kernels.blake2f_counts()}
    print(json.dumps(result), flush=True)
    return 1 if "stage3_failure" in diag else 0
