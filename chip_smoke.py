#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``zkodst_tpu_torch/cuda/csrc``,
runs the flagship main path — ``setup_blake2f(k=17, n_inst=37)`` (the SRS
and the proving key made on the card), ``prove`` on the EIP-152 witness
for 37 instances with blind seed 2, and ``verify`` — and checks the SRS
points, the verifying key's transcript digest, the 37 digests and all
4480 proof bytes and their sha256 against
``tests/golden/flagship_proof_v1.json``; the port's verifier must accept
the card's proof and reject it with one byte flipped in a point and in a
scalar. It profiles the warm phases, runs setup and prove once more
recording each kernel's calls and shapes, reads each kernel's device time
on that path from a trace of the same run in a process of its own
(``--kzg-trace`` does only that and prints its JSON; each kernel's traced
launches must equal its calls; a trace whose profiler dropped records is
taken again in a new process, up to three times), then holds every kernel against its plain
PyTorch version at each shape that run gave it, times both, and prints
one JSON line of kernel
records (with each kernel's registers, stack frame and spills as ptxas
reports them, scale_reduce's dependent steps and time per step, and
cumprod_tile's cluster, dependent products and time per product), the
device time of one ``FR.inv_batch`` of 73·2^17 elements (kernels 4, 5 and 1
and whatever else it launches, each kernel's traced launches held to its
wrapper's count, and no launch that moves a whole column) and the
operands the binop wrappers copied whole on the main path, and, last,
``{"ok": true, "device": {...}}``. Kernels 4 and 5 are also held to
their twins in both directions (and kernel 5 inclusive and exclusive) at
every shape the path gave them. Kernel 9's calls are recorded by form
(natural, gathered, chains; in place where the path writes in place, and
replayed so), each call's add density (adds / elements) is logged for
the KZG and IPA paths and kept in the kernel line, and its bound counts
what the form moves: its flags, three points (and the carry's index) an
add, and the kept elements only where they are moved.
The ``inv_batch`` runs in a process of its own (``--inv-batch`` does only
that and prints its JSON).

Then the rest of the single-device API, each phase with the kernel counts
set to 0 just before it and read just after, each printing a JSON line of
its own: ``mock`` (the flagship witness satisfies the circuit; with one
``w`` cell and one ``pub`` output cell flipped it fails a gate and a copy;
its wall time, launches and peak memory; its binop calls held to their
twins), ``chain`` (a 3-block message through the gadget, proved with the
flagship key, verified, its chain read back from the proved public column
and a forged middle block rejected), ``halo2ce`` (the flagship proved and
verified in that transcript mode, rejected with a point byte flipped, its
sha256), ``cache`` (two setups from one cache directory: the golden vk
digest both times, no file written by the second, the golden proof from
it), ``native_verify`` (the golden proof through the native verifier core
and through Python ints, three runs each) and ``cli`` (``python -m
zkodst_tpu_torch prove`` and ``vectors`` in subprocesses), then ``bench``
(``python -m zkodst_tpu_torch bench`` from the ``cache`` phase's files in
a process of its own: exit 0, the witness throughput first, the prove
throughput last with the golden seed-2 proof, the mock check, at least
1024 instances in its DP-scale run and all twelve kernels launched; its
lines are logged). Two more phases drive the IPA commitment backend,
each with the counts set to 0 before it: ``ipa`` (``setup_blake2f(k=17, n_inst=37, scheme="ipa")``
with no cache; 70 generators against the host hash to the curve; the
EIP-152 proof with blind seed 2, 5600 bytes, twice and byte-equal,
verified, rejected with a byte of L_1 or of a₀ flipped and as the KZG
flagship proof; all twelve kernels launched and each held to its twin at
its largest IPA shape the KZG path does not give it; the warm phases
profiled; the path traced by kernel in a process of its own
(``--ipa-trace``, taken again as the KZG path's is), each kernel's
traced launches equal to its calls; one
opening timed against its MSMs alone, and its U and H terms on the card
against the host; the toy circuit's IPA proof on the card against the JAX
package's sha256; the flagship IPA proof against the port's own pin) and
``pasta`` (commit, open and verify
of one polynomial on the pallas curve at K = 3, against the JAX
package's bytes, and at K = 10 and K = 17 (2^17 generators, the
flagship's n) against the port's pins, each rejected with a byte flipped
and with a wrong value; the MSMs on the pallas instances of kernels 9–12,
kernel 8 on pallas at most PASTA_EC_ADD_MAX times; every Pasta
instantiation of kernels 1–3 and 8–12 held to its twin at each of the
phase's shapes; an empty kernel timed beside them). The kernel line and
its ptxas records list the Pasta instantiations that the phase launched
apart from the BN254 instances. The
``mesh`` phase, after ``bench``, runs the multi-GPU prover on the one card
from the ``cache`` phase's files: the flagship proof sharded over NCCL at
world size 1 and over gloo at world size 2 (two processes on cuda:0),
each rank a process of its own (``--mesh-rank BACKEND CACHE_DIR``, under
the ``torch.distributed`` variables the phase sets): on every rank the
golden bytes, verified, a second proof equal, its launches counted, its
peak memory, and each kernel held to its twin at its largest shape that a
single-device prove does not give it; then ``python -m
torch.distributed.run --nproc-per-node 2 -m zkodst_tpu_torch prove --mesh
2`` (gloo, no seed) must print ``"verified": true``. The kernels are built
once, fresh, by this process; the processes it starts load that build.

Kernels 13 and 14 (``cuda/csrc/blake2f.cu``) replace no Pallas kernel:
they run the round loops that the JAX package compiles with XLA, the
circuit's witness (written into its columns, ``blake2f_advice``, or as a
stream, ``blake2f_witness``) and the batched compression. Kernel 13's
advice form is on every proof's path (its launches are counted with the
twelve's on each path, each of its recorded calls held to its plain
version over the whole columns, and a warm flagship witness must launch
it once and take at most WITNESS_MAX_LAUNCHES device operations in its
trace); the ``blake2f`` phase holds both forms to their plain versions at
rounds 0 and 1 too and times the stream form at the flagship's size, kernel
14 on the EIP-152 appendix vectors, then runs the ``bench`` command's line
1 (8192 compressions) with the counts set to 0 before it, holds its h' and
kernel 14 at that shape to the plain version, times it and its wrapper's
host time per call. The ``bench`` phase fails unless the command's own
process launched kernel 14 in line 1 and kernel 13 in its proves.
Any failure exits non-zero before the last line. It imports nothing of JAX or
zkodst_tpu and writes nothing outside the kernel build directories and a
temporary cache directory that it removes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import math
import os
import random
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "flagship_proof_v1.json")
K, N_INST, SRS_SEED, BLIND_SEED = 17, 37, 0, 2
CHAIN_MSG, CHAIN_SEED = b"x" * 300, 9     # 3 blocks (128 + 128 + 44 bytes)
PROOF_BYTES = 4480     # 14 advice, 8 A'/S', 12 Z, 4 h points, 100
                       # evaluations, W and W'
SCALAR_AT = 32 * (14 + 8 + 12 + 4)  # the first evaluation
# the IPA flagship proof: the KZG proof's 4480 bytes less W′, plus the
# opening's 2·17 L/R points, a₀ and ρ_f
IPA_PROOF_BYTES = 4480 - 32 + 34 * 32 + 64
IPA_L1_AT = SCALAR_AT + 100 * 32 + 32    # the first L (after W)
IPA_A0_AT = IPA_PROOF_BYTES - 64
IPA_SAMPLE_SEED = 17                     # the generators sampled
# the JAX package's IPA proof of the toy circuit (k = 5, blind seed 3):
# tests/test_torch_ipa_pipeline.py pins the same string
TOY_IPA_SHA256 = \
    "488377f10558d62a9833b7178e144e45d9294d18e332a90ffcd0b84225e75321"
TOY_IPA_BYTES = 1280
# the port's own pin of the flagship IPA proof (blind seed 2), from its
# first card runs: the JAX IPA pipeline has no run at k = 17 (its keygen
# takes hours on a CPU), so this is not the reference's
FLAGSHIP_IPA_SHA256 = \
    "b0d0bac1f6122db034e611869baa1dc0281e3fca25537632eb13a9b503ad12bc"
# the pasta phase's openings by K, sha256 of the commitment and the proof:
# at K = 3 the JAX package's opening of tests/test_ipa_pasta.py's inputs,
# as tests/test_torch_ipa_pasta.py pins it; at K = 10 and K = 17 (random
# coefficients) the port's own pins from its card runs, the JAX package
# having no run at those sizes
PASTA_PINS = {
    3: "45ec9cce8eb33a67d7b2aaf18b264418dfae711658e1309df5473a1edc4d9524",
    10: "cbead0527419b08d120f95fa1b68a539303c070d29845c8b17e85298361a1b55",
    17: "eca162d58716465913e49f795aa18882c8332c0ea537870b877ae7956239825d",
}
# the mesh phase's runs on the one card: (backend, ranks); two gloo ranks
# share cuda:0 (NCCL refuses two ranks on one device)
MESH_RUNS = (("nccl", 1), ("gloo", 2))
MESH_TIMEOUT_S = 400                # a run's ranks, or the CLI's, at most
BENCH_TIMEOUT_S = 300               # the bench command at most
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory (data sheet)
POINT_BYTES = 96                    # a projective point: 24 32-bit words
SPIN_CYCLES = 10_000_000            # ~5 ms of card time ahead of a timed call
# 32-bit multiply results in one Montgomery product (8×8 a·b and 8×8 m·p
# wide products, lo and hi halves counted apart, plus 8 m = t·inv), in one
# complete addition (12 products) and in one complete doubling (8)
MULMOD_OPS = 2 * 2 * 64 + 8
EC_ADD_OPS = 12 * MULMOD_OPS
DBL_OPS = 8 * MULMOD_OPS

SOURCES = {
    "mulmod": "zkodst_tpu_torch/cuda/csrc/mulmod.cu",
    "addmod": "zkodst_tpu_torch/cuda/csrc/mulmod.cu",
    "submod": "zkodst_tpu_torch/cuda/csrc/mulmod.cu",
    "chain_cumprod": "zkodst_tpu_torch/cuda/csrc/mulmod.cu",
    "cumprod_tile": "zkodst_tpu_torch/cuda/csrc/mulmod.cu",
    "ntt_tail": "zkodst_tpu_torch/cuda/csrc/ntt.cu",
    "ntt_head": "zkodst_tpu_torch/cuda/csrc/ntt.cu",
    "ec_add": "zkodst_tpu_torch/cuda/csrc/ec.cu",
    "seg_step": "zkodst_tpu_torch/cuda/csrc/ec.cu",
    "seg_scan_tiles": "zkodst_tpu_torch/cuda/csrc/ec.cu",
    "chain_scan_local": "zkodst_tpu_torch/cuda/csrc/ec.cu",
    "scale_reduce": "zkodst_tpu_torch/cuda/csrc/ec.cu",
}
REPLACES = {
    "mulmod": "zkodst_tpu/pallas/mulmod.py:111",
    "addmod": "zkodst_tpu/pallas/mulmod.py:122",
    "submod": "zkodst_tpu/pallas/mulmod.py:132",
    "chain_cumprod": "zkodst_tpu/pallas/mulmod.py:142",
    "cumprod_tile": "zkodst_tpu/pallas/mulmod.py:186",
    "ntt_tail": "zkodst_tpu/pallas/ntt.py:65",
    "ntt_head": "zkodst_tpu/pallas/ntt.py:105",
    "ec_add": "zkodst_tpu/pallas/ec.py:94",
    "seg_step": "zkodst_tpu/pallas/ec.py:100",
    "seg_scan_tiles": "zkodst_tpu/pallas/ec.py:137",
    "chain_scan_local": "zkodst_tpu/pallas/ec.py:180",
    "scale_reduce": "zkodst_tpu/pallas/ec.py:271",
}


# kernels 13 and 14: they replace no Pallas kernel, but the round loops the
# JAX package compiles with XLA (lax.scan); "the twelve" stay the Pallas
# kernels above
B2_SOURCES = {name: "zkodst_tpu_torch/cuda/csrc/blake2f.cu"
              for name in ("blake2f_advice", "blake2f_witness",
                           "blake2f_compress")}
B2_REPLACES = {"blake2f_advice": "zkodst_tpu/circuit/blake2f.py:722",
               "blake2f_witness": "zkodst_tpu/circuit/blake2f.py:513",
               "blake2f_compress": "zkodst_tpu/ops/blake2.py:96"}
# kernel 13's work per instance: the cells' spreads (16-bit bit interleaves,
# four shift-and-mask steps of two operations) in its init phase, a G call
# and its final phase; the 64-bit adds, xors and rotations of a G call (two
# 32-bit operations each) and its dependent steps (the eight lines of G)
SPREAD_OPS = 8
SPREADS_INIT, SPREADS_G, SPREADS_FINAL = 60, 59, 128
G_WORD_OPS, G_STEPS = 13, 8
WITNESS_MAX_LAUNCHES = 8       # device operations of one warm flagship
                               # witness at most: the input copy, the
                               # memset, the kernel (12,780 as eager ops,
                               # 55 with the stream kernel and an eager
                               # scatter)


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A comment line, stamped with the seconds since the script began."""
    print(f"# [{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def call_key(args, kw):
    """A call's shapes and flags: tensors by shape, the rest by value."""
    import torch

    def k(a):
        return tuple(a.shape) if isinstance(a, torch.Tensor) else a
    return tuple(k(a) for a in args) + tuple((n, k(v))
                                             for n, v in sorted(kw.items()))


class Recorder:
    """Wraps each kernel wrapper where the main path looks it up, keeps a
    copy of the inputs of the first call per distinct shape and flags
    (positional arguments, keyword arguments), counts the calls per key
    and keeps the work (bytes, operations) of every call on its own
    inputs."""

    def __init__(self, sites, classify=None):
        self.sites = sites              # name -> [(module, attr)]
        # (name, args, kw) -> the name a call is recorded under, or None
        # for a call that is not recorded
        self.classify = classify or (lambda name, args, kw: name)
        self.calls = {}                 # (name, key) -> args
        self.n = {}                     # (name, key) -> calls
        self.work = {}                  # name -> [(bytes, operations)]
        self.density = {}               # seg_step's key -> [adds / elements]
        self.saved = []

    def __enter__(self):
        for name, places in self.sites.items():
            for mod, attr in places:
                orig = getattr(mod, attr)
                self.saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)

    def _wrap(self, name, fn):
        import torch

        def keep(a):
            return _copy(a) if isinstance(a, torch.Tensor) else a

        def rec(*args, **kw):
            as_name = self.classify(name, args, kw)
            if as_name is None:
                return fn(*args, **kw)
            key = call_key(args, kw)
            if (as_name, key) not in self.calls:
                kept = tuple(keep(a) for a in args)
                # an output written in place stays the operand it is
                self.calls[(as_name, key)] = (kept, {
                    n: kept[0] if n == "out" and args and v is args[0]
                    else keep(v) for n, v in kw.items()})
            self.n[(as_name, key)] = self.n.get((as_name, key), 0) + 1
            self.work.setdefault(as_name, []).append(work(as_name, args, kw))
            if as_name.startswith("seg_step"):
                adds, elements, _ = step_adds(args, kw)
                self.density.setdefault((as_name, key), []).append(
                    adds / elements)
            return fn(*args, **kw)
        return rec


def fresh(args, kw):
    """A recorded call's (args, kw) for one more run: a new output buffer
    in place of a recorded one, so that a kernel and its twin never write
    into one tensor; where the call writes in place (its `out` is its
    first operand), a copy of that operand as both."""
    import torch

    out = kw.get("out")
    if out is not None and args and out is args[0]:
        p = args[0].clone()
        return (p,) + tuple(args[1:]), {**kw, "out": p}
    return args, {n: torch.empty_like(v) if n == "out" and v is not None
                  else v for n, v in kw.items()}


# a device kernel's name in a profiler trace -> its wrapper; the binop
# kernel's template argument Op (0 mul, 1 add, 2 sub) picks among three
TRACE_NAMES = {"chain_cumprod_kernel": "chain_cumprod",
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


def traced_kernel(key: str):
    """The wrapper whose kernel a trace row `key` names, or None for a
    kernel that is not one of the port's."""
    if "binop_kernel" in key:           # demangled "Op)2" or mangled "OpE2"
        op = re.search(r"Op\)(\d)|OpE(\d)|\b(kMul|kAdd|kSub)\b", key)
        return BINOPS[next(g for g in op.groups() if g)] if op else None
    return next((w for k, w in TRACE_NAMES.items() if k in key), None)


def pasta_tag(mangled: str):
    """The Pasta instantiation a kernel's mangled name is (``pasta_fp``,
    ``pasta_fr`` or ``pallas``, as the launch counts tag them), or None
    for a BN254 instance."""
    for key, tag in (("8PallasFp", "pasta_fp"), ("8PallasFr", "pasta_fr"),
                     ("6Pallas", "pallas")):
        if key in mangled:
            return tag
    return None


def ptxas_table(reports):
    """wrapper -> {registers, stack_frame_bytes, spill_bytes, smem_bytes},
    the largest over the wrapper's BN254 instances (Fr and Fq), from the
    ptxas -v reports; a Pasta instance is its own row, under the name its
    launches count as (``seg_step[pallas]``, ``mulmod[pasta_fp]``, …). A
    device function compiled out of line is charged to no wrapper."""
    table = {}
    for rep in reports.values():
        name = None
        for line in rep.splitlines():
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                name = traced_kernel(m.group(1))
                tag = pasta_tag(m.group(1))
                if name is not None and tag is not None:
                    name = f"{name}[{tag}]"
                continue
            if name is None:
                continue
            rec = table.setdefault(name, {"registers": 0,
                                          "stack_frame_bytes": 0,
                                          "spill_bytes": 0, "smem_bytes": 0})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                rec["stack_frame_bytes"] = max(rec["stack_frame_bytes"],
                                               int(m.group(1)))
                rec["spill_bytes"] = max(rec["spill_bytes"], int(m.group(2))
                                         + int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rec["registers"] = max(rec["registers"], int(m.group(1)))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                rec["smem_bytes"] = max(rec["smem_bytes"], int(m.group(1)))
    return table


def serial_steps(args) -> int:
    """Dependent steps of one scale_reduce call: c doublings and one add for
    each window below the top one, in series in every batch row."""
    return (args[1] + 1) * (args[0].shape[2] - 1)


def _copy(t):
    """A copy of `t` that keeps its broadcast (stride-0) dimensions
    broadcast, so a recorded call sees the operands the path gave it."""
    idx = tuple(slice(0, 1) if s == 0 else slice(None) for s in t.stride())
    return t[idx].clone().expand(t.shape)


def _held_bytes(t) -> int:
    """Bytes a tensor really holds: a broadcast dimension counts once."""
    return t.element_size() * math.prod(
        d for d, s in zip(t.shape, t.stride()) if s != 0)


def time_ms(fn, reps: int) -> float:
    """Median of `reps` warm runs, each timed with CUDA events. A spin
    kernel queued first keeps the card busy while the host queues the
    events and `fn`'s launches, so a wrapper's host overhead does not
    open a gap between the events (device time only, where the host keeps
    up with the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def work(name, args, kw=None):
    """(bytes moved, 32-bit multiply results) the call needs on these
    inputs: each input read once (a broadcast constant once, not once per
    element; of a strided read only the elements read), each output
    written once; additions counted where this data needs them (a scan
    adds once per element that continues a segment, seg_step once per
    element that needs its carry: its flags, and three points and the
    carry's index an add; a kept element moved only out of place)."""
    import torch

    name = name.split("[")[0]           # a Pasta instantiation's is its
                                        # kernel's
    if name.startswith("blake2f"):
        return blake2f_work(name, args, kw or {})
    if name in ("mulmod", "addmod", "submod"):
        a, b = torch.broadcast_tensors(args[1], args[2])
        n = a.numel() // 8
        ops = MULMOD_OPS * n if name == "mulmod" else 0
        return _held_bytes(a) + _held_bytes(b) + 32 * n, ops
    if name == "chain_cumprod":
        n, W = args[1].shape[0], args[2]
        return 64 * n, MULMOD_OPS * (n - W)
    if name == "cumprod_tile":
        a = tile_args(args, kw or {})
        m = a["m"]
        read = m - 1 if a["exclusive"] else m   # the last is not needed
        return 32 * (read + m), MULMOD_OPS * max(read - 1, 0)
    if name in ("ntt_tail", "ntt_head"):
        B, n, _ = args[1].shape
        if name == "ntt_tail":
            stages, twiddles = args[3].bit_length() - 1, n // 2
        else:
            stages, twiddles = 1, args[3]
        return 64 * B * n + 32 * twiddles, MULMOD_OPS * B * n // 2 * stages
    p = args[0]
    B, _, n = p.shape
    if name == "ec_add":
        return 3 * POINT_BYTES * B * n, EC_ADD_OPS * B * n
    if name == "seg_step":
        kw = kw or {}
        adds, _, moved = step_adds(args, kw)
        flags = (_held_bytes(kw["fs"]) if kw.get("fs") is not None
                 else B * n)
        index = 8 * adds if kw.get("q_index") is not None else 0
        return (flags + index + 3 * POINT_BYTES * adds
                + 2 * POINT_BYTES * moved, EC_ADD_OPS * adds)
    if name in ("chain_scan_local", "seg_scan_tiles"):
        f = args[1].bool().clone()
        B, n = f.shape
        index = (kw or {}).get("index")
        if name != "chain_scan_local":
            f[:, 0] = True                      # the tile's first lane
        elif index is None:
            f[:, :args[2]] = True               # chain heads
        else:                                   # gathered: sorted order,
            f[:, ::n // args[2]] = True         # each point's index read
        adds = int((~f).sum())
        per = 2 * POINT_BYTES + 1 + (8 if index is not None else 0)
        return per * B * n, EC_ADD_OPS * adds
    if name == "scale_reduce":         # c doublings and an add a window
        c = args[1]
        return (POINT_BYTES * B * (n + 1),
                B * (n - 1) * (c * DBL_OPS + EC_ADD_OPS))
    raise KeyError(name)


def step_adds(args, kw):
    """(adds, elements, kept elements moved) of a seg_step call: in the
    chains form (`fs`) chain l's elements before its first start add, in
    the others those that `keep` does not keep; kept elements are moved
    unless the call writes in place."""
    import torch

    p = args[0]
    B, _, n = p.shape
    fs = kw.get("fs")
    if fs is not None:
        S = n // fs.shape[1]
        adds = int(torch.clamp(fs, max=S).sum())
    else:
        keep = args[2] if len(args) > 2 else kw["keep"]
        adds = int((~keep.bool()).sum())
    moved = 0 if kw.get("out") is p else B * n - adds
    return adds, B * n, moved


def log_density(path, rec) -> dict:
    """Log the add density (adds / elements) of each kernel-9 call a
    Recorder saw, by call shape; returns {shape: [densities]}."""
    out = {}
    for (name, key), ds in sorted(rec.density.items(), key=str):
        shape = " ".join(getattr(k, "name", str(k)) for k in key)
        out[f"{name} {shape}"] = ds
        log(f"{path} path: {name} {shape}: {len(ds)} calls, add density "
            f"{[round(d, 4) for d in ds]}")
    return out


def blake2f_work(name, args, kw):
    """(bytes, 32-bit operations) of kernel 13 or 14 on these inputs: every
    input and output once (the advice form's output is every row of its
    columns: the placed cells and the zeros, each once; its placement
    table is an input); kernel 13's spreads and 64-bit word operations,
    kernel 14's 64-bit word operations (two 32-bit operations each)."""
    import torch

    from zkodst_tpu_torch.kernels import blake2 as kb

    h, m, t, f = args[:4]
    rounds = args[4] if len(args) > 4 else kw.get("rounds", 12)
    held = sum(_held_bytes(x) for x in (h, m, t, f))
    if name in ("blake2f_witness", "blake2f_advice"):
        B = h.shape[0]
        spreads = SPREADS_INIT + 8 * rounds * SPREADS_G + SPREADS_FINAL
        ops = B * (SPREAD_OPS * spreads + 2 * G_WORD_OPS * 8 * rounds)
        if name == "blake2f_witness":
            return held + 16 * B * (kb.n_cells(rounds) + 8), ops
        plan = args[5]
        table = sum(_held_bytes(x) for x in (plan.slots, plan.more,
                                             plan.const_dst, plan.const_val))
        return held + table + 16 * (len(plan.columns) + 1) * plan.n, ops
    n = math.prod(torch.broadcast_shapes(h.shape[:-2], m.shape[:-2],
                                         t.shape[:-2], f.shape))
    # 13 word operations a G call, 3 xors into the work vector, 16 out
    return held + 128 * n, n * 2 * (G_WORD_OPS * 8 * rounds + 19)


def tile_args(args, kw) -> dict:
    """The arguments of a cumprod_tile call by name, m resolved."""
    from zkodst_tpu_torch.kernels import mulmod as kmul

    ba = inspect.signature(kmul.cumprod_tile_plain).bind(*args, **kw)
    ba.apply_defaults()
    if ba.arguments["m"] is None:
        ba.arguments["m"] = ba.arguments["x"].shape[0]
    return ba.arguments


def flag_variants(name, kw):
    """The other directions (and, for cumprod_tile, the other output
    kind) of a recorded call of kernel 4 or 5, as keyword arguments."""
    if name == "chain_cumprod":
        return [{**kw, "reverse": r} for r in (False, True)]
    if name == "cumprod_tile":
        return [{**kw, "reverse": r, "exclusive": e}
                for r in (False, True) for e in (False, True)]
    return []


INV_BATCH_N = 73 << 17     # SHPLONK's inversion: 73 claims × 2^17 points


def inv_batch_trace(F) -> dict:
    """Device time of one warm ``F.inv_batch`` of INV_BATCH_N random
    nonzero elements, from a profiler trace: every kernel it launches
    (the prefix and suffix products' kernels 4, 5 and 1, and any copy or
    fill around them), by wrapper, their sum, each wrapper's traced
    launches beside the launches its wrapper counted, and each other
    launch with its device time beside the least time a launch that
    moves the whole column could take (its 32-byte elements read or
    written once at the card's memory rate)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from zkodst_tpu_torch import kernels

    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    x = torch.randint(1, 1 << 32, (INV_BATCH_N, 8), device="cuda",
                      dtype=torch.int64, generator=g)
    x[:, 7] %= F.p >> 224                       # canonical: below p
    x = (x - ((x >= 1 << 31).to(torch.int64) << 32)).to(torch.int32)
    F.inv_batch(x)
    torch.cuda.synchronize()
    kernels.reset_counts()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        F.inv_batch(x)
        torch.cuda.synchronize()
    counted = {k: c for k, c in kernels.counts().items() if c}
    by, traced, other, launches = {}, {}, [], 0
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
            name = traced_kernel(ev.key) or OTHER
            by[name] = by.get(name, 0.0) + dt / 1e3
            launches += ev.count
            if name == OTHER:
                other.append({"kernel": ev.key[:100], "launches": ev.count,
                              "ms": dt / 1e3})
            else:
                traced[name] = traced.get(name, 0) + ev.count
    return {"elements": INV_BATCH_N, "device_ms": sum(by.values()),
            "launches": launches, "by_kernel": by,
            "traced_launches": traced, "wrapper_launches": counted,
            "other": other,
            "whole_column_ms": 32 * INV_BATCH_N / HBM_BYTES_PER_S * 1e3}


OTHER = "other (copies, flips, fills)"


def inv_batch_faults(inv) -> list:
    """What the inv_batch record shows wrong: a kernel whose traced
    launches differ from its wrapper's count, or another launch that took
    as long as moving the whole column once (a copy, flip, cat or fill of
    it)."""
    out = []
    if inv["traced_launches"] != inv["wrapper_launches"]:
        out.append(f"inv_batch: traced launches {inv['traced_launches']} "
                   f"!= the wrappers' counts {inv['wrapper_launches']}")
    for row in inv["other"]:
        if row["ms"] / row["launches"] >= inv["whole_column_ms"]:
            out.append(f"inv_batch: {row['kernel']} took {row['ms']:.4f} ms "
                       f"in {row['launches']} launches, as long as a pass "
                       f"over the whole column ({inv['whole_column_ms']:.4f} "
                       "ms)")
    return out


def inv_batch_only() -> int:
    """``--inv-batch``: the inv_batch trace alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from zkodst_tpu_torch.kernels import build
    from zkodst_tpu_torch.ops.field import FR as DFR

    build.build()
    print(json.dumps({"inv_batch": inv_batch_trace(DFR)}), flush=True)
    return 0


def inv_batch_apart():
    """Run ``--inv-batch`` in a process of its own and return its record,
    or None. A process of its own: on an H100 a profiler session late in
    this script's process recorded none of the kernels launched before a
    host sync."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--inv-batch"], capture_output=True, text=True,
                         timeout=600)
    for line in out.stdout.splitlines():
        if line.startswith('{"inv_batch"'):
            return json.loads(line)["inv_batch"]
    log(f"inv_batch failed (exit {out.returncode}): "
        f"{out.stderr.strip()[-400:]}")
    return None


def path_trace_only(scheme: str) -> int:
    """``--kzg-trace`` / ``--ipa-trace``: the flagship path of one
    commitment scheme traced by kernel, after one warm setup and prove, one
    profiler session a phase: KZG's ``srs.setup``, keygen and prove (the
    main process's recorded run), IPA's ``ipa.setup``, keygen, prove and
    verify. Prints each kernel's [device ms, traced launches], its
    wrapper's count and the binop rows that name no kernel."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from zkodst_tpu_torch import api, kernels
    from zkodst_tpu_torch.kernels import build
    from zkodst_tpu_torch.proof import ipa, keygen, srs

    build.build()
    inputs = api.eip152_inputs(N_INST)
    pr = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                           scheme=scheme, echo=False, device="cuda")
    proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    traced, unnamed = {}, set()
    kernels.reset_counts()
    params = trace_phase(
        (lambda: ipa.setup(K, device="cuda")) if scheme == "ipa"
        else (lambda: srs.setup(K, seed=SRS_SEED, device="cuda")),
        traced, unnamed)
    pk = trace_phase(lambda: keygen.keygen(params, pr.built.circ), traced,
                     unnamed)
    pr2 = api.Blake2fProver(built=pr.built, params=params, pk=pk,
                            metrics=pr.metrics)
    trace_phase(lambda: pr2.prove(*inputs, seed=BLIND_SEED), traced,
                unnamed)
    if scheme == "ipa":
        trace_phase(lambda: pr2.verify(inst, proof), traced, unnamed)
    counted = {k: c for k, c in path_counts().items() if c}
    print(json.dumps({"path_trace": {"traced": traced, "counted": counted,
                                     "unnamed": sorted(unnamed)}}),
          flush=True)
    return 0


TRACE_TRIES = 3     # processes a path's trace may take to record every launch


def path_trace_apart(scheme: str):
    """Run ``--<scheme>-trace`` in a process of its own, with this
    process's cached blocks given back first, and return (its record or
    None, the records each earlier process lost: wrapper -> launches).
    CUPTI on an H100 sometimes drops a run of kernel records (one NTT's
    seven, a few products), in about one trace in ten, late in this
    script's process and in a fresh one alike; a trace whose records fall
    short of its own process's wrapper counts is taken again in a new
    process, up to TRACE_TRIES times, and the last one is returned."""
    import torch

    torch.cuda.empty_cache()
    lost = []
    for _ in range(TRACE_TRIES):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              f"--{scheme}-trace"], capture_output=True,
                             text=True, timeout=600)
        rec = next((json.loads(line)["path_trace"]
                    for line in out.stdout.splitlines()
                    if line.startswith('{"path_trace"')), None)
        if rec is None:
            log(f"{scheme} trace failed (exit {out.returncode}): "
                f"{out.stderr.strip()[-400:]}")
            return None, lost
        gap = {name: rec["counted"].get(name, 0)
               - rec["traced"].get(name, (0.0, 0))[1]
               for name in set(rec["counted"]) | set(rec["traced"])}
        gap = {name: d for name, d in sorted(gap.items()) if d}
        if not gap:
            return rec, lost
        lost.append(gap)
        log(f"{scheme} trace: the profiler lost launch records {gap}")
    return rec, lost


def trace_faults(scheme, trace, calls) -> list:
    """What a path's trace shows wrong: it failed, a kernel's traced
    launches differ from its wrapper's count in the tracing process or
    from its calls in this one (`calls`: wrapper -> calls), or a binop row
    names no kernel."""
    if trace is None:
        return [f"the {scheme} path's trace failed"]
    out = []
    for name, n in calls.items():
        seen = trace["traced"].get(name, (0.0, 0))[1]
        counted = trace["counted"].get(name, 0)
        if not seen == counted == n:
            out.append(f"{scheme} path: {name}: the trace holds {seen} "
                       f"launches, its wrapper counted {counted} in that "
                       f"process and was called {n} times here")
    if trace["unnamed"]:
        out.append(f"{scheme} path: trace rows naming no kernel: "
                   f"{trace['unnamed']}")
    return out


def profile_warm(label_fns) -> dict:
    """Each (label, fn) once warm, then once under the profiler: its wall
    time, its device kernels' time and launches and the device's idle
    share (1 − kernel time ÷ wall), logged with its eight longest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    profile = {}
    for label, fn in label_fns:
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        rows = []
        for ev in prof.key_averages():
            dt = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if ev.device_type == torch.autograd.DeviceType.CUDA and dt > 0:
                rows.append((dt / 1e3, ev.count, ev.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        count = sum(r[1] for r in rows)
        profile[label] = {"wall_ms": wall_ms, "kernel_ms": busy,
                          "launches": count,
                          "idle_share": 1 - busy / wall_ms if rows else None}
        if rows:
            log(f"profile {label} (warm): wall {wall_ms:.1f} ms, device "
                f"kernels {busy:.2f} ms in {count} launches, device idle "
                f"{100 * (1 - busy / wall_ms):.1f}%")
        else:
            log(f"profile {label} (warm): wall {wall_ms:.1f} ms, device "
                "time not measured (the profiler saw no device kernels)")
        for ms, cnt, key in rows[:8]:
            log(f"  {ms:10.3f} ms {cnt:8d}x  {key[:70]}")
    return profile


def trace_phase(fn, traced, unnamed):
    """fn() under the profiler (one session); each port kernel's device
    time and launches added to `traced` (wrapper -> [ms, launches]), a
    binop row that names no kernel to `unnamed`. Returns fn's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if ev.device_type != torch.autograd.DeviceType.CUDA or dt <= 0:
            continue
        name = traced_kernel(ev.key)
        if name is None:
            if "binop_kernel" in ev.key:
                unnamed.add(ev.key[:120])
            continue
        t = traced.setdefault(name, [0.0, 0])
        t[0] += dt / 1e3
        t[1] += ev.count
    return out


def hold_to_twins(rec, wrappers, plains, imad_rate, failures) -> dict:
    """Every recorded call again, on the kernel and on its twin: equal limb
    for limb (kernels 4 and 5 also in the directions and output kinds the
    path did not give that shape), timed, with its bound. Returns wrapper ->
    [(record, (args, kw))]; appends what differs to `failures`."""
    import torch

    from zkodst_tpu_torch.kernels import mulmod as kmul

    records = {}
    for (name, key), (args, kw) in sorted(rec.calls.items(),
                                          key=lambda kv: str(kv[0])):
        fn, plain = wrappers[name], plains[name]
        # kernels 4 and 5 in the directions (and output kinds) that the
        # path did not give this shape too
        for flags in flag_variants(name, kw):
            if (name, call_key(args, flags)) in rec.calls:
                continue
            a1, f1 = fresh(args, flags)
            out = fn(*a1, **f1)
            a1, f1 = fresh(args, flags)
            ref = plain(*a1, **f1)
            torch.cuda.synchronize()
            said = {k: flags[k] for k in ("reverse", "exclusive")
                    if k in flags}
            if not torch.equal(out.cpu(), ref.cpu()):
                failures.append(f"{name} {key} with {said}: kernel != plain")
            else:
                log(f"{name} {key} with {said}: equal to plain")
            del out, ref
        a1, kw1 = fresh(args, kw)
        out = fn(*a1, **kw1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a1, kw1 = fresh(args, kw)
        ref = plain(*a1, **kw1)
        torch.cuda.synchronize()
        plain_once = (time.perf_counter() - t1) * 1e3
        outs, refs = ((out, ref) if isinstance(out, tuple)
                      else ((out,), (ref,)))
        shaped = all(o.shape == r.shape for o, r in zip(outs, refs))
        err = max((int((o.to(torch.int64) - r.to(torch.int64)).abs().max())
                   if shaped and o.numel() else 0)
                  for o, r in zip(outs, refs))
        if not shaped or err != 0:
            failures.append(f"{name} {key}: kernel != plain (max abs limb "
                            f"difference {err})")
        del out, ref
        nbytes, ops = work(name, args, kw)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / imad_rate * 1e3
        shape = " ".join(getattr(k, "name", str(k)) for k in key)
        a1, kw1 = fresh(args, kw)
        entry = {"shape": shape, "calls": rec.n[(name, key)],
                 "max_abs_err": err,
                 "ms": time_ms(lambda: fn(*a1, **kw1), 7),
                 "plain_ms": plain_once, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"{name} {shape}: {'equal to' if err == 0 else 'DIFFERS from'} "
            f"plain; kernel {entry['ms']:.4f} ms, plain {plain_once:.1f} ms "
            f"(one cold call), bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']})")
        ds = getattr(rec, "density", {}).get((name, key))
        if ds:                          # kernel 9: adds / elements
            entry["add_density"] = sum(ds) / len(ds)
        if name == "scale_reduce":      # latency-bound: its own floor
            entry["serial_steps"] = serial_steps(args)
            entry["us_per_step"] = entry["ms"] * 1e3 / entry["serial_steps"]
            log(f"scale_reduce {shape}: {entry['serial_steps']} dependent "
                f"steps in series, {entry['us_per_step']:.3f} us each")
        if name in ("blake2f_witness", "blake2f_advice"):
            # the longest block's chain: the plain G lines of every
            # half-round up to the last round on a quad of lanes (one G
            # call's cells follow, a warp a part); µs per step from the
            # kernel's own time (blake2f_timing)
            entry["serial_steps"] = G_STEPS * 2 * args[4]
        if name == "cumprod_tile":      # latency-bound: its own floor
            m = tile_args(args, kw)["m"]
            entry["cluster"], entry["threads"] = kmul.tile_layout(m)
            entry["serial_products"] = kmul.tile_serial_products(m)
            entry["us_per_product"] = (entry["ms"] * 1e3
                                       / entry["serial_products"])
        records.setdefault(name, []).append((entry, (args, kw)))
    return records


def kernel_tables():
    """(sites: wrapper -> the (module, attribute) places the path looks it
    up, wrappers: name -> wrapper, plains: name -> its plain twin)."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.kernels import blake2 as kb
    from zkodst_tpu_torch.kernels import ec as kec
    from zkodst_tpu_torch.kernels import mulmod as kmul
    from zkodst_tpu_torch.kernels import ntt as kntt
    from zkodst_tpu_torch.ops import msm
    from zkodst_tpu_torch.ops import ntt as ontt

    sites = {
        "mulmod": [(kmul, "mulmod")],
        "addmod": [(kmul, "addmod")],
        "submod": [(kmul, "submod")],
        "chain_cumprod": [(kmul, "chain_cumprod")],
        "cumprod_tile": [(kmul, "cumprod_tile")],
        "ntt_tail": [(ontt, "ntt_tail")],
        "ntt_head": [(ontt, "ntt_head")],
        "ec_add": [(kec, "ec_add"), (msm, "ec_add")],
        "seg_step": [(msm, "seg_step")],
        "seg_scan_tiles": [(msm, "seg_scan_tiles")],
        "chain_scan_local": [(msm, "chain_scan_local")],
        "scale_reduce": [(msm, "scale_reduce")],
        "blake2f_advice": [(kb, "blake2f_advice")],
    }
    wrappers = {name: fn for name, (fn, _) in kernels.WRAPPERS.items()}
    wrappers["blake2f_advice"] = kb.blake2f_advice
    plains = {"mulmod": kmul.mulmod_plain, "addmod": kmul.addmod_plain,
              "submod": kmul.submod_plain,
              "chain_cumprod": kmul.chain_cumprod_plain,
              "cumprod_tile": kmul.cumprod_tile_plain,
              "ntt_tail": kntt.ntt_tail_plain,
              "ntt_head": kntt.ntt_head_plain,
              "ec_add": kec.ec_add_plain,
              "seg_step": kec.seg_step_plain,
              "seg_scan_tiles": kec.seg_scan_tiles_plain,
              "chain_scan_local": kec.chain_scan_local_plain,
              "scale_reduce": kec.scale_reduce_plain,
              "blake2f_advice": kb.blake2f_advice_plain}
    return sites, wrappers, plains


def path_counts() -> dict:
    """The launches since the last reset of the kernels a proof's path runs:
    the twelve and kernel 13 (the witness into the columns)."""
    from zkodst_tpu_torch import kernels

    return {**kernels.counts(),
            "blake2f_advice": kernels.blake2f_counts()["blake2f_advice"]}


def idle_kernels(launches, names=None) -> list:
    """The kernels of `names` (every kernel when None) that a path did not
    launch."""
    return [k for k in (names or launches) if not launches[k]]


def phase_line(name, record, faults, failures) -> None:
    """Print a phase's JSON line (with its faults) and add its faults to
    `failures`."""
    print(json.dumps({"phase": name, "ok": not faults, "faults": faults,
                      **record}), flush=True)
    failures += [f"{name}: {f}" for f in faults]


def vk_digest(vk) -> str:
    from zkodst_tpu_torch.proof.transcript import Blake2bWrite

    tw = Blake2bWrite()
    vk.hash_into(tw)
    return hex(tw.squeeze_challenge())


def flipped(proof: bytes, at: int) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


def mock_phase(pr, inputs, wrappers, plains, imad_rate):
    """The flagship witness through the mock checker on the card, then the
    same with one ``w`` cell and one ``pub`` output cell flipped; the
    check's binop calls held to their twins. Returns (record, faults)."""
    import torch

    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.circuit import blake2f as bc
    from zkodst_tpu_torch.circuit import mock
    from zkodst_tpu_torch.kernels import mulmod as kmul

    faults = []
    circ = pr.built.circ
    adv, inst = pr.built.witness(*inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_counts()
    t0 = time.perf_counter()
    fails = mock.check(circ, adv, inst, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    peak = torch.cuda.max_memory_allocated() - base
    if fails:
        faults.append(f"the flagship witness fails {[str(f) for f in fails]}")
    idle = idle_kernels(launches, ("mulmod", "addmod", "submod"))
    if idle:
        faults.append(f"kernels not launched: {idle}")
    rows = torch.nonzero(adv["w"][:, 0]).flatten()
    row = int(rows[len(rows) // 2])
    bad_adv = dict(adv, w=adv["w"].clone())
    bad_adv["w"][row, 0] ^= 1
    pub = inst["pub"].clone()
    pub[bc.ROW_OUT, 0] ^= 1
    bad = mock.check(circ, bad_adv, {"pub": pub}, "cuda")
    gate_rows = {int(r) for f in bad if f.kind == "gate" for r in f.rows}
    copy_rows = {int(r) for f in bad if f.kind == "copy" for r in f.rows}
    if {f.kind for f in bad} != {"gate", "copy"} or row not in gate_rows \
            or bc.ROW_OUT not in copy_rows:
        faults.append(f"w[{row}] and pub[{bc.ROW_OUT}] flipped give "
                      f"{[str(f) for f in bad]}")
    binops = {name: [(kmul, name)] for name in ("mulmod", "addmod",
                                                "submod")}
    with Recorder(binops) as rec:
        mock.check(circ, adv, inst, "cuda")
    held = hold_to_twins(rec, wrappers, plains, imad_rate, faults)
    log(f"mock: {wall:.3f} s, {sum(launches.values())} kernel launches "
        f"{launches}, peak {peak / 2**20:.0f} MiB above the path's")
    return {"wall_s": wall, "kernel_launches": launches,
            "blake2f_launches": kernels.blake2f_counts(),
            "peak_mib": peak / 2**20,
            "flipped_w_row": row, "flipped_failures": [str(f) for f in bad],
            "twin_shapes": {k: len(v) for k, v in held.items()}}, faults


def blake2f_timing():
    """The line of ``python -m zkodst_tpu_torch.tools.wrapper_timing``, run
    in a process of its own on this process's build: kernels 13 and 14
    alone from a fresh profiler session (sessions late in this process
    have recorded no kernels), their wrappers' device and host µs a call.
    None if it fails."""
    out = subprocess.run([sys.executable, "-m",
                          "zkodst_tpu_torch.tools.wrapper_timing"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    line = next((json.loads(text) for text in out.stdout.splitlines()
                 if text.startswith('{"card"')), None)
    if line is None:
        log(f"wrapper_timing failed (exit {out.returncode}): "
            f"{out.stderr.strip()[-400:]}")
    return line


def per_step(entry, kernel_us):
    """Kernel 13's entry with its kernel's own time and µs per step of its
    chain (None where not measured)."""
    entry["kernel_ms"] = kernel_us / 1e3 if kernel_us else None
    entry["us_per_step"] = (kernel_us / entry["serial_steps"]
                            if kernel_us and entry["serial_steps"] else None)
    return entry


def blake2f_phase(imad_rate):
    """Kernels 13 and 14 apart from the proof's path: kernel 13's two forms
    on 37 random instances (f mixed) at rounds 0 and 1, the advice form's
    whole columns and the stream each equal to their plain versions, and
    the stream form at the flagship's 12 rounds too, held to its plain
    version, timed, with its bound; kernel 14 on the EIP-152 appendix
    vectors, each equal to its plain version and the vectors to their
    digests; then the ``bench`` command's line 1 (``bench.bench_witness``:
    8192 EIP-152 compressions, 21 calls) with the counts set to 0 just
    before it and read just after, its h' equal to the plain version's and
    the digest, kernel 14 held to its plain version at that shape, timed,
    with its bound, and its wrapper's host µs per call (the kernel queued
    behind a spin kernel). Returns (record, faults, the stream form's and
    kernel 14's entries of the kernel line)."""
    import numpy as np
    import torch

    from zkodst_tpu_torch import bench, kernels
    from zkodst_tpu_torch.circuit import blake2f as bc
    from zkodst_tpu_torch.kernels import blake2 as kb
    from zkodst_tpu_torch.ops import blake2, u64
    from zkodst_tpu_torch.tools import wrapper_timing

    faults, record, entries = [], {}, []
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(13)
    kernels.reset_counts()
    with Recorder({"blake2f_witness": [(kb, "blake2f_witness")]}) as rec:
        for rounds in (0, 1, 12):
            h, m, t = (torch.from_numpy(rng.integers(
                0, 1 << 32, (N_INST, k, 2), dtype=np.int64)).to(dev)
                for k in (8, 16, 2))
            f = torch.from_numpy(rng.integers(0, 2, N_INST)).to(dev)
            got = kb.blake2f_witness(h, m, t, f, rounds)
            want = kb.blake2f_witness_plain(h, m, t, f, rounds)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            record[f"witness_rounds_{rounds}"] = "equal" if same else "DIFFERS"
            if not same:
                faults.append(f"kernel 13's stream at rounds {rounds} "
                              "differs from plain")
            if rounds == 12:
                continue
            lay = bc._Layout()
            bc._schedule(lay, rounds)
            plan = bc._placement(lay, 1 << K, dev)
            same = torch.equal(kb.blake2f_advice(h, m, t, f, rounds, plan),
                               kb.blake2f_advice_plain(h, m, t, f, rounds,
                                                       plan))
            record[f"advice_rounds_{rounds}"] = "equal" if same else "DIFFERS"
            if not same:
                faults.append(f"kernel 13's columns at rounds {rounds} "
                              "differ from plain")
    launches = kernels.blake2f_counts()
    held = hold_to_twins(rec, {"blake2f_witness": kb.blake2f_witness},
                         {"blake2f_witness": kb.blake2f_witness_plain},
                         imad_rate, faults)
    shapes = sorted(held.get("blake2f_witness", []),
                    key=lambda ea: -ea[0]["bound_ms"])
    timing = blake2f_timing() or {}
    record["timing"] = timing
    if shapes:
        top, (args, kw) = shapes[0]
        top["plain_ms"] = time_ms(lambda: kb.blake2f_witness_plain(*args), 3)
        per_step(top, timing.get("stream_kernel_us"))
        entries.append({"name": "blake2f_witness", "route": "cuda",
                        "source": B2_SOURCES["blake2f_witness"],
                        "replaces": B2_REPLACES["blake2f_witness"],
                        "launches": launches["blake2f_witness"], **top,
                        "library_ms": None,
                        "path": "blake2f phase (the stream form)",
                        "other_shapes": [e for e, _ in shapes[1:]]})

    def pairs(words):
        return torch.from_numpy(u64.from_ints(words).astype(np.int64)).to(
            dev)[None]

    vectors = {}
    for v in blake2.EIP152_VECTORS:
        if v.get("expected") is None:
            continue
        rounds, h, m, t, f = blake2.eip152_decode(v["input"])
        args = (pairs(h), pairs(m), pairs(t), torch.tensor([f], device=dev),
                rounds)
        got = kb.blake2f_compress(*args)
        digest = b"".join(int(x).to_bytes(8, "little")
                          for x in u64.to_ints(got[0])).hex()
        ok = (torch.equal(got, kb.blake2f_compress_plain(*args))
              and digest == v["expected"])
        vectors[v["n"]] = "ok" if ok else "FAIL"
        if not ok:
            faults.append(f"kernel 14 on vector {v['n']}: {digest}")
    record["vectors"] = vectors

    kernels.reset_counts()
    line1, out = bench.bench_witness(dev)
    torch.cuda.synchronize()
    launches = kernels.blake2f_counts()
    record["line1"] = line1
    record["line1_launches"] = launches
    if not launches["blake2f_compress"]:
        faults.append(f"line 1 did not launch kernel 14: {launches}")
    inputs = bench.eip152_batch(dev, out.shape[0])
    digest = b"".join(int(x).to_bytes(8, "little")
                      for x in u64.to_ints(out[0])).hex()
    if not torch.equal(out, kb.blake2f_compress_plain(*inputs, 12)) \
            or digest != blake2.EIP152_VECTOR["expected"]:
        faults.append("line 1's h' differs from the plain version's")
    with Recorder({"blake2f_compress": [(kb, "blake2f_compress")]}) as rec:
        kb.blake2f_compress(*inputs, 12)
    held = hold_to_twins(rec, {"blake2f_compress": kb.blake2f_compress},
                         {"blake2f_compress": kb.blake2f_compress_plain},
                         imad_rate, faults)
    host = wrapper_timing.host_us(lambda: kb.blake2f_compress(*inputs, 12),
                                  50)
    record["compress_host_us_per_call"] = host
    for top, (args, kw) in held.get("blake2f_compress", []):
        top["plain_ms"] = time_ms(lambda: kb.blake2f_compress_plain(*args),
                                  3)
        top["calls"] = launches["blake2f_compress"]
        kernel_us = timing.get("compress_kernel_us")
        top["kernel_ms"] = kernel_us / 1e3 if kernel_us else None
        entries.append({"name": "blake2f_compress", "route": "cuda",
                        "source": B2_SOURCES["blake2f_compress"],
                        "replaces": B2_REPLACES["blake2f_compress"],
                        "launches": launches["blake2f_compress"], **top,
                        "library_ms": None, "path": "bench line 1",
                        "compressions_per_s": line1["value"],
                        "host_us_per_call": host})
    checks = {k: v for k, v in record.items()
              if k.startswith(("witness_", "advice_"))}
    log(f"blake2f: kernel 13 {checks}; kernel 14 vectors {vectors}; line 1 "
        f"{line1['value']:.1f} compressions/s in {launches} launches; its "
        f"wrapper {host:.1f} us of host time a call")
    return record, faults, entries


def chain_phase(pr):
    """A 3-block message through the gadget, proved with the flagship key
    and verified; its chain read back from the proved public column.
    Returns (record, faults)."""
    import torch

    from zkodst_tpu_torch import gadget, kernels
    from zkodst_tpu_torch.ops import blake2

    faults = []
    digest, calls = gadget.Blake2b.digest(CHAIN_MSG)
    if digest != hashlib.blake2b(CHAIN_MSG).digest() or len(calls) != 3:
        faults.append(f"gadget: {len(calls)} calls, digest {digest.hex()}")
    kernels.reset_counts()
    t0 = time.perf_counter()
    proof, inst = pr.prove(*gadget.calls_to_arrays(calls,
                                                   pad_to=pr.n_inst),
                           seed=CHAIN_SEED)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = path_counts()
    if idle_kernels(launches):
        faults.append(f"kernels not launched: {idle_kernels(launches)}")
    if not pr.verify(inst, proof):
        faults.append("the verifier rejects the chain's proof")
    proved = gadget.instance_column_calls(pr.built, inst["pub"], len(calls))
    if not gadget.check_chain(proved, len(CHAIN_MSG)) \
            or gadget.chain_digest(proved) != digest:
        faults.append("the proved public column fails the chain rules")
    c1 = proved[1]
    bad_h = tuple(x ^ 1 for x in c1.h)
    forged = [proved[0], gadget.BlockCall(
        h=bad_h, m=c1.m, t=c1.t, f=c1.f, h_out=tuple(blake2.blake2f_py(
            list(bad_h), list(c1.m), c1.t, c1.f))), proved[2]]
    if gadget.check_chain(forged, len(CHAIN_MSG)):
        faults.append("a forged middle block passes the chain rules")
    log(f"chain: 3 blocks proved in {prove_s:.3f} s, {len(proof)} bytes")
    return {"blocks": len(calls), "digest": digest.hex(),
            "prove_s": prove_s, "proof_bytes": len(proof),
            "proof_sha256": hashlib.sha256(proof).hexdigest(),
            "launches": launches}, faults


def halo2ce_phase(pr, inputs):
    """The flagship proved in halo2ce mode with the golden blind seed,
    verified in that mode and rejected with a point byte flipped; warm
    proves of both modes in turns (v1, halo2ce, halo2ce, v1). Returns
    (record, faults)."""
    import torch

    from zkodst_tpu_torch import kernels

    faults = []
    kernels.reset_counts()
    proof, inst = pr.prove(*inputs, seed=BLIND_SEED,
                           transcript_mode="halo2ce")
    torch.cuda.synchronize()
    launches = path_counts()
    if idle_kernels(launches):
        faults.append(f"kernels not launched: {idle_kernels(launches)}")
    if len(proof) != PROOF_BYTES:
        faults.append(f"{len(proof)} bytes")
    if not pr.verify(inst, proof, "halo2ce"):
        faults.append("the halo2ce verifier rejects the proof")
    if pr.verify(inst, flipped(proof, 0), "halo2ce"):
        faults.append("accepts the proof with byte 0 (a point) flipped")
    if pr.verify(inst, proof):
        faults.append("the v1 verifier accepts the halo2ce proof")
    warm = {"v1": [], "halo2ce": []}
    for mode in ("v1", "halo2ce", "halo2ce", "v1"):
        t0 = time.perf_counter()
        again, _ = pr.prove(*inputs, seed=BLIND_SEED, transcript_mode=mode)
        torch.cuda.synchronize()
        warm[mode].append(time.perf_counter() - t0)
        if mode == "halo2ce" and again != proof:
            faults.append("a second halo2ce proof differs from the first")
    sha = hashlib.sha256(proof).hexdigest()
    log(f"halo2ce: {len(proof)} bytes, sha256 {sha}; warm prove v1 "
        f"{warm['v1']} s, halo2ce {warm['halo2ce']} s")
    return {"proof_bytes": len(proof), "proof_sha256": sha,
            "warm_prove_s": warm, "launches": launches}, faults


def native_phase(pr, inst, proof):
    """The golden proof verified through the native core and through
    Python ints (three runs each, median), and rejected with a point or a
    scalar byte flipped. Returns (record, faults)."""
    from zkodst_tpu_torch.proof import verifier

    faults, times = [], {}
    for native in (True, False):
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            ok = verifier.verify_proof(pr.params, pr.pk.vk, inst, proof,
                                       native=native)
            runs.append(time.perf_counter() - t0)
            if not ok:
                faults.append(f"native={native} rejects the golden proof")
        times["native" if native else "python"] = runs
    for at in (0, SCALAR_AT):
        if verifier.verify_proof(pr.params, pr.pk.vk, inst,
                                 flipped(proof, at)):
            faults.append(f"native accepts byte {at} flipped")
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"verify: native {med['native']:.4f} s, Python ints "
        f"{med['python']:.4f} s (median of 3; runs {times})")
    return {"verify_s": times, "median_s": med}, faults


def cache_phase(inputs, golden, cache_dir):
    """Two setups from one cache directory: the golden vk digest both
    times, no file written by the second, and the golden proof from its
    key. Returns (record, faults)."""
    import torch

    from zkodst_tpu_torch import api, kernels

    def listing():
        return sorted((f, os.stat(os.path.join(cache_dir, f)).st_mtime_ns)
                      for f in os.listdir(cache_dir))

    faults, setup_s = [], []
    for i in range(2):
        if i:
            kernels.reset_counts()
        t0 = time.perf_counter()
        pc = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                               cache_dir=cache_dir, echo=False,
                               device="cuda")
        torch.cuda.synchronize()
        setup_s.append(time.perf_counter() - t0)
        if vk_digest(pc.pk.vk) != golden["vk_transcript_digest"]:
            faults.append(f"setup {i + 1}: vk digest differs")
        if not i:
            files = listing()
            del pc
    if listing() != files:
        faults.append("the second setup wrote a file")
    proof, _ = pc.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    launches = path_counts()
    if idle_kernels(launches):
        faults.append(f"kernels not launched: {idle_kernels(launches)}")
    if proof != bytes.fromhex(golden["proof_hex"]):
        faults.append("the proof from the cached key is not golden")
    log(f"cache: setup {setup_s[0]:.3f} s writing, {setup_s[1]:.3f} s "
        f"reading {[f for f, _ in files]}")
    return {"setup_s": setup_s, "files": [f for f, _ in files],
            "launches": launches}, faults


def cli_phase(cache_dir):
    """``python -m zkodst_tpu_torch prove`` (the flagship from the cache)
    and ``vectors`` on the card, in subprocesses. Returns (record,
    faults)."""
    faults, record = [], {}
    env = dict(os.environ, PYTHONPATH=ROOT)
    for cmd in (["prove", "--k", str(K), "--instances", str(N_INST),
                 "--seed", str(BLIND_SEED), "--cache-dir", cache_dir],
                ["vectors", "--device", "cuda"]):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "zkodst_tpu_torch",
                              *cmd], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=900)
        record[cmd[0]] = {"rc": out.returncode,
                          "wall_s": time.perf_counter() - t0}
        lines = out.stdout.strip().splitlines()
        if out.returncode:
            faults.append(f"{cmd[0]} exits {out.returncode}: "
                          f"{out.stderr.strip()[-400:]}")
        elif cmd[0] == "prove":
            last = json.loads(lines[-1])
            record["prove"].update(last)
            if last != {"proof_bytes": PROOF_BYTES, "verified": True}:
                faults.append(f"prove prints {last}")
        else:
            record["vectors"]["lines"] = lines
            if any(f"vector {n}: ok" not in lines for n in (4, 5, 6, 7)):
                faults.append(f"vectors prints {lines}")
    log(f"cli: {record}")
    return record, faults


def bench_phase(cache_dir):
    """``python -m zkodst_tpu_torch bench --cache-dir`` (the ``cache``
    phase's files) in a process of its own, which loads this script's
    build, with no ``ZKODST_*`` variable set: it must exit 0, print the
    witness throughput first and the prove throughput last, the seed-2
    proof golden, the mock check run, at least 1024 instances proved in
    the DP-scale run, and every kernel launched (its own counts, from
    setup on). Returns (record, faults)."""
    import torch

    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ZKODST_")}
    env["PYTHONPATH"] = ROOT
    t0 = time.perf_counter()
    (rc, out, err), = run_apart(
        [[sys.executable, "-m", "zkodst_tpu_torch", "bench", "--cache-dir",
          cache_dir]], [env], cache_dir, "bench", BENCH_TIMEOUT_S)
    record = {"rc": rc, "wall_s": time.perf_counter() - t0}
    for line in out.splitlines():
        log(f"bench: {line}")
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    faults = [] if rc == 0 else [f"bench exits {rc}: {err.strip()[-600:]}"]
    if not lines or lines[0].get("metric") != "blake2f_witness_throughput":
        faults.append("line 1 is not blake2f_witness_throughput")
    if len(lines) < 2 or lines[-1].get("metric") != \
            "blake2f_prove_throughput":
        faults.append("the last line is not blake2f_prove_throughput")
        return record, faults
    record["witness"], record["prove"] = lines[0], lines[-1]
    diag = lines[-1]["diag"]
    if diag.get("flagship_golden") != "match":
        faults.append(f"flagship_golden is {diag.get('flagship_golden')}")
    if "mock_check_s" not in diag:
        faults.append("no mock_check_s")
    total = diag.get("dp_scale", {}).get("instances_total", 0)
    if total < 1024:
        faults.append(f"dp_scale proved {total} instances, not 1024")
    idle = idle_kernels(diag.get("launches", {}), list(SOURCES))
    if idle:
        faults.append(f"kernels not launched by bench: {idle}")
    b2 = diag.get("blake2f_launches", {})
    record["blake2f_launches"] = b2
    if not b2.get("line1", {}).get("blake2f_compress"):
        faults.append(f"line 1 did not launch kernel 14: {b2}")
    if not b2.get("from_setup", {}).get("blake2f_advice"):
        faults.append(f"the proves did not launch kernel 13: {b2}")
    times = diag["timed_proves_s"]
    log(f"bench: witness {lines[0]['value']:.1f} compressions/s; prove "
        f"{lines[-1]['value']:.4f} instances/s, best {min(times):.4f} s, "
        f"median {diag['median_prove_s']:.4f} s; DP scale "
        f"{diag.get('dp_scale')}; {record['wall_s']:.1f} s of wall")
    return record, faults


def mesh_rank() -> int:
    """``--mesh-rank BACKEND CACHE_DIR``: one rank of the ``mesh`` phase,
    under the ``torch.distributed`` variables that phase sets, on cuda:0.
    ``setup_blake2f(k=17, n_inst=37)`` from the cache with a 1-D mesh over
    the job's ranks; the EIP-152 proof with blind seed 2, sharded, its
    launches counted and its bytes held to the golden file; a warm prove
    (the same bytes) and verify; the sharded prove's kernel calls recorded,
    and (rank 0, after the last collective) each kernel held to its twin
    at its largest shape that a single-device prove in this process does
    not give it. Prints one JSON line (``{"mesh_rank": ...}``)."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from zkodst_tpu_torch import api, bench, kernels
    from zkodst_tpu_torch.kernels import build
    from zkodst_tpu_torch.parallel.bootstrap import init_distributed, \
        make_mesh

    backend, cache_dir = sys.argv[2], sys.argv[3]
    dev = init_distributed(backend=backend, device="cuda:0")
    mesh = make_mesh((dist.get_world_size(),), ("x",))
    faults = []
    rec = {"rank": mesh.rank, "backend": backend,
           "world": dist.get_world_size(),
           "transport": "host buffers" if mesh.staged else "device"}
    built = build.build()
    rec["build"] = {"compiled": built.compiled, "s": built.seconds}
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    t0 = time.perf_counter()
    pr = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                           cache_dir=cache_dir, echo=False, device=dev,
                           mesh=mesh, mesh_axis="x")
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    inputs = api.eip152_inputs(N_INST)
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    rec["prove_cold_s"] = time.perf_counter() - t0
    rec["launches"] = path_counts()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["phases_s"] = {ph.label: ph.seconds for ph in pr.metrics.phases}
    rec["proof_bytes"] = len(proof)
    rec["proof_sha256"] = hashlib.sha256(proof).hexdigest()
    if (proof != bytes.fromhex(golden["proof_hex"])
            or rec["proof_sha256"] != golden["proof_sha256"]):
        faults.append(f"rank {mesh.rank}: the sharded proof ({len(proof)} "
                      f"bytes, sha256 {rec['proof_sha256']}) is not the "
                      "golden one")
    # at world size 1 the MSM's partial sums need no addition (kernel 8)
    idle = idle_kernels(rec["launches"],
                        [k for k in rec["launches"]
                         if k != "ec_add" or rec["world"] > 1])
    if idle:
        faults.append(f"rank {mesh.rank}: kernels not launched on the "
                      f"sharded prove: {idle}")
    t0 = time.perf_counter()
    again, _ = pr.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    rec["prove_warm_s"] = time.perf_counter() - t0
    if again != proof:
        faults.append(f"rank {mesh.rank}: a second sharded proof differs")
    t0 = time.perf_counter()
    if not pr.verify(inst, proof):
        faults.append(f"rank {mesh.rank}: the verifier rejects the sharded "
                      "proof")
    rec["verify_s"] = time.perf_counter() - t0
    sites, wrappers, plains = kernel_tables()
    with Recorder(sites) as sharded:
        pr.prove(*inputs, seed=BLIND_SEED)
        torch.cuda.synchronize()
    dist.destroy_process_group()          # the last collective is behind
    log(f"mesh rank {mesh.rank} of {rec['world']} ({backend}): setup "
        f"{rec['setup_s']:.3f} s, prove {rec['prove_cold_s']:.3f} s cold, "
        f"{rec['prove_warm_s']:.3f} s warm, verify {rec['verify_s']:.3f} s,"
        f" peak {rec['peak_bytes'] / 2**30:.2f} GiB; {rec['launches']}")
    if mesh.rank == 0:
        single = api.Blake2fProver(built=pr.built, params=pr.params,
                                   pk=pr.pk, metrics=pr.metrics)
        with Recorder(sites) as one:
            single.prove(*inputs, seed=BLIND_SEED)
            torch.cuda.synchronize()
        rate = bench.int32_rate(torch.device("cuda", 0))
        held = hold_to_twins(largest_new(sharded, set(one.calls), rate),
                             wrappers, plains, rate, faults)
        # a warm prove's calls per kernel, sharded and on one device
        rec["warm_calls"] = {
            label: {name: sum(c for (nm, _), c in r.n.items() if nm == name)
                    for name in wrappers}
            for label, r in (("sharded", sharded), ("single", one))}
        rec["twins"] = {name: [e for e, _ in recs]
                        for name, recs in held.items()}
        rec["shapes_all_single"] = [n for n in wrappers if n not in held]
    rec["faults"] = faults
    print(json.dumps({"mesh_rank": rec}), flush=True)
    return 0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_apart(cmds, envs, logdir, label, timeout):
    """Start each command (one process group each, output to files under
    `logdir`), wait for all of them up to `timeout` seconds in all, kill
    every group still running then. Returns [(exit code or None for a
    killed one, stdout, stderr)]."""
    procs = []
    for i, (cmd, env) in enumerate(zip(cmds, envs)):
        out = open(os.path.join(logdir, f"{label}.{i}.out"), "w+")
        err = open(os.path.join(logdir, f"{label}.{i}.err"), "w+")
        procs.append((subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                       stderr=err, start_new_session=True),
                      out, err))
    deadline = time.monotonic() + timeout
    got = []
    for p, out, err in procs:
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = None
        got.append(rc)
    for p, _, _ in procs:                 # whatever a rank left running
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    res = []
    for rc, (_, out, err) in zip(got, procs):
        out.seek(0)
        err.seek(0)
        res.append((rc, out.read(), err.read()))
        out.close()
        err.close()
    return res


def mesh_phase(cache_dir):
    """The multi-GPU prover on the one card: the flagship proof sharded
    (``--mesh-rank``) over NCCL at world size 1 and over gloo at world size
    2 (two processes on cuda:0), from the cache of the ``cache`` phase,
    each rank's proof the golden bytes and verified, its launches counted,
    each kernel held to its twin at its new shapes (rank 0); then the CLI
    under ``torch.distributed.run --nproc-per-node 2`` with ``--mesh 2``
    (gloo on cuda:0) and no seed must print ``"verified": true``. Returns
    (record, faults)."""
    import torch

    torch.cuda.empty_cache()
    faults, record = [], {}
    base = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="localhost")
    for backend, world in MESH_RUNS:
        label = f"{backend}x{world}"
        port = str(free_port())
        t0 = time.perf_counter()
        got = run_apart(
            [[sys.executable, os.path.abspath(__file__), "--mesh-rank",
              backend, cache_dir]] * world,
            [dict(base, MASTER_PORT=port, WORLD_SIZE=str(world),
                  RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)],
            cache_dir, label, MESH_TIMEOUT_S)
        run = {"wall_s": time.perf_counter() - t0, "ranks": []}
        for r, (rc, out, err) in enumerate(got):
            for line in out.splitlines():
                if line.startswith("#"):
                    print(f"# [{label} rank {r}] {line[2:]}", flush=True)
            rec = next((json.loads(line)["mesh_rank"]
                        for line in out.splitlines()
                        if line.startswith('{"mesh_rank"')), None)
            if rc != 0 or rec is None:
                faults.append(f"{label} rank {r} exits {rc}: "
                              f"{err.strip()[-600:]}")
                continue
            faults += [f"{label}: {f}" for f in rec["faults"]]
            run["ranks"].append(rec)
        record[label] = run
        log(f"mesh {label}: {run['wall_s']:.1f} s of wall for its ranks")
    port = str(free_port())
    t0 = time.perf_counter()
    (rc, out, err), = run_apart(
        [[sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
          "2", "--master-addr", "localhost", "--master-port", port, "-m",
          "zkodst_tpu_torch", "prove", "--k", str(K), "--instances",
          str(N_INST), "--cache-dir", cache_dir, "--mesh", "2", "--device",
          "cuda:0", "--backend", "gloo", "--quiet"]],
        [base], cache_dir, "cli", MESH_TIMEOUT_S)
    last = next((json.loads(line) for line in reversed(out.splitlines())
                 if line.startswith('{"proof_bytes"')), None)
    record["cli"] = {"rc": rc, "wall_s": time.perf_counter() - t0,
                     "prints": last}
    if rc != 0 or last != {"proof_bytes": PROOF_BYTES, "verified": True}:
        faults.append(f"cli --mesh 2 exits {rc}, prints {last}: "
                      f"{err.strip()[-600:]}")
    log(f"mesh cli: {record['cli']}")
    return record, faults


def toy_circuit(k: int = 5):
    """The toy circuit of tests/test_torch_keygen.py (q·(a² − b) = 0,
    a ∈ {0..15}, b[2] copied from b[1]) and its witness on the card."""
    import numpy as np
    import torch

    from zkodst_tpu_torch.circuit.expr import V
    from zkodst_tpu_torch.circuit.ir import CircuitDef, CopyGroup, Gate, \
        Lookup
    from zkodst_tpu_torch.ops import u64

    n = 1 << k

    def u64col(vals):
        out = np.zeros((n, 2), np.uint32)
        out[: len(vals)] = u64.from_ints(list(vals))
        return out

    sel = np.zeros((n, 2), np.uint32)
    sel[:8, 0] = 1
    circ = CircuitDef(
        k=k, advice_names=["a", "b"], instance_names=[],
        fixed={"q": sel, "t": u64col(range(16))},
        gates=[Gate("square", V("q") * (V("a") * V("a") - V("b")))],
        lookups=[Lookup("a_range", ["a"], ["t"])],
        copies=[CopyGroup("b", np.array([1]), "b", np.array([2]))])
    circ.validate()
    a_vals = [(i * 7) % 16 for i in range(8)]
    a_vals[2] = a_vals[1]
    wit = {"a": u64col(a_vals), "b": u64col([v * v for v in a_vals])}
    return circ, {c: torch.from_numpy(v.astype(np.int64)).to("cuda")
                  for c, v in wit.items()}


def largest_new(rec, old_calls, imad_rate):
    """Per wrapper, the recorded call of the largest bound whose shape the
    KZG path's recorded run did not give it: a Recorder-like view of just
    those calls, for hold_to_twins."""
    best = {}
    for (name, key), (args, kw) in rec.calls.items():
        if (name, key) in old_calls:
            continue
        b, o = work(name, args, kw)
        bound = max(b / HBM_BYTES_PER_S, o / imad_rate)
        if name not in best or bound > best[name][0]:
            best[name] = (bound, key)
    view = type("Picked", (), {})()
    view.calls = {(n, k): rec.calls[(n, k)] for n, (_, k) in best.items()}
    view.n = {nk: rec.n[nk] for nk in view.calls}
    return view


def ipa_phase(inputs, kzg_proof, kzg_calls, sites, wrappers, plains,
              imad_rate):
    """The IPA flagship on the card: ``setup_blake2f(scheme="ipa")`` with
    no cache, a sample of the generators against the host hash to the
    curve, the EIP-152 proof (blind seed 2) twice, byte-equal, verified,
    and rejected with a byte of L_1 or of a₀ flipped and as the KZG
    flagship proof; all twelve kernels launched; each kernel held to its
    twin at its largest IPA shape the KZG path did not give it; the warm
    phases profiled; the path traced by kernel (``--ipa-trace``); one
    opening against its MSMs alone and its U and H terms on the card
    against the host's; the toy circuit's IPA proof against the JAX pin;
    the flagship IPA proof against the port's pin. Returns (record,
    faults)."""
    import torch

    from zkodst_tpu_torch import api, kernels
    from zkodst_tpu_torch.ops import msm
    from zkodst_tpu_torch.ops.field import FR as DFR
    from zkodst_tpu_torch.proof import ipa, keygen, prover, verifier
    from zkodst_tpu_torch.proof.transcript import Blake2bWrite

    faults, record = [], {}
    kernels.reset_counts()
    t0 = time.perf_counter()
    pr = api.setup_blake2f(k=K, n_inst=N_INST, scheme="ipa", echo=False,
                           device="cuda")
    proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
    t_ver = time.perf_counter()
    accepted = pr.verify(inst, proof)
    torch.cuda.synchronize()
    record["verify_s"] = time.perf_counter() - t_ver
    record["wall_s"] = time.perf_counter() - t0
    launches = path_counts()
    record["launches"] = launches
    if idle_kernels(launches):
        faults.append(f"kernels not launched: {idle_kernels(launches)}")
    record["phases_s"] = {ph.label: ph.seconds for ph in pr.metrics.phases}
    t1 = time.perf_counter()
    gens = ipa.setup(K, device="cuda")
    torch.cuda.synchronize()
    record["generators_s"] = time.perf_counter() - t1
    if not torch.equal(gens.g, pr.params.g):
        faults.append("a second ipa.setup gives other generators")
    del gens
    log(f"ipa: setup {record['phases_s']['setup']:.3f} s (keygen "
        f"{record['phases_s']['setup.keygen']:.3f} s; the generators alone "
        f"{record['generators_s']:.3f} s), prove "
        f"{record['phases_s']['prove']:.3f} s, verify "
        f"{record['verify_s']:.3f} s; launches {launches}")

    # the generators: a sample, h and u against the host hash to the curve
    cfg = ipa._CFGS["bn254"]
    rnd = random.Random(IPA_SAMPLE_SEED)
    idx = [0, 1, 1 << 16, (1 << K) - 1] + [rnd.randrange(1 << K)
                                          for _ in range(64)]
    got = cfg.dev.to_affine_ints(pr.params.g[torch.tensor(idx,
                                                           device="cuda")])
    want = [ipa._hash_to_curve(cfg.tag, i) for i in idx]
    hu = [ipa._hash_to_curve(cfg.tag[:-1] + c, 0) for c in (b"h", b"u")]
    if got != want or [pr.params.h, pr.params.u] != hu:
        faults.append("generators differ from the host hash to the curve "
                      f"at {[i for i, a, b in zip(idx, got, want) if a != b]}")
    record["generators_checked"] = len(idx) + 2

    # the proof: its size, a second prove, the verifier
    record["proof_bytes"] = len(proof)
    record["proof_sha256"] = hashlib.sha256(proof).hexdigest()
    if len(proof) != IPA_PROOF_BYTES:
        faults.append(f"{len(proof)} bytes, not {IPA_PROOF_BYTES}")
    if record["proof_sha256"] != FLAGSHIP_IPA_SHA256:
        faults.append(f"the flagship IPA proof's sha256 "
                      f"{record['proof_sha256']} is not the port's pin "
                      f"{FLAGSHIP_IPA_SHA256}")
    t1 = time.perf_counter()
    again, _ = pr.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    record["prove_warm_s"] = time.perf_counter() - t1
    if again != proof:
        faults.append("a second proof with the same seed differs")
    if not accepted:
        faults.append("the verifier rejects the IPA proof")
    for what, bad in (("L_1", flipped(proof, IPA_L1_AT)),
                      ("a0", flipped(proof, IPA_A0_AT)),
                      ("the KZG flagship proof", kzg_proof)):
        if pr.verify(inst, bad):
            faults.append(f"the verifier accepts {what}")
    runs = []
    for _ in range(3):
        t1 = time.perf_counter()
        pr.verify(inst, proof)
        runs.append(time.perf_counter() - t1)
    record["verify_warm_s"] = runs
    log(f"ipa: {len(proof)} bytes, sha256 {record['proof_sha256']}; warm "
        f"prove {record['prove_warm_s']:.3f} s, verify {runs} s")

    # warm phases profiled
    adv, _ = pr.witness(*inputs)
    staged = prover.Prover(pr.params, pr.pk, adv, inst, seed=BLIND_SEED)
    staged.advice()
    record["profile"] = profile_warm((
        ("generators", lambda: ipa.setup(K, device="cuda")),
        ("keygen", lambda: keygen.keygen(pr.params, pr.built.circ)),
        ("advice_commit", lambda: pr.commit_advice(adv, seed=BLIND_SEED)),
        ("lookup_permute", staged.lookups),
        ("grand_products_commit", staged.grand_products),
        ("quotient", staged.quotient),
        ("evaluations", staged.evaluations),
        ("multiopen", staged.multiopen),
        ("verify", lambda: pr.verify(inst, proof))))
    del staged

    # the path's device time by kernel from a trace in a process of its own,
    # and its calls and shapes recorded (not traced) here; each kernel's
    # traced launches must equal its calls
    trace, record["trace_lost"] = path_trace_apart("ipa")
    with Recorder(sites) as rec:
        params = ipa.setup(K, device="cuda")
        pk = keygen.keygen(params, pr.built.circ)
        pr2 = api.Blake2fProver(built=pr.built, params=params, pk=pk,
                                metrics=pr.metrics)
        pr2.prove(*inputs, seed=BLIND_SEED)
        pr2.verify(inst, proof)
        torch.cuda.synchronize()
        del params, pk, pr2
    calls = {name: sum(c for (nm, _), c in rec.n.items() if nm == name)
             for name in wrappers}
    faults += trace_faults("ipa", trace, calls)
    record["seg_step_density"] = log_density("ipa", rec)
    traced = trace["traced"] if trace else {}
    path = {}
    for name in wrappers:
        ms = traced.get(name, (0.0, 0))[0]
        path[name] = {"calls": calls[name], "ms": ms, "bound_ms": sum(
            max(b / HBM_BYTES_PER_S, o / imad_rate)
            for b, o in rec.work.get(name, [])) * 1e3}
        log(f"ipa path: {name} {calls[name]} calls, {ms:.3f} ms of device "
            f"time against {path[name]['bound_ms']:.3f} ms at the bound")
    record["path_by_kernel"] = path
    held = hold_to_twins(largest_new(rec, kzg_calls, imad_rate), wrappers,
                         plains, imad_rate, faults)
    record["twins"] = {name: [e for e, _ in recs]
                       for name, recs in held.items()}
    # a kernel whose IPA shapes are all the KZG path's was held to its twin
    # at each of them already
    record["shapes_all_kzg"] = [name for name in wrappers
                                if name not in held]
    del rec

    # the opening on one random polynomial: the whole opening, its 17
    # two-row MSMs alone, and its ⟨a, b⟩·U + blind·H terms (two a round)
    # on the card from the window tables (made once per params, timed
    # apart), and on the host by scalar multiplications in Python ints, as
    # the reference makes them
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    a = torch.randint(1, 1 << 32, (1 << K, 8), device="cuda",
                      dtype=torch.int64, generator=g)
    a[:, 7] %= DFR.p >> 224
    a = (a - ((a >= 1 << 31).to(torch.int64) << 32)).to(torch.int32)
    ips = ipa._normal(DFR, a[:2])
    rnd = random.Random(13)
    blinds = [(rnd.randrange(DFR.p), rnd.randrange(DFR.p)) for _ in range(K)]
    pg, hh, uu = cfg.pg, pr.params.h, pr.params.u
    timed = {}
    for label, fn in (
            ("uh_tables", lambda: ipa._bases_table(
                dataclasses.replace(pr.params, bases=None))),
            ("fixed_shape", lambda: ipa.open_poly(
                pr.params, a, 0, 5, 0, Blake2bWrite(), rng=random.Random(3))),
            ("fixed_shape_msms", lambda: [
                msm.msm_many(pr.params.g, ipa._normal(
                    DFR, torch.stack([a, a.flip(0)])), ipa.MSM_C)
                for _ in range(K)]),
            ("uh_terms_card", lambda: [
                cfg.dev.to_affine_ints(ipa._bases_mul(pr.params, ips, bl))
                for bl in blinds]),
            ("uh_terms_host", lambda: [
                [pg.add(pg.mul(uu, ip), pg.mul(hh, b))
                 for ip, b in zip(DFR.to_ints(a[:2]), bl)] for bl in blinds])):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        timed[label] = time.perf_counter() - t1
    record["opening_s"] = timed
    log(f"ipa: one opening of 2^{K}: {timed['fixed_shape']:.3f} s, its {K} "
        f"two-row MSMs alone {timed['fixed_shape_msms']:.3f} s; its {K} "
        f"rounds' U and H terms on the card {timed['uh_terms_card']:.3f} s "
        f"(their tables, once per params, {timed['uh_tables']:.3f} s), on "
        f"the host {timed['uh_terms_host']:.3f} s")
    if (cfg.dev.to_affine_ints(ipa._bases_mul(pr.params, ips, blinds[0]))
            != [pg.add(pg.mul(uu, ip), pg.mul(hh, b))
                for ip, b in zip(DFR.to_ints(a[:2]), blinds[0])]):
        faults.append("the U and H terms on the card differ from the host's")

    # the toy circuit against the JAX package's bytes
    circ, wit = toy_circuit()
    tparams = ipa.setup(circ.k, device="cuda")
    tpk = keygen.keygen(tparams, circ)
    toy = prover.create_proof(tparams, tpk, wit, {}, seed=3)
    record["toy_sha256"] = hashlib.sha256(toy).hexdigest()
    if len(toy) != TOY_IPA_BYTES or record["toy_sha256"] != TOY_IPA_SHA256:
        faults.append(f"the toy IPA proof ({len(toy)} bytes, sha256 "
                      f"{record['toy_sha256']}) is not the JAX package's")
    if not verifier.verify_proof(tparams, tpk.vk, {}, toy):
        faults.append("the verifier rejects the toy IPA proof")
    log(f"ipa: toy proof {len(toy)} bytes, sha256 {record['toy_sha256']}"
        f" ({'the JAX pin' if record['toy_sha256'] == TOY_IPA_SHA256 else 'NOT the JAX pin'})")
    return record, faults


# where kernels 8–12's wrappers take `curve` among their positional
# arguments
CURVE_ARG = {"ec_add": 2, "seg_step": 3, "seg_scan_tiles": 2,
             "chain_scan_local": 3, "scale_reduce": 2}
# the ec_add[pallas] launches the pasta phase may make (the folds, the U/H
# tables and L + R; the reference's ladder took 10,483 in the phase at
# K = 3 and 10)
PASTA_EC_ADD_MAX = 1000


def pasta_classify(name, args, kw):
    """A wrapper call's Pasta instantiation (``mulmod[pasta_fp]``,
    ``ec_add[pallas]``, ``seg_step[pallas]``, …), or None for a BN254
    call."""
    if name in CURVE_ARG:
        at = CURVE_ARG[name]
        curve = args[at] if len(args) > at else kw.get("curve")
        return None if curve is None or not curve.kernel_id \
            else f"{name}[{curve.name}]"
    return None if args[0].kernel_id < 2 else f"{name}[{args[0].name}]"


def pasta_phase(imad_rate):
    """Commit, open and verify one polynomial on the pallas curve at K = 3
    (the reference's inputs, its bytes against the JAX pin), K = 10 and
    K = 17 (random coefficients; the port's own pins), each verified and
    rejected with a wrong value and with a byte flipped; the MSMs on the
    pallas instances of kernels 9–12, kernel 8 at most PASTA_EC_ADD_MAX
    times; each Pasta instantiation held to its twin at every shape of
    the phase; an empty kernel timed as the kernels are (the launch
    floor). Returns (record, faults, held records)."""
    import torch

    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.kernels import ec as kec
    from zkodst_tpu_torch.kernels import mulmod as kmul
    from zkodst_tpu_torch.ops import msm
    from zkodst_tpu_torch.ops.curve import BN254
    from zkodst_tpu_torch.ops.field import PASTA_FR
    from zkodst_tpu_torch.ops.pyfield import VESTA_BASE
    from zkodst_tpu_torch.proof import ipa
    from zkodst_tpu_torch.proof.transcript import (Blake2bRead,
                                                   Blake2bWrite,
                                                   compress_pasta)

    faults, record = [], {}
    sites = {name: [(kmul, name)] for name in ("mulmod", "addmod",
                                               "submod")}
    sites["ec_add"] = [(kec, "ec_add"), (msm, "ec_add")]
    for name in ("seg_step", "seg_scan_tiles", "chain_scan_local",
                 "scale_reduce"):
        sites[name] = [(msm, name)]

    def run(st):
        """commit, open, verify of one K's state: (times, commitment, proof,
        verdict)"""
        t1 = time.perf_counter()
        com = ipa.commit(st["params"], st["cm"], st["blind"])
        t2 = time.perf_counter()
        tw = Blake2bWrite("pasta")
        ipa.open_poly(st["params"], st["cm"], st["blind"], st["x"], st["v"],
                      tw, rng=random.Random(1))
        proof = tw.finalize()
        t3 = time.perf_counter()
        ok = ipa.verify_poly(st["params"], com, st["x"], st["v"],
                             Blake2bRead(proof, "pasta"), n=st["n"])
        t4 = time.perf_counter()
        return ({"commit_s": t2 - t1, "open_s": t3 - t2,
                 "verify_s": t4 - t3}, com, proof, ok)

    # the counted pass: every call's inputs kept, its work counted
    states = {}
    kernels.reset_counts()
    with Recorder(sites, pasta_classify) as rec:
        for k in PASTA_PINS:
            n = 1 << k
            rnd = random.Random(k)
            coeffs = ([(7 * i + 3) % VESTA_BASE for i in range(n)] if k == 3
                      else [rnd.randrange(VESTA_BASE) for _ in range(n)])
            st = {"n": n, "x": 987654321, "blind": 12345, "v": 0}
            for c in reversed(coeffs):
                st["v"] = (st["v"] * st["x"] + c) % VESTA_BASE
            t0 = time.perf_counter()
            st["params"] = ipa.setup(k, curve_name="pasta", device="cuda")
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            st["cm"] = PASTA_FR.from_ints(coeffs, "cuda")
            times, com, proof, ok = run(st)
            bad = ipa.verify_poly(st["params"], com, st["x"], st["v"],
                                  Blake2bRead(flipped(proof, 1), "pasta"),
                                  n=n)
            wrong = ipa.verify_poly(st["params"], com, st["x"],
                                    (st["v"] + 1) % VESTA_BASE,
                                    Blake2bRead(proof, "pasta"), n=n)
            st["out"] = (com, proof)
            states[k] = st
            sha = hashlib.sha256(compress_pasta(com) + proof).hexdigest()
            record[f"K{k}"] = {"setup_s": setup_s, "recorded_pass": times,
                               "proof_bytes": len(proof), "sha256": sha}
            if not ok:
                faults.append(f"K={k}: the opening does not verify")
            if bad or wrong:
                faults.append(f"K={k}: accepts a flipped byte ({bad}) or a "
                              f"wrong value ({wrong})")
            if sha != PASTA_PINS[k]:
                faults.append(f"K={k}: the opening is not "
                              f"{'the JAX package' if k == 3 else 'pinned'}"
                              f" (sha256 {sha})")
            log(f"pasta K={k}: setup {setup_s:.3f} s, commit "
                f"{times['commit_s']:.4f} s, open {times['open_s']:.4f} s, "
                f"verify {times['verify_s']:.4f} s (recorded), "
                f"{len(proof)} bytes, sha256 {sha}")
    launches = kernels.pasta_counts()
    record["launches"] = launches
    record["bn254_launches"] = {k: v for k, v in kernels.counts().items()
                                if v}
    if launches["ec_add[pallas]"] > PASTA_EC_ADD_MAX:
        faults.append(f"ec_add[pallas] launched {launches['ec_add[pallas]']}"
                      f" times (at most {PASTA_EC_ADD_MAX}): a ladder is back")
    if record["bn254_launches"]:
        faults.append(f"BN254 kernels launched on the pallas path: "
                      f"{record['bn254_launches']}")
    # the timed pass: the same calls again, warm, with no recorder (after
    # the counts are read)
    for k, st in states.items():
        times, com, proof, ok = run(st)
        record[f"K{k}"].update(times)
        if not ok or (com, proof) != st["out"]:
            faults.append(f"K={k}: the second opening differs or fails")
        log(f"pasta K={k} warm: commit {times['commit_s']:.4f} s, open "
            f"{times['open_s']:.4f} s, verify {times['verify_s']:.4f} s")
    del states
    # the launch floor: an empty kernel (a spin of 0 cycles) and no kernel
    # at all between the two events, timed as every kernel is
    record["empty_kernel_ms"] = time_ms(lambda: torch.cuda._sleep(0), 7)
    record["no_kernel_ms"] = time_ms(lambda: None, 7)
    log(f"pasta: launch floor {record['empty_kernel_ms']:.4f} ms (an empty "
        f"kernel), {record['no_kernel_ms']:.4f} ms (none)")
    # submod on the pallas scalar field is built by the dispatch but no
    # Pasta path subtracts scalars: it is held to its twin at the phase's
    # widest scalar-field shape, apart from the path's kernels
    off_path = "submod[pasta_fr]"
    idle = [k for k in idle_kernels(launches) if k != off_path]
    if idle:
        faults.append(f"Pasta instantiations not launched: {idle}")
    wrappers = {name: fn for name, (fn, _) in kernels.PASTA_WRAPPERS.items()}
    plains = {name: getattr(kec if name.endswith("[pallas]") else kmul,
                            name.split("[")[0] + "_plain")
              for name in wrappers}
    widest = max((key for (nm, key) in rec.calls
                  if nm == "mulmod[pasta_fr]"),
                 key=lambda kk: math.prod(kk[1]))
    args, _ = rec.calls[("mulmod[pasta_fr]", widest)]
    rec.calls[(off_path, widest)] = (args, {})
    rec.n[(off_path, widest)] = 0
    held = hold_to_twins(rec, wrappers, plains, imad_rate, faults)
    record["twin_shapes"] = {k: len(v) for k, v in held.items()}
    # each pallas instance of kernels 8–12 beside its BN254 instance on the
    # same inputs at its largest shape (limbs that BN254's field need not
    # hold canonically: only the time is read)
    for name, recs in held.items():
        if not name.endswith("[pallas]"):
            continue
        top, (args, kw) = max(recs, key=lambda ea: ea[0]["bound_ms"])
        at = CURVE_ARG[name.split("[")[0]]
        if len(args) > at:
            args = args[:at] + (BN254,) + args[at + 1:]
        else:
            kw = {**kw, "curve": BN254}
        top["bn254_ms"] = time_ms(lambda: wrappers[name](*args, **kw), 7)
        log(f"{name} {top['shape']}: {top['ms']:.4f} ms, the BN254 "
            f"instance {top['bn254_ms']:.4f} ms on the same inputs")
    return record, faults, held


def main(argv) -> int:
    import torch

    if argv:
        print("usage: chip_smoke.py [--inv-batch | --kzg-trace | "
              "--ipa-trace | --mesh-rank BACKEND CACHE_DIR]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from zkodst_tpu_torch import api, bench, kernels, native
        from zkodst_tpu_torch.circuit import blake2f as bc
        from zkodst_tpu_torch.circuit import mock
        from zkodst_tpu_torch.kernels import build
        from zkodst_tpu_torch.ops import blake2, curve, pycurve, u64
        from zkodst_tpu_torch.ops.pyfield import FR
        from zkodst_tpu_torch.proof import keygen, prover, srs, verifier
    except ImportError as ex:
        print(f"chip_smoke: run from the repository root ({ex})",
              file=sys.stderr)
        return 1
    with open(GOLDEN) as fh:
        golden = json.load(fh)

    card = bench.card(torch.device("cuda", 0))
    log(f"card: {card}")
    imad_rate = bench.int32_rate(torch.device("cuda", 0))
    log(f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs: "
        f"{imad_rate:.4g} 32-bit multiply results/s; HBM "
        f"{HBM_BYTES_PER_S:.3g} B/s")

    # -- build (fresh: the ptxas records come from this build; the processes
    # started later load its libraries) --------------------------------------
    built = build.build(fresh=True)
    phases = {"build": built.seconds}
    log(f"phase build: {built.seconds:.3f} s (nvcc, {len(built.ptxas)} "
        "sources in parallel)")
    for src, rep in built.ptxas.items():
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = re.search(r"([a-z0-9_]+_kernel)", m.group(1))
                mod = re.search(r"2(F[rq])E", m.group(1))
                tag = pasta_tag(m.group(1))
                log(f"ptxas {src}: {fn.group(1) if fn else m.group(1)}"
                    + (f"<{mod.group(1)}>" if mod else "")
                    + (f"[{tag}]" if tag else ""))
            elif "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")
    ptxas = ptxas_table(built.ptxas)
    t0 = time.perf_counter()
    native.get_lib()
    phases["build native"] = time.perf_counter() - t0
    log(f"phase build native: {phases['build native']:.3f} s (g++, the "
        "verifier's host core)")

    # -- the main path, counted -----------------------------------------------
    from zkodst_tpu_torch.ops import msm

    kernels.reset_counts()
    windows, msm_windows = [], msm._windows
    msm._windows = lambda *a: windows.append(1) or msm_windows(*a)
    t0 = time.perf_counter()
    try:
        pr = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                               echo=False, device="cuda")
        inputs = api.eip152_inputs(N_INST)
        proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
        accepted = pr.verify(inst, proof)
        torch.cuda.synchronize()
    finally:
        msm._windows = msm_windows
    wall = time.perf_counter() - t0
    launches = path_counts()
    gathered = kernels.gather_counts()["chain_scan_local[gather]"]
    log(f"main path: {len(windows)} MSM window passes, {gathered} "
        f"launches of kernel 11 gathered")
    copies = kernels.copies()
    for ph in pr.metrics.phases:
        phases[ph.label] = ph.seconds
        log(f"phase {ph.label}: {ph.seconds:.3f} s")
    log(f"main path wall: {wall:.3f} s; launches: {launches}")
    log(f"binop operands copied whole on the main path: {copies}")
    t1 = time.perf_counter()
    pr.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    phases["prove (warm)"] = time.perf_counter() - t1
    log(f"prove (warm, second call): {phases['prove (warm)']:.3f} s")

    # -- checks ---------------------------------------------------------------
    failures = []
    p = FR.p
    n = 1 << K
    tau = random.Random(("zkodst-srs", SRS_SEED, K).__repr__()) \
        .randrange(1, p)
    l0 = (pow(tau, n, p) - 1) * pow(n * (tau - 1) % p, -1, p) % p
    got = curve.to_affine_ints(torch.stack(
        [pr.params.g1[1], pr.params.g1_lagrange[0]]))
    want = [pycurve.G1.mul(pycurve.G1_GEN, tau),
            pycurve.G1.mul(pycurve.G1_GEN, l0)]
    if got != want:
        failures.append("SRS: g1[1] / g1_lagrange[0] differ from tau·G / "
                        "L0(tau)·G")
    else:
        log("SRS: g1[1] = tau·G and g1_lagrange[0] = L0(tau)·G")
    digest = vk_digest(pr.pk.vk)
    if digest != golden["vk_transcript_digest"]:
        failures.append(f"vk transcript digest {digest} != "
                        f"{golden['vk_transcript_digest']}")
    else:
        log(f"keygen: vk transcript digest = {digest} (the golden one)")
    want_bytes = bytes.fromhex(golden["proof_hex"])
    sha = hashlib.sha256(proof).hexdigest()
    if proof != want_bytes or len(proof) != PROOF_BYTES \
            or sha != golden["proof_sha256"]:
        same = next((i for i in range(min(len(proof), len(want_bytes)))
                     if proof[i] != want_bytes[i]),
                    min(len(proof), len(want_bytes)))
        failures.append(f"proof bytes differ from the golden proof from "
                        f"byte {same} ({len(proof)} bytes, sha256 {sha})")
    else:
        log(f"prove: {len(proof)} bytes, sha256 {sha}, equal "
            "flagship_proof_v1.json")
    if not accepted:
        failures.append("verify: the port's verifier rejects the card's proof")
    else:
        log("verify: the port's verifier accepts the card's proof")
    for what, at in (("a point (the first advice commitment)", 0),
                     ("a scalar (the first evaluation)", SCALAR_AT)):
        if verifier.verify_proof(pr.params, pr.pk.vk, inst,
                                 flipped(proof, at)):
            failures.append(f"verify: accepts the proof with a byte of "
                            f"{what} flipped")
        else:
            log(f"verify: rejects the proof with byte {at} flipped, in "
                f"{what}")
    pub = inst["pub"].cpu().numpy()
    v = blake2.EIP152_VECTOR
    digests = set()
    for i in range(N_INST):
        words = u64.to_ints(pub[bc.R_PUB * i + bc.ROW_OUT:
                                bc.R_PUB * i + bc.ROW_OUT + 8])
        digests.add(b"".join(int(x).to_bytes(8, "little")
                             for x in words).hex())
    if digests != {v["expected"]}:
        failures.append(f"witness digests {sorted(digests)[:2]} != EIP-152")
    else:
        log(f"witness: h' of all {N_INST} instances = the EIP-152 digest")
    if copies["broadcast"]:
        failures.append(f"{copies['broadcast']} broadcast binop operands "
                        "copied whole on the main path")
    idle = [k for k, c in launches.items() if c == 0]
    if idle:
        failures.append(f"kernels not launched on the main path: {idle}")
    if gathered != len(windows):
        failures.append(f"{len(windows)} MSM window passes on the main path "
                        f"but {gathered} gathered launches of kernel 11")

    # -- warm profile of each phase -------------------------------------------
    adv, _ = pr.witness(*inputs)
    staged = prover.Prover(pr.params, pr.pk, adv, inst, seed=BLIND_SEED)
    staged.advice()
    profile = profile_warm((
        ("witness", lambda: pr.built.witness(*inputs)),
        ("keygen", lambda: keygen.keygen(pr.params, pr.built.circ)),
        ("advice_commit", lambda: pr.commit_advice(adv, seed=BLIND_SEED)),
        ("lookup_permute", staged.lookups),
        ("grand_products_commit", staged.grand_products),
        ("quotient", staged.quotient),
        ("evaluations", staged.evaluations),
        ("multiopen", staged.multiopen),
        ("verify", lambda: pr.verify(inst, proof)),
        ("mock", lambda: mock.check(pr.built.circ, adv, inst, "cuda"))))
    del staged
    # the witness is kernel 13 into the columns, no eager scatter
    kernels.reset_counts()
    pr.built.witness(*inputs)
    torch.cuda.synchronize()
    one = {k: c for k, c in path_counts().items() if c}
    if one != {"blake2f_advice": 1}:
        failures.append(f"a flagship witness launched {one}, not kernel 13 "
                        "once")
    if profile["witness"]["launches"] > WITNESS_MAX_LAUNCHES:
        failures.append(f"a warm flagship witness took "
                        f"{profile['witness']['launches']} device "
                        f"operations, over {WITNESS_MAX_LAUNCHES}")

    # -- every kernel against its plain version, at the main path's shapes ----
    sites, wrappers, plains = kernel_tables()
    # the recorded run: SRS, keygen and prove once more, each kernel's
    # calls and shapes recorded here; each kernel's device time on the path
    # from a trace of the same run in a process of its own (one profiler
    # session a phase; a single session over all three lost a share of its
    # kernel records in one of six runs on an H100, and so did a session
    # late in this process)
    trace, kzg_trace_lost = path_trace_apart("kzg")
    with Recorder(sites) as rec:
        params = srs.setup(K, seed=SRS_SEED, device="cuda")
        pk = keygen.keygen(params, pr.built.circ)
        pr2 = api.Blake2fProver(built=pr.built, params=params, pk=pk,
                                metrics=pr.metrics)
        pr2.prove(*inputs, seed=BLIND_SEED)
        torch.cuda.synchronize()
        del params, pk, pr2
    failures += trace_faults(
        "kzg", trace, {name: sum(c for (nm, _), c in rec.n.items()
                                 if nm == name) for name in sites})
    kzg_density = log_density("kzg", rec)
    traced = trace["traced"] if trace else {}
    t_check = time.perf_counter()
    records = hold_to_twins(rec, wrappers, plains, imad_rate, failures)
    phases["kernel checks"] = time.perf_counter() - t_check
    phase_line("mock", *mock_phase(pr, inputs, wrappers, plains, imad_rate),
               failures)
    b2_record, b2_faults, b2_entries = blake2f_phase(imad_rate)
    phase_line("blake2f", b2_record, b2_faults, failures)
    line = []
    for name in wrappers:
        shapes = sorted(records.get(name, []),
                        key=lambda ea: -ea[0]["bound_ms"])
        if not shapes:
            failures.append(f"{name}: no call recorded on the main path")
            continue
        top, (args, kw) = shapes[0]
        if top["plain_ms"] < 2000:          # warm plain time where it is short
            a1, kw1 = fresh(args, kw)
            top["plain_ms"] = time_ms(lambda: plains[name](*a1, **kw1), 3)
        # the recorded run's device time of this kernel, from its trace,
        # against every call's bound on that call's own inputs
        calls = sum(e["calls"] for e, _ in shapes)
        ms = traced.get(name, (0.0, 0))[0]
        path = {"path_calls": calls, "path_ms": ms,
                "path_bound_ms": sum(max(b / HBM_BYTES_PER_S, o / imad_rate)
                                     for b, o in rec.work[name]) * 1e3}
        log(f"{name}: {calls} calls in the recorded run ({launches[name]} "
            f"launches on the main path), {ms:.3f} ms of device time in "
            f"its trace against {path['path_bound_ms']:.3f} ms at the bound")
        line.append({"name": name, "route": "cuda",
                     "source": {**SOURCES, **B2_SOURCES}[name],
                     "replaces": {**REPLACES, **B2_REPLACES}[name],
                     "launches": launches[name], **top,
                     "library_ms": None, **path,
                     "ptxas": ptxas.get(name),
                     "other_shapes": [e for e, _ in shapes[1:]]})
        if name == "blake2f_advice":        # the warm witness's trace
            line[-1]["witness_phase"] = profile["witness"]
            per_step(line[-1], b2_record["timing"].get("advice_kernel_us"))
    for entry in b2_entries:        # the stream form is the advice kernel
        line.append({**entry, "ptxas": ptxas.get(
            {"blake2f_witness": "blake2f_advice"}.get(entry["name"],
                                                      entry["name"]))})
    # the prefix product as a whole: kernels 4, 5 and 1 and the copies
    inv = inv_batch_apart()
    if inv is None:
        failures.append("inv_batch: the trace of one FR.inv_batch failed")
    else:
        log(f"inv_batch of {inv['elements']} elements: "
            f"{inv['device_ms']:.4f} ms of device time in "
            f"{inv['launches']} launches {inv['by_kernel']}; traced "
            f"{inv['traced_launches']}, counted {inv['wrapper_launches']}; "
            f"other {inv['other']}")
        failures += inv_batch_faults(inv)
    # -- the rest of the single-device API, each path counted on its own ----
    phase_line("chain", *chain_phase(pr), failures)
    phase_line("halo2ce", *halo2ce_phase(pr, inputs), failures)
    phase_line("native_verify", *native_phase(pr, inst, want_bytes),
               failures)
    with tempfile.TemporaryDirectory(prefix="zkodst_cache_") as cache_dir:
        phase_line("cache", *cache_phase(inputs, golden, cache_dir),
                   failures)
        phase_line("cli", *cli_phase(cache_dir), failures)
        phase_line("bench", *bench_phase(cache_dir), failures)
        # -- the multi-GPU prover, its ranks on this one card -------------
        mesh, mesh_faults = mesh_phase(cache_dir)
        phase_line("mesh", mesh, mesh_faults, failures)
    for entry in line:              # each kernel on the sharded proves
        entry["mesh_path"] = {
            label: {"launches": run["ranks"][0]["launches"].get(
                entry["name"], 0),
                    "new_shape": run["ranks"][0].get("twins", {}).get(
                        entry["name"], [None])[0]}
            for label, run in mesh.items()
            if label != "cli" and run["ranks"]}
    # -- the IPA backend: the flagship over BN254, then Pasta's PCS ---------
    ipa_rec, ipa_faults = ipa_phase(inputs, want_bytes, set(rec.calls),
                                    sites, wrappers, plains, imad_rate)
    ipa_density = ipa_rec.pop("seg_step_density")
    phase_line("ipa", ipa_rec, ipa_faults, failures)
    pasta, pasta_faults, pasta_held = pasta_phase(imad_rate)
    phase_line("pasta", pasta, pasta_faults, failures)
    for name, recs in pasta_held.items():
        if not pasta["launches"][name]:
            continue                    # held to its twin, on no path
        top, _ = max(recs, key=lambda ea: ea[0]["bound_ms"])
        base = name.split("[")[0]
        line.append({"name": name, "route": "cuda", "source": SOURCES[base],
                     "replaces": REPLACES[base],
                     "launches": pasta["launches"][name], **top,
                     "library_ms": None, "ptxas": ptxas.get(name),
                     "other_shapes": [e for e, _ in recs if e is not top]})
    print(json.dumps({"card": card, "phases_s": phases,
                      "profile": profile}), flush=True)
    print(json.dumps({"kernels": line, "inv_batch": inv,
                      "operand_copies": copies,
                      "seg_step_density": {"kzg": kzg_density,
                                           "ipa": ipa_density},
                      "kzg_trace_lost": kzg_trace_lost}), flush=True)
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--inv-batch"]:
        sys.exit(inv_batch_only())
    if sys.argv[1:] in (["--kzg-trace"], ["--ipa-trace"]):
        sys.exit(path_trace_only(sys.argv[1][2:5]))
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 4:
        sys.exit(mesh_rank())
    sys.exit(main(sys.argv[1:]))
