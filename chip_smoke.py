#!/usr/bin/env python3
"""Check the PyTorch/CUDA port on one NVIDIA GPU: every result exact.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It times nothing: ``zkbench/run.py`` measures the port (``--trace 1``
adds each kernel's device time to its ``breakdown``). It builds the
port's CUDA kernels fresh from ``zkodst_tpu_torch/cuda/csrc`` and logs
each kernel's ptxas registers, stack frame and spills, then checks:

- the main path, ``setup_blake2f(k=17, n_inst=37)`` (the SRS and the
  proving key made on the card), ``prove`` on the EIP-152 witness for 37
  instances with blind seed 2 and ``verify``: the SRS points, the
  verifying key's transcript digest, the 37 digests and all 4480 proof
  bytes and their sha256 against ``tests/golden/flagship_proof_v1.json``;
  the verifier accepts the proof and rejects it with one byte flipped in
  a point and in a scalar. Every kernel is launched, no broadcast binop
  operand is copied whole, every MSM window pass calls kernel 11 gathered
  once, and a warm witness launches kernel 13 once and nothing else;
- every kernel against its plain PyTorch twin, limb for limb, at each
  shape and flags the main path gave it (kernels 4 and 5 also in the
  other direction, kernel 5 inclusive and exclusive);
- then phases, each with the launch counts set to 0 before it and
  printing a JSON line of its own: ``mock`` (the flagship witness passes
  the mock checker and fails a gate and a copy with one ``w`` and one
  ``pub`` cell flipped; its binop calls held to their twins),
  ``blake2f`` (kernel 13's two forms against their plain versions at
  rounds 0, 1 and 12, kernel 14 on the EIP-152 appendix vectors, and the
  ``bench`` command's line 1, 8192 compressions, against the plain
  version), ``chain`` (a 3-block message through the gadget, proved,
  verified and its chain read back; a forged middle block rejected),
  ``halo2ce`` (the flagship proved and verified in that transcript mode
  and rejected with a byte flipped and by the v1 verifier), ``native_verify``
  (the golden proof through the native verifier core and Python ints),
  ``cache`` (two setups from one cache directory: the golden vk digest
  and no file written by the second), ``cli`` (``python -m
  zkodst_tpu_torch prove`` and ``vectors``), ``bench`` (``python -m
  zkodst_tpu_torch bench`` in a process of its own: its lines in order,
  the golden proof, every kernel launched), ``mesh`` (the multi-GPU
  prover on the one card over NCCL × 1 and gloo × 2, each rank a process
  of its own, ``--mesh-rank BACKEND CACHE_DIR``: the golden bytes on
  every rank, and ``--mesh 2`` through the CLI), ``ipa`` (the IPA
  flagship: generators against the host hash to the curve, the proof
  against the port's pin ``b0d0bac1…``, rejections, its U and H terms
  against the host, the toy circuit's proof against the JAX package's
  ``488377f1…``) and ``pasta`` (commit, open and verify on the pallas
  curve at K = 3, 10 and 17 against their pins, rejections, kernel 8 at
  most PASTA_EC_ADD_MAX times). The ``ipa``, ``mesh`` and ``pasta``
  phases hold each kernel to its twin at the largest shape (by elements)
  that the main path did not give it, or at every shape they give it.

Any failure exits non-zero before the last line, ``{"ok": true,
"device": {...}}``. It imports nothing of JAX or zkodst_tpu and writes
nothing outside the kernel build directories and a temporary cache
directory that it removes.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
import signal
import socket
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
    """Wraps each kernel wrapper where the main path looks it up and keeps
    a copy of the inputs of the first call per distinct shape and flags:
    ``calls``, (name, call_key) -> (positional arguments, keyword
    arguments)."""

    def __init__(self, sites, classify=None):
        self.sites = sites              # name -> [(module, attr)]
        # (name, args, kw) -> the name a call is recorded under, or None
        # for a call that is not recorded
        self.classify = classify or (lambda name, args, kw: name)
        self.calls = {}
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


def _copy(t):
    """A copy of `t` that keeps its broadcast (stride-0) dimensions
    broadcast, so a recorded call sees the operands the path gave it."""
    idx = tuple(slice(0, 1) if s == 0 else slice(None) for s in t.stride())
    return t[idx].clone().expand(t.shape)


def flag_variants(name, kw):
    """The other directions (and, for cumprod_tile, the other output
    kind) of a recorded call of kernel 4 or 5, as keyword arguments."""
    if name == "chain_cumprod":
        return [{**kw, "reverse": r} for r in (False, True)]
    if name == "cumprod_tile":
        return [{**kw, "reverse": r, "exclusive": e}
                for r in (False, True) for e in (False, True)]
    return []


def hold_to_twins(calls, wrappers, plains, failures) -> dict:
    """Every recorded call (`calls`: (name, key) -> (args, kw)) again, on
    the kernel and on its twin, equal limb for limb; kernels 4 and 5 also
    in the directions and output kinds that `calls` does not hold for that
    shape. Returns wrapper -> the shapes held; appends what differs to
    `failures`."""
    import torch

    held = {}
    for (name, key), (args, kw) in sorted(calls.items(),
                                          key=lambda kv: str(kv[0])):
        fn, plain = wrappers[name], plains[name]
        shape = " ".join(getattr(k, "name", str(k)) for k in key)
        others = [f for f in flag_variants(name, kw)
                  if (name, call_key(args, f)) not in calls]
        for flags in [kw] + others:
            a1, f1 = fresh(args, flags)
            out = fn(*a1, **f1)
            a1, f1 = fresh(args, flags)
            ref = plain(*a1, **f1)
            torch.cuda.synchronize()
            outs, refs = ((out, ref) if isinstance(out, tuple)
                          else ((out,), (ref,)))
            said = "" if flags is kw else " with " + str(
                {k: flags[k] for k in ("reverse", "exclusive") if k in flags})
            if len(outs) != len(refs) or not all(
                    torch.equal(o, r) for o, r in zip(outs, refs)):
                failures.append(f"{name} {shape}{said}: kernel != plain")
            del out, ref
        log(f"{name} {shape}: held to plain in {1 + len(others)} flag sets")
        held.setdefault(name, []).append(shape)
    return held


def largest_new(calls, old) -> dict:
    """Per wrapper, of the recorded calls whose (name, key) `old` does not
    hold, the one whose tensors hold the most elements."""
    import torch

    best = {}
    for (name, key), (args, kw) in calls.items():
        if (name, key) in old:
            continue
        size = sum(t.numel() for t in (*args, *kw.values())
                   if isinstance(t, torch.Tensor))
        if name not in best or size > best[name][0]:
            best[name] = (size, key)
    return {(n, k): calls[(n, k)] for n, (_, k) in best.items()}


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


def mock_phase(pr, inputs, wrappers, plains):
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
    kernels.reset_counts()
    fails = mock.check(circ, adv, inst, "cuda")
    torch.cuda.synchronize()
    launches = kernels.counts()
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
    held = hold_to_twins(rec.calls, wrappers, plains, faults)
    log(f"mock: {sum(launches.values())} kernel launches {launches}")
    return {"kernel_launches": launches,
            "flipped_w_row": row, "flipped_failures": [str(f) for f in bad],
            "twin_shapes": {k: len(v) for k, v in held.items()}}, faults


def blake2f_phase():
    """Kernels 13 and 14 apart from the proof's path: kernel 13's two forms
    on 37 random instances (f mixed) at rounds 0 and 1, the advice form's
    whole columns and the stream each equal to their plain versions, and
    the stream form at the flagship's 12 rounds too; every stream call
    held to its twin again; kernel 14 on the EIP-152 appendix vectors,
    each equal to its plain version and the vectors to their digests; then
    the ``bench`` command's line 1 (``bench.bench_witness``: 8192 EIP-152
    compressions) with the counts set to 0 just before it and read just
    after: it launched kernel 14, its h' equals the plain version's and
    the digest, and kernel 14 at that shape is held to its twin. Returns
    (record, faults)."""
    import numpy as np
    import torch

    from zkodst_tpu_torch import bench, kernels
    from zkodst_tpu_torch.circuit import blake2f as bc
    from zkodst_tpu_torch.kernels import blake2 as kb
    from zkodst_tpu_torch.ops import blake2, u64

    faults, record = [], {}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(13)
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
    hold_to_twins(rec.calls, {"blake2f_witness": kb.blake2f_witness},
                  {"blake2f_witness": kb.blake2f_witness_plain}, faults)

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
    _, out = bench.bench_witness(dev)
    torch.cuda.synchronize()
    launches = kernels.blake2f_counts()
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
    hold_to_twins(rec.calls, {"blake2f_compress": kb.blake2f_compress},
                  {"blake2f_compress": kb.blake2f_compress_plain}, faults)
    checks = {k: v for k, v in record.items()
              if k.startswith(("witness_", "advice_"))}
    log(f"blake2f: kernel 13 {checks}; kernel 14 vectors {vectors}; line 1 "
        f"in {launches} launches")
    return record, faults


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
    proof, inst = pr.prove(*gadget.calls_to_arrays(calls,
                                                   pad_to=pr.n_inst),
                           seed=CHAIN_SEED)
    torch.cuda.synchronize()
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
    log(f"chain: 3 blocks proved, {len(proof)} bytes")
    return {"blocks": len(calls), "digest": digest.hex(),
            "proof_bytes": len(proof),
            "proof_sha256": hashlib.sha256(proof).hexdigest(),
            "launches": launches}, faults


def halo2ce_phase(pr, inputs):
    """The flagship proved in halo2ce mode with the golden blind seed,
    verified in that mode, rejected with a point byte flipped and by the
    v1 verifier, and proved again to the same bytes. Returns (record,
    faults)."""
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
    again, _ = pr.prove(*inputs, seed=BLIND_SEED, transcript_mode="halo2ce")
    if again != proof:
        faults.append("a second halo2ce proof differs from the first")
    sha = hashlib.sha256(proof).hexdigest()
    log(f"halo2ce: {len(proof)} bytes, sha256 {sha}")
    return {"proof_bytes": len(proof), "proof_sha256": sha,
            "launches": launches}, faults


def native_phase(pr, inst, proof):
    """The golden proof verified through the native core and through
    Python ints, and rejected with a point or a scalar byte flipped.
    Returns (record, faults)."""
    from zkodst_tpu_torch.proof import verifier

    faults = []
    for native in (True, False):
        if not verifier.verify_proof(pr.params, pr.pk.vk, inst, proof,
                                     native=native):
            faults.append(f"native={native} rejects the golden proof")
    for at in (0, SCALAR_AT):
        if verifier.verify_proof(pr.params, pr.pk.vk, inst,
                                 flipped(proof, at)):
            faults.append(f"native accepts byte {at} flipped")
    log("verify: the native core and Python ints agree on the golden "
        "proof and its flips")
    return {}, faults


def cache_phase(inputs, golden, cache_dir):
    """Two setups from one cache directory: the golden vk digest both
    times, no file written by the second, and the golden proof from its
    key. Returns (record, faults)."""
    import torch

    from zkodst_tpu_torch import api, kernels

    def listing():
        return sorted((f, os.stat(os.path.join(cache_dir, f)).st_mtime_ns)
                      for f in os.listdir(cache_dir))

    faults = []
    for i in range(2):
        if i:
            kernels.reset_counts()
        pc = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                               cache_dir=cache_dir, echo=False,
                               device="cuda")
        torch.cuda.synchronize()
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
    log(f"cache: setup written, then read from {[f for f, _ in files]}")
    return {"files": [f for f, _ in files], "launches": launches}, faults


def cli_phase(cache_dir):
    """``python -m zkodst_tpu_torch prove`` (the flagship from the cache)
    and ``vectors`` on the card, in subprocesses. Returns (record,
    faults)."""
    faults, record = [], {}
    env = dict(os.environ, PYTHONPATH=ROOT)
    for cmd in (["prove", "--k", str(K), "--instances", str(N_INST),
                 "--seed", str(BLIND_SEED), "--cache-dir", cache_dir],
                ["vectors", "--device", "cuda"]):
        out = subprocess.run([sys.executable, "-m", "zkodst_tpu_torch",
                              *cmd], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=900)
        record[cmd[0]] = {"rc": out.returncode}
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

    from zkodst_tpu_torch import kernels

    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("ZKODST_")}
    env["PYTHONPATH"] = ROOT
    (rc, out, err), = run_apart(
        [[sys.executable, "-m", "zkodst_tpu_torch", "bench", "--cache-dir",
          cache_dir]], [env], cache_dir, "bench", BENCH_TIMEOUT_S)
    record = {"rc": rc}
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
    diag = lines[-1]["diag"]
    if diag.get("flagship_golden") != "match":
        faults.append(f"flagship_golden is {diag.get('flagship_golden')}")
    if "mock_check_s" not in diag:
        faults.append("no mock_check_s")
    total = diag.get("dp_scale", {}).get("instances_total", 0)
    if total < 1024:
        faults.append(f"dp_scale proved {total} instances, not 1024")
    idle = idle_kernels(diag.get("launches", {}), list(kernels.WRAPPERS))
    if idle:
        faults.append(f"kernels not launched by bench: {idle}")
    b2 = diag.get("blake2f_launches", {})
    record["blake2f_launches"] = b2
    if not b2.get("line1", {}).get("blake2f_compress"):
        faults.append(f"line 1 did not launch kernel 14: {b2}")
    if not b2.get("from_setup", {}).get("blake2f_advice"):
        faults.append(f"the proves did not launch kernel 13: {b2}")
    return record, faults


def mesh_rank() -> int:
    """``--mesh-rank BACKEND CACHE_DIR``: one rank of the ``mesh`` phase,
    under the ``torch.distributed`` variables that phase sets, on cuda:0.
    ``setup_blake2f(k=17, n_inst=37)`` from the cache with a 1-D mesh over
    the job's ranks; the EIP-152 proof with blind seed 2, sharded, its
    launches counted and its bytes held to the golden file; a second prove
    (the same bytes) and verify; the sharded prove's kernel calls
    recorded, and (rank 0, after the last collective) each kernel held to
    its twin at its largest shape that a single-device prove in this
    process does not give it. Prints one JSON line (``{"mesh_rank":
    ...}``)."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from zkodst_tpu_torch import api, kernels
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
    build.build()
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    pr = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                           cache_dir=cache_dir, echo=False, device=dev,
                           mesh=mesh, mesh_axis="x")
    inputs = api.eip152_inputs(N_INST)
    kernels.reset_counts()
    proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    rec["launches"] = path_counts()
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
    again, _ = pr.prove(*inputs, seed=BLIND_SEED)
    if again != proof:
        faults.append(f"rank {mesh.rank}: a second sharded proof differs")
    if not pr.verify(inst, proof):
        faults.append(f"rank {mesh.rank}: the verifier rejects the sharded "
                      "proof")
    sites, wrappers, plains = kernel_tables()
    with Recorder(sites) as sharded:
        pr.prove(*inputs, seed=BLIND_SEED)
        torch.cuda.synchronize()
    dist.destroy_process_group()          # the last collective is behind
    log(f"mesh rank {mesh.rank} of {rec['world']} ({backend}): "
        f"{rec['launches']}")
    if mesh.rank == 0:
        single = api.Blake2fProver(built=pr.built, params=pr.params,
                                   pk=pr.pk, metrics=pr.metrics)
        with Recorder(sites) as one:
            single.prove(*inputs, seed=BLIND_SEED)
            torch.cuda.synchronize()
        held = hold_to_twins(largest_new(sharded.calls, set(one.calls)),
                             wrappers, plains, faults)
        rec["twins"] = held
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
        got = run_apart(
            [[sys.executable, os.path.abspath(__file__), "--mesh-rank",
              backend, cache_dir]] * world,
            [dict(base, MASTER_PORT=port, WORLD_SIZE=str(world),
                  RANK=str(r), LOCAL_RANK=str(r)) for r in range(world)],
            cache_dir, label, MESH_TIMEOUT_S)
        ranks = []
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
            ranks.append(rec)
        record[label] = {"ranks": ranks}
    port = str(free_port())
    (rc, out, err), = run_apart(
        [[sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
          "2", "--master-addr", "localhost", "--master-port", port, "-m",
          "zkodst_tpu_torch", "prove", "--k", str(K), "--instances",
          str(N_INST), "--cache-dir", cache_dir, "--mesh", "2", "--device",
          "cuda:0", "--backend", "gloo", "--quiet"]],
        [base], cache_dir, "cli", MESH_TIMEOUT_S)
    last = next((json.loads(line) for line in reversed(out.splitlines())
                 if line.startswith('{"proof_bytes"')), None)
    record["cli"] = {"rc": rc, "prints": last}
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


def ipa_phase(inputs, kzg_proof, kzg_calls, sites, wrappers, plains):
    """The IPA flagship on the card: ``setup_blake2f(scheme="ipa")`` with
    no cache, a second ``ipa.setup`` equal to the first, a sample of the
    generators against the host hash to the curve, the EIP-152 proof
    (blind seed 2) against the port's pin and again byte-equal, verified,
    and rejected with a byte of L_1 or of a₀ flipped and as the KZG
    flagship proof; all twelve kernels launched; each kernel held to its
    twin at its largest IPA shape the KZG path did not give it; one
    opening's U and H terms on the card against the host's; the toy
    circuit's IPA proof against the JAX pin. Returns (record, faults)."""
    import torch

    from zkodst_tpu_torch import api, kernels
    from zkodst_tpu_torch.ops.field import FR as DFR
    from zkodst_tpu_torch.proof import ipa, keygen, prover, verifier

    faults, record = [], {}
    kernels.reset_counts()
    with Recorder(sites) as rec:
        pr = api.setup_blake2f(k=K, n_inst=N_INST, scheme="ipa", echo=False,
                               device="cuda")
        proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
        accepted = pr.verify(inst, proof)
        torch.cuda.synchronize()
    launches = path_counts()
    record["launches"] = launches
    if idle_kernels(launches):
        faults.append(f"kernels not launched: {idle_kernels(launches)}")
    gens = ipa.setup(K, device="cuda")
    if not torch.equal(gens.g, pr.params.g):
        faults.append("a second ipa.setup gives other generators")
    del gens

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

    # the proof: its size, its pin, a second prove, the verifier
    record["proof_bytes"] = len(proof)
    record["proof_sha256"] = hashlib.sha256(proof).hexdigest()
    if len(proof) != IPA_PROOF_BYTES:
        faults.append(f"{len(proof)} bytes, not {IPA_PROOF_BYTES}")
    if record["proof_sha256"] != FLAGSHIP_IPA_SHA256:
        faults.append(f"the flagship IPA proof's sha256 "
                      f"{record['proof_sha256']} is not the port's pin "
                      f"{FLAGSHIP_IPA_SHA256}")
    again, _ = pr.prove(*inputs, seed=BLIND_SEED)
    if again != proof:
        faults.append("a second proof with the same seed differs")
    if not accepted:
        faults.append("the verifier rejects the IPA proof")
    for what, bad in (("L_1", flipped(proof, IPA_L1_AT)),
                      ("a0", flipped(proof, IPA_A0_AT)),
                      ("the KZG flagship proof", kzg_proof)):
        if pr.verify(inst, bad):
            faults.append(f"the verifier accepts {what}")
    log(f"ipa: {len(proof)} bytes, sha256 {record['proof_sha256']}; "
        f"launches {launches}")

    held = hold_to_twins(largest_new(rec.calls, kzg_calls), wrappers,
                         plains, faults)
    record["twins"] = held
    # a kernel whose IPA shapes are all the KZG path's was held to its twin
    # at each of them already
    record["shapes_all_kzg"] = [name for name in wrappers
                                if name not in held]
    del rec

    # an opening round's ⟨a, b⟩·U + blind·H terms on the card, from the
    # window tables, against scalar multiplications in Python ints, as the
    # reference makes them
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    a = torch.randint(1, 1 << 32, (2, 8), device="cuda", dtype=torch.int64,
                      generator=g)
    a[:, 7] %= DFR.p >> 224
    a = (a - ((a >= 1 << 31).to(torch.int64) << 32)).to(torch.int32)
    rnd = random.Random(13)
    blind = (rnd.randrange(DFR.p), rnd.randrange(DFR.p))
    pg, hh, uu = cfg.pg, pr.params.h, pr.params.u
    if (cfg.dev.to_affine_ints(ipa._bases_mul(pr.params, ipa._normal(DFR, a),
                                              blind))
            != [pg.add(pg.mul(uu, ip), pg.mul(hh, b))
                for ip, b in zip(DFR.to_ints(a), blind)]):
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
    log(f"ipa: toy proof {len(toy)} bytes, sha256 {record['toy_sha256']}")
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


def pasta_phase():
    """Commit, open and verify one polynomial on the pallas curve at K = 3
    (the reference's inputs, its bytes against the JAX pin), K = 10 and
    K = 17 (random coefficients; the port's own pins), each verified,
    rejected with a wrong value and with a byte flipped, and opened again
    to the same bytes; the MSMs on the pallas instances of kernels 9–12,
    kernel 8 at most PASTA_EC_ADD_MAX times, no BN254 kernel; each Pasta
    instantiation held to its twin at every shape of the phase. Returns
    (record, faults)."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.kernels import ec as kec
    from zkodst_tpu_torch.kernels import mulmod as kmul
    from zkodst_tpu_torch.ops import msm
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
        """commit, open, verify of one K's state: (commitment, proof,
        verdict)"""
        com = ipa.commit(st["params"], st["cm"], st["blind"])
        tw = Blake2bWrite("pasta")
        ipa.open_poly(st["params"], st["cm"], st["blind"], st["x"], st["v"],
                      tw, rng=random.Random(1))
        proof = tw.finalize()
        ok = ipa.verify_poly(st["params"], com, st["x"], st["v"],
                             Blake2bRead(proof, "pasta"), n=st["n"])
        return com, proof, ok

    # the recorded pass: every call's inputs kept
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
            st["params"] = ipa.setup(k, curve_name="pasta", device="cuda")
            st["cm"] = PASTA_FR.from_ints(coeffs, "cuda")
            com, proof, ok = run(st)
            bad = ipa.verify_poly(st["params"], com, st["x"], st["v"],
                                  Blake2bRead(flipped(proof, 1), "pasta"),
                                  n=n)
            wrong = ipa.verify_poly(st["params"], com, st["x"],
                                    (st["v"] + 1) % VESTA_BASE,
                                    Blake2bRead(proof, "pasta"), n=n)
            st["out"] = (com, proof)
            states[k] = st
            sha = hashlib.sha256(compress_pasta(com) + proof).hexdigest()
            record[f"K{k}"] = {"proof_bytes": len(proof), "sha256": sha}
            if not ok:
                faults.append(f"K={k}: the opening does not verify")
            if bad or wrong:
                faults.append(f"K={k}: accepts a flipped byte ({bad}) or a "
                              f"wrong value ({wrong})")
            if sha != PASTA_PINS[k]:
                faults.append(f"K={k}: the opening is not "
                              f"{'the JAX package' if k == 3 else 'pinned'}"
                              f" (sha256 {sha})")
            log(f"pasta K={k}: {len(proof)} bytes, sha256 {sha}")
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
    # the same calls again, with no recorder (after the counts are read)
    for k, st in states.items():
        com, proof, ok = run(st)
        if not ok or (com, proof) != st["out"]:
            faults.append(f"K={k}: the second opening differs or fails")
    del states
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
    held = hold_to_twins(rec.calls, wrappers, plains, faults)
    record["twin_shapes"] = {k: len(v) for k, v in held.items()}
    return record, faults


def main(argv) -> int:
    import torch

    if argv:
        print("usage: chip_smoke.py [--mesh-rank BACKEND CACHE_DIR]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from zkodst_tpu_torch import api, bench, kernels, native
        from zkodst_tpu_torch.circuit import blake2f as bc
        from zkodst_tpu_torch.kernels import build
        from zkodst_tpu_torch.ops import blake2, curve, msm, pycurve, u64
        from zkodst_tpu_torch.ops.pyfield import FR
        from zkodst_tpu_torch.proof import verifier
    except ImportError as ex:
        print(f"chip_smoke: run from the repository root ({ex})",
              file=sys.stderr)
        return 1
    with open(GOLDEN) as fh:
        golden = json.load(fh)

    card = bench.card(torch.device("cuda", 0))
    log(f"card: {card}")

    # -- build (fresh: its ptxas report is logged; the processes started
    # later load its libraries) ------------------------------------------
    built = build.build(fresh=True)
    for src, rep in built.ptxas.items():
        for line in rep.splitlines():
            if "Compiling entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")
    native.get_lib()

    # -- the main path: counted, every kernel call's inputs recorded, and
    # each MSM window pass and kernel-11 call seen by a spy ----------------
    sites, wrappers, plains = kernel_tables()
    windows, gathered = [], []
    msm_windows, msm_scan = msm._windows, msm.chain_scan_local

    def scan(*a, index=None, **kw):
        gathered.append(index is not None)
        return msm_scan(*a, index=index, **kw)
    msm._windows = lambda *a: windows.append(1) or msm_windows(*a)
    msm.chain_scan_local = scan
    kernels.reset_counts()
    try:
        with Recorder(sites) as rec:
            pr = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                                   echo=False, device="cuda")
            inputs = api.eip152_inputs(N_INST)
            proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
            accepted = pr.verify(inst, proof)
            torch.cuda.synchronize()
    finally:
        msm._windows, msm.chain_scan_local = msm_windows, msm_scan
    launches = path_counts()
    copies = kernels.copies()
    log(f"main path: launches {launches}; {len(windows)} MSM window passes, "
        f"{sum(gathered)} gathered kernel-11 calls; binop operands copied "
        f"whole {copies}")

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
    if sum(gathered) != len(windows):
        failures.append(f"{len(windows)} MSM window passes on the main path "
                        f"but {sum(gathered)} gathered calls of kernel 11")
    # the witness is kernel 13 into the columns, no eager scatter
    kernels.reset_counts()
    pr.built.witness(*inputs)
    torch.cuda.synchronize()
    one = {k: c for k, c in path_counts().items() if c}
    if one != {"blake2f_advice": 1}:
        failures.append(f"a flagship witness launched {one}, not kernel 13 "
                        "once")

    # -- every kernel against its plain version, at the main path's shapes
    held = hold_to_twins(rec.calls, wrappers, plains, failures)
    failures += [f"{name}: no call recorded on the main path"
                 for name in wrappers if name not in held]

    # -- the rest of the single-device API, each path counted on its own --
    phase_line("mock", *mock_phase(pr, inputs, wrappers, plains), failures)
    phase_line("blake2f", *blake2f_phase(), failures)
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
        phase_line("mesh", *mesh_phase(cache_dir), failures)
    # -- the IPA backend: the flagship over BN254, then Pasta's PCS ---------
    phase_line("ipa", *ipa_phase(inputs, want_bytes, set(rec.calls), sites,
                                 wrappers, plains), failures)
    phase_line("pasta", *pasta_phase(), failures)
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
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 4:
        sys.exit(mesh_rank())
    sys.exit(main(sys.argv[1:]))
