#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``zkodst_tpu_torch/cuda/csrc``,
runs the flagship slice — ``setup_blake2f(k=17, n_inst=37)`` (the SRS and
the proving key made on the card), then ``prove`` on the EIP-152 witness
for 37 instances with blind seed 2 through the grand-product commitments —
and checks the SRS points, the verifying key's transcript digest, the 37
digests and the 1088 proof bytes (14 advice, 8 A′/S′, 12 Z points) against
``tests/golden/flagship_proof_v1.json``. It profiles the warm phases, then
holds every kernel against its plain PyTorch version at each shape the
main path gave it, times both, and prints one JSON line of kernel records
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. It imports nothing of JAX or zkodst_tpu and writes
nothing outside the kernel build directory.
"""

from __future__ import annotations

import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "flagship_proof_v1.json")
K, N_INST, SRS_SEED, BLIND_SEED = 17, 37, 0, 2
PROOF_BYTES = 32 * (14 + 8 + 12)    # advice, A'/S', Z points
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory (data sheet)
IMAD_PER_SM_CLOCK = 64              # 32-bit multiply results / SM / clock
POINT_BYTES = 96                    # a projective point: 24 32-bit words
SPIN_CYCLES = 10_000_000            # ~5 ms of card time ahead of a timed call
# 32-bit multiply results in one Montgomery product (8×8 a·b and 8×8 m·p
# wide products, lo and hi halves counted apart, plus 8 m = t·inv) and in
# one complete addition (12 products)
MULMOD_OPS = 2 * 2 * 64 + 8
EC_ADD_OPS = 12 * MULMOD_OPS

SOURCES = {
    "mulmod": "zkodst_tpu_torch/cuda/csrc/mulmod.cu",
    "addmod": "zkodst_tpu_torch/cuda/csrc/mulmod.cu",
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


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Recorder:
    """Wraps each kernel wrapper where the main path looks it up and keeps
    a copy of the inputs of the first call per distinct shape."""

    def __init__(self, sites):
        self.sites = sites              # name -> [(module, attr)]
        self.calls = {}                 # (name, key) -> (args, kwargs)
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

        def rec(*args):
            key = tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                        else a for a in args)
            if (name, key) not in self.calls:
                self.calls[(name, key)] = tuple(
                    _copy(a) if isinstance(a, torch.Tensor) else a
                    for a in args)
            return fn(*args)
        return rec


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


def work(name, args):
    """(bytes moved, 32-bit multiply results) the call needs on these
    inputs: each input read once (a broadcast constant once, not once per
    element), each output written once; additions counted where this data
    needs them (a scan adds once per element that continues a segment,
    seg_step once per element it does not keep)."""
    import torch

    if name in ("mulmod", "addmod"):
        a, b = torch.broadcast_tensors(args[1], args[2])
        n = a.numel() // 8
        ops = MULMOD_OPS * n if name == "mulmod" else 0
        return _held_bytes(a) + _held_bytes(b) + 32 * n, ops
    if name == "chain_cumprod":
        n, W = args[1].shape[0], args[2]
        return 64 * n, MULMOD_OPS * (n - W)
    if name == "cumprod_tile":
        m = args[1].shape[0]
        return 64 * m, MULMOD_OPS * (m - 1)
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
        adds = int((~args[2].bool()).sum())
        return (3 * POINT_BYTES + 1) * B * n, EC_ADD_OPS * adds
    if name in ("chain_scan_local", "seg_scan_tiles"):
        f = args[1].bool().clone()
        if name == "chain_scan_local":
            f[:, :args[2]] = True               # chain heads
        else:
            f[:, 0] = True                      # the tile's first lane
        adds = int((~f).sum())
        return (2 * POINT_BYTES + 1) * B * n, EC_ADD_OPS * adds
    if name == "scale_reduce":
        c = args[1]
        adds = B * (c + 1) * (n - 1)
        return POINT_BYTES * B * (n + 1), EC_ADD_OPS * adds
    raise KeyError(name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from zkodst_tpu_torch import api, kernels
        from zkodst_tpu_torch.circuit import blake2f as bc
        from zkodst_tpu_torch.kernels import build, ec as kec
        from zkodst_tpu_torch.kernels import mulmod as kmul
        from zkodst_tpu_torch.kernels import ntt as kntt
        from zkodst_tpu_torch.ops import blake2, curve, msm, pycurve, u64
        from zkodst_tpu_torch.ops import ntt as ontt
        from zkodst_tpu_torch.ops.pyfield import FR
        from zkodst_tpu_torch.proof import keygen, prover, srs
        from zkodst_tpu_torch.proof.transcript import Blake2bWrite
    except ImportError as ex:
        print(f"chip_smoke: run from the repository root ({ex})",
              file=sys.stderr)
        return 1
    with open(GOLDEN) as fh:
        golden = json.load(fh)

    card = card_line()
    log(f"card: {card}")
    props = torch.cuda.get_device_properties(0)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    imad_rate = props.multi_processor_count * IMAD_PER_SM_CLOCK \
        * float(clock) * 1e6
    log(f"{props.multi_processor_count} SMs at {clock} MHz: {imad_rate:.4g} "
        f"32-bit multiply results/s; HBM {HBM_BYTES_PER_S:.3g} B/s")

    # -- build --------------------------------------------------------------
    built = build.build()
    phases = {"build": built.seconds}
    log(f"phase build: {built.seconds:.3f} s (nvcc, {len(built.ptxas)} "
        "sources in parallel)")
    for src, rep in built.ptxas.items():
        for line in rep.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = re.search(r"([a-z_]+_kernel)", m.group(1))
                mod = re.search(r"2(F[rq])E", m.group(1))
                log(f"ptxas {src}: {fn.group(1) if fn else m.group(1)}"
                    + (f"<{mod.group(1)}>" if mod else ""))
            elif "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")

    # -- the main path, counted -----------------------------------------------
    kernels.reset_counts()
    t0 = time.perf_counter()
    pr = api.setup_blake2f(k=K, n_inst=N_INST, srs_seed=SRS_SEED,
                           device="cuda")
    inputs = api.eip152_inputs(N_INST)
    proof, inst = pr.prove(*inputs, seed=BLIND_SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.counts()
    for ph in pr.metrics.phases:
        phases[ph.label] = ph.seconds
        log(f"phase {ph.label}: {ph.seconds:.3f} s")
    log(f"main path wall: {wall:.3f} s; launches: {launches}")
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
    tw = Blake2bWrite()
    pr.pk.vk.hash_into(tw)
    digest = hex(tw.squeeze_challenge())
    if digest != golden["vk_transcript_digest"]:
        failures.append(f"vk transcript digest {digest} != "
                        f"{golden['vk_transcript_digest']}")
    else:
        log(f"keygen: vk transcript digest = {digest} (the golden one)")
    want_bytes = bytes.fromhex(golden["proof_hex"])[:PROOF_BYTES]
    if proof != want_bytes:
        same = next((i for i in range(min(len(proof), PROOF_BYTES))
                     if proof[i] != want_bytes[i]), min(len(proof),
                                                        PROOF_BYTES))
        failures.append(f"proof bytes differ from the golden proof from "
                        f"byte {same} ({len(proof)} bytes)")
    else:
        log(f"prove: {PROOF_BYTES} bytes (advice, A'/S', Z points) equal "
            f"flagship_proof_v1.json proof_hex[:{2 * PROOF_BYTES}]")
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
    idle = [k for k, c in launches.items() if c == 0]
    if idle:
        failures.append(f"kernels not launched on the main path: {idle}")

    # -- warm profile of each phase -------------------------------------------
    profile = {}
    from torch.profiler import ProfilerActivity, profile as tprofile

    adv, _ = pr.witness(*inputs)
    staged = prover.Prover(pr.params, pr.pk, adv, inst, seed=BLIND_SEED)
    staged.advice()
    for label, fn in (
            ("witness", lambda: pr.built.witness(*inputs)),
            ("keygen", lambda: keygen.keygen(pr.params, pr.built.circ)),
            ("advice_commit",
             lambda: pr.commit_advice(adv, seed=BLIND_SEED)),
            ("lookup_permute", staged.lookups),
            ("grand_products_commit", staged.grand_products)):
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
    del staged

    # -- every kernel against its plain version, at the main path's shapes ----
    sites = {
        "mulmod": [(kmul, "mulmod")],
        "addmod": [(kmul, "addmod")],
        "chain_cumprod": [(kmul, "chain_cumprod")],
        "cumprod_tile": [(kmul, "cumprod_tile")],
        "ntt_tail": [(ontt, "ntt_tail")],
        "ntt_head": [(ontt, "ntt_head")],
        "ec_add": [(kec, "ec_add")],
        "seg_step": [(msm, "seg_step")],
        "seg_scan_tiles": [(msm, "seg_scan_tiles")],
        "chain_scan_local": [(msm, "chain_scan_local")],
        "scale_reduce": [(msm, "scale_reduce")],
    }
    with Recorder(sites) as rec:
        params = srs.setup(K, seed=SRS_SEED, device="cuda")
        pk = keygen.keygen(params, pr.built.circ)
        pr2 = api.Blake2fProver(built=pr.built, params=params, pk=pk,
                                metrics=pr.metrics)
        pr2.prove(*inputs, seed=BLIND_SEED)
        del params, pk, pr2
    wrappers = {name: fn for name, (fn, _) in kernels.WRAPPERS.items()}
    plains = {"mulmod": kmul.mulmod_plain, "addmod": kmul.addmod_plain,
              "chain_cumprod": kmul.chain_cumprod_plain,
              "cumprod_tile": kmul.cumprod_tile_plain,
              "ntt_tail": kntt.ntt_tail_plain,
              "ntt_head": kntt.ntt_head_plain,
              "ec_add": kec.ec_add_plain,
              "seg_step": kec.seg_step_plain,
              "seg_scan_tiles": kec.seg_scan_tiles_plain,
              "chain_scan_local": kec.chain_scan_local_plain,
              "scale_reduce": kec.scale_reduce_plain}
    records = {}
    t_check = time.perf_counter()
    for (name, key), args in sorted(rec.calls.items(),
                                    key=lambda kv: str(kv[0])):
        fn, plain = wrappers[name], plains[name]
        out = fn(*args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = plain(*args)
        torch.cuda.synchronize()
        plain_once = (time.perf_counter() - t1) * 1e3
        err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max()) \
            if out.numel() else 0
        if out.shape != ref.shape or err != 0:
            failures.append(f"{name} {key}: kernel != plain (max abs limb "
                            f"difference {err})")
        del out, ref
        nbytes, ops = work(name, args)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / imad_rate * 1e3
        shape = " ".join(getattr(k, "name", str(k)) for k in key)
        entry = {"shape": shape, "max_abs_err": err,
                 "ms": time_ms(lambda: fn(*args), 7),
                 "plain_ms": plain_once, "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"{name} {shape}: {'equal to' if err == 0 else 'DIFFERS from'} "
            f"plain; kernel {entry['ms']:.4f} ms, plain {plain_once:.1f} ms "
            f"(one cold call), bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']})")
        records.setdefault(name, []).append((entry, args))
    phases["kernel checks"] = time.perf_counter() - t_check
    line = []
    for name in wrappers:
        shapes = sorted(records.get(name, []),
                        key=lambda ea: -ea[0]["bound_ms"])
        if not shapes:
            failures.append(f"{name}: no call recorded on the main path")
            continue
        top, args = shapes[0]
        if top["plain_ms"] < 2000:          # warm plain time where it is short
            top["plain_ms"] = time_ms(lambda: plains[name](*args), 3)
        line.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name],
                     "launches": launches[name], **top,
                     "library_ms": None,
                     "other_shapes": [e for e, _ in shapes[1:]]})
    print(json.dumps({"card": card, "phases_s": phases,
                      "profile": profile}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
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
    sys.exit(main())
