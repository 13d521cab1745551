"""A stand-in for the program under test, for CPU runs of the harness: it
answers every prove with the committed golden KZG proof of 37 EIP-152
compressions (k = 17, SRS seed 0) and, on request, with one of the faults
the reference's check must catch. Each prove leaves the spans and
counters the per-layer readers read, as the program's would: its phases
(an MSM's and the constraints' among them), the program's ``COUNTERS``
and an ``.ntt`` span in its ``LAYER_SPANS``."""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from zkbench.reference import circuit, verify
from zkodst_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "tests", "golden", "flagship_proof_v1.json")
EIP152 = dict(
    h=[0x6A09E667F2BDC948, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
       0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
       0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179],
    m=[0x636261] + [0] * 15, t=[3, 0])
PHASES = ("prove.witness", "prove.advice_commit",
          "prove.advice_commit.msm", "prove.lookup_permute",
          "prove.grand_products_commit", "prove.quotient",
          "prove.quotient.constraints", "prove.evaluations",
          "prove.multiopen")
# a prove's counters, as the program counts them on the KZG path at k = 17
PROVE_COUNTERS = {"host_waits": 42, "host_wait_s": 0.03, "uploads": 197}
NTT = {"batch": 1, "n": 1024, "launches": 2}    # one small transform
NTT_DEVICE_S = 0.05
MEMORY_PEAK = 1 << 20
PROVE_IDS = itertools.count(1)


@lru_cache(maxsize=1)
def golden_proof() -> bytes:
    with open(GOLDEN) as fh:
        return bytes.fromhex(json.load(fh)["proof_hex"])


@lru_cache(maxsize=2)
def reference_key(n_inst: int):
    c = circuit.build(17, n_inst, 12)
    return verify.kzg_key(c, verify.kzg_tau(17, 0))


def golden_pub() -> np.ndarray:
    b = 37
    return circuit.instance_column(
        1 << 17, np.array([EIP152["h"]] * b, np.uint64),
        np.array([EIP152["m"]] * b, np.uint64),
        np.array([EIP152["t"]] * b, np.uint64), np.ones(b, bool), 12)


@dataclass
class _Phase:
    label: str
    seconds: float


class FakeMetrics:
    def __init__(self):
        self.phases = []

    @contextlib.contextmanager
    def phase(self, label):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append(_Phase(label, time.perf_counter() - t0))


class FakeProver:
    def __init__(self, fault):
        self.fault = fault
        self.metrics = FakeMetrics()
        with self.metrics.phase("setup"):
            for label in ("setup.params", "setup.keygen"):
                with self.metrics.phase(label):
                    pass
        self.n = 0

    def prove(self, h, m, t, f, seed=None):
        if self.fault == "exit_in_window" and self.n >= 2:
            os._exit(3)                 # after the two warm-up proves
        with self.metrics.phase("prove"):
            for label in PHASES:
                with self.metrics.phase(label):
                    pass
        for key, v in PROVE_COUNTERS.items():
            timing.COUNTERS[key] += v
        timing.COUNTERS["proves"] += 1
        timing.LAYER_SPANS.append(timing.Phase(
            "prove.quotient.ntt", NTT_DEVICE_S, device_s=NTT_DEVICE_S,
            prove=next(PROVE_IDS), counts=dict(NTT)))
        proof = bytearray(golden_proof())
        pub = golden_pub()
        if self.fault == "flip_proof":
            proof[200] ^= 1
        elif self.fault == "flip_pub":
            pub = pub.copy()
            pub[27] ^= np.uint64(1)
        self.n += 1
        return bytes(proof), {"pub": pub}


class FakeSystem:
    """The harness's view of the program, with `fault` one of None,
    "flip_proof", "flip_pub", "other_key" (a σ commitment of the key
    moved; the stale-state and half-batch faults come from the traffic:
    the stand-in always answers with the golden proof of the all-EIP-152
    batch, whatever it is sent), or, for a client process, "setup_raises",
    "hang_in_setup", "exit_in_window" (the process ends at its first
    prove after the warm-up)."""

    def __init__(self, fault=None):
        self.fault = fault

    @staticmethod
    def prepare():
        pass

    def setup(self, cfg, n_inst, device):
        if self.fault == "setup_raises":
            raise RuntimeError("set-up failed")
        if self.fault == "hang_in_setup":
            time.sleep(3600)
        return FakeProver(self.fault)

    def synchronize(self):
        pass

    def card(self):
        return {"name": "stand-in", "sms": 1, "sm_clock_max_mhz": 1.0,
                "power_limit_w": "0", "mul32_per_s": 64e6,
                "hbm_bytes_per_s": 3.35e12}

    def phase_spans(self, prover):
        return contextlib.nullcontext()

    def trace(self, prove, proves, log):
        timing.reset_counters()
        for j in range(proves):
            prove(j)
        return {"busy_s": 0.25, "window_s": 1.0, "device_ops": [["k", 0.25]],
                "idle_gaps": [["prove.quotient", 0.75]], "lost": {},
                "retakes": 0, "counted": {"mulmod": 3 * proves},
                "kernel_records": {"mulmod": 3 * proves}}

    def trace_until(self, prove, arm):
        """Proves through the window arm() gives; the device is busy the
        first quarter of each."""
        timing.reset_counters()
        start, until = arm()
        while time.perf_counter() < start:
            time.sleep(0.001)
        t_open = time.perf_counter()
        device, j = [], 0
        while time.perf_counter() < until:
            t0 = time.perf_counter()
            prove(j)
            t1 = time.perf_counter()
            device.append((t0, t0 + 0.25 * (t1 - t0), "k"))
            j += 1
        return {"open": t_open, "until": until, "device": device,
                "spans": [("prove", t_open, time.perf_counter())],
                "counted": {"mulmod": 3 * j}, "lost": {}, "proves": j}

    def msm_probe(self, prove, proves):
        for j in range(proves):
            prove(j)
        return {"time_s": 2.0, "least_s": 0.5, "ops": 1, "bytes": 1,
                "calls": 1, "proves": proves, "peak": self.card()}

    def keep_pub(self, inst):
        return inst["pub"]

    def pub_words(self, pub):
        return pub

    def memory_peak(self):
        return MEMORY_PEAK

    def key(self, prover):
        key = reference_key(37)
        sigma = list(key.sigma)
        if self.fault == "other_key":
            sigma[0], sigma[1] = sigma[1], sigma[0]
        return {"fixed": dict(key.fixed), "sigma": sigma}

    def release(self):
        pass
