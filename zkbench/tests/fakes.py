"""A stand-in for the program under test, for CPU runs of the harness: it
answers every prove with the committed golden KZG proof of 37 EIP-152
compressions (k = 17, SRS seed 0) and, on request, with one of the faults
the reference's check must catch."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from zkbench.reference import circuit, verify

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "tests", "golden", "flagship_proof_v1.json")
EIP152 = dict(
    h=[0x6A09E667F2BDC948, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
       0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
       0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179],
    m=[0x636261] + [0] * 15, t=[3, 0])
PHASES = ("prove.witness", "prove.advice_commit", "prove.lookup_permute",
          "prove.grand_products_commit", "prove.quotient",
          "prove.evaluations", "prove.multiopen")


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
            with self.metrics.phase("setup.keygen"):
                pass
        self.n = 0

    def prove(self, h, m, t, f, seed=None):
        with self.metrics.phase("prove"):
            for label in PHASES:
                with self.metrics.phase(label):
                    pass
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
    "flip_proof", "flip_pub" (the stale-state and half-batch faults come
    from the traffic: the stand-in always answers with the golden proof
    of the all-EIP-152 batch, whatever it is sent)."""

    def __init__(self, fault=None):
        self.fault = fault

    def setup(self, cfg, n_inst, device):
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
        for j in range(proves):
            prove(j)
        return {"busy_s": 0.25, "window_s": 1.0, "device_ops": [["k", 0.25]],
                "idle_gaps": [["prove.quotient", 0.75]], "lost": {},
                "retakes": 0, "counted": {"mulmod": 3 * proves},
                "kernel_records": {"mulmod": 3 * proves}}

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
        return 0

    def key(self, prover):
        key = reference_key(37)
        return {"fixed": key.fixed, "sigma": key.sigma}

    def release(self):
        pass
