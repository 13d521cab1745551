"""Top-level pipeline: setup (SRS and keygen) → witness → proof → verify,
for the EIP-152 BLAKE2f circuit, with phase timing.

Counterpart of ``zkodst_tpu/api.py`` (:23-66, :75-101), v1 transcript and
KZG. The phases are labelled ``setup``, ``setup.keygen``, ``prove``,
``prove.witness``, ``prove.advice_commit``, ``prove.lookup_permute``,
``prove.grand_products_commit``, ``prove.quotient``,
``prove.evaluations``, ``prove.multiopen`` and ``verify``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .circuit import blake2f as blake2f_circuit
from .ops import blake2, u64
from .proof import keygen, prover, srs, verifier
from .utils.device import resolve
from .utils.timing import PROVE, SETUP, VERIFY, Metrics


@dataclass
class Blake2fProver:
    """A BLAKE2f pipeline at fixed (k, instances, rounds) on one device."""

    built: blake2f_circuit.Blake2fCircuit
    params: srs.ParamsKZG
    pk: keygen.ProvingKey
    metrics: Metrics

    def witness(self, h, m, t, f):
        """h (B,8,2), m (B,16,2), t (B,2,2) u64 pairs, f (B,) ->
        (advice dict, instance dict) of (n, 2) tensors on the device."""
        with self.metrics.phase("prove.witness"):
            return self.built.witness(h, m, t, f)

    def commit_advice(self, advice, seed: int) -> bytes:
        """The proof's advice-commitment bytes (blind seed `seed`)."""
        return prover.commit_advice(self.params, self.built.circ, advice,
                                    seed, self.metrics)

    def prove(self, h, m, t, f, seed: int = 0) -> Tuple[bytes, dict]:
        """h (B,8,2), m (B,16,2), t (B,2,2), f (B,) -> (proof bytes,
        instance dict of (n, 2) tensors)."""
        with self.metrics.phase(PROVE):
            adv, inst = self.witness(h, m, t, f)
            proof = prover.create_proof(self.params, self.pk, adv, inst,
                                        seed=seed, metrics=self.metrics)
        return proof, inst

    def verify(self, instance: dict, proof: bytes) -> bool:
        """True if `proof` proves the circuit on `instance` (the dict that
        :meth:`prove` returned); on the host."""
        with self.metrics.phase(VERIFY):
            return verifier.verify_proof(self.params, self.pk.vk, instance,
                                         proof)


def setup_blake2f(k: int = 17, n_inst: int = 1, rounds: int = 12,
                  srs_seed: int = 0, device=None) -> Blake2fProver:
    """Build the circuit, make the SRS and the proving key on `device`
    (CUDA by default; raises without CUDA unless device="cpu")."""
    dev = resolve(device)
    metrics = Metrics()
    with metrics.phase(SETUP):
        built = blake2f_circuit.Blake2fCircuit(k=k, n_inst=n_inst,
                                               rounds=rounds, device=dev)
        params = srs.setup(k, seed=srs_seed, device=dev)
        with metrics.phase("setup.keygen"):
            pk = keygen.keygen(params, built.circ)
    return Blake2fProver(built=built, params=params, pk=pk, metrics=metrics)


def eip152_inputs(n_inst: int = 1):
    """The EIP-152 vector tiled to a batch (h, m, t, f numpy arrays)."""
    v = blake2.EIP152_VECTOR
    h = np.broadcast_to(u64.from_ints(v["h"]), (n_inst, 8, 2)).copy()
    m = np.broadcast_to(u64.from_ints(v["m"]), (n_inst, 16, 2)).copy()
    t = np.broadcast_to(u64.from_ints(v["t"]), (n_inst, 2, 2)).copy()
    f = np.ones((n_inst,), bool)
    return h, m, t, f
