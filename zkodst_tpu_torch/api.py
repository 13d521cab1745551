"""Top-level pipeline: setup (SRS and keygen) → witness → proof → verify,
for the EIP-152 BLAKE2f circuit, with spans (:mod:`.utils.timing`), the
mock check and SRS and key caching.

Counterpart of ``zkodst_tpu/api.py``, with either commitment scheme: KZG
(BN254 + SHPLONK) or the transparent IPA over BN254 (``scheme="ipa"``),
on one device or, for KZG, sharded over a mesh of ranks
(``mesh=parallel.bootstrap.make_mesh(...)``: every rank runs the same
calls). The phases are
labelled ``setup``, ``setup.keygen``, ``prove``, ``prove.witness``,
``prove.advice_commit``, ``prove.lookup_permute``,
``prove.grand_products_commit``, ``prove.quotient``,
``prove.evaluations``, ``prove.multiopen`` and ``verify``; sub-spans
inside them (``setup.params``, ``prove.quotient.constraints``, every
MSM's ``<parent>.msm``, …) are recorded beside them and not echoed. The
outermost span (``setup``, ``prove``, ``verify``) alone waits for the
card, once, at its end; a phase's time runs to the card's completion of
its work, without a wait of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .circuit import blake2f as blake2f_circuit
from .circuit import mock
from .ops import blake2, u64
from .proof import ipa, keygen, pcs, prover, srs, verifier
from .utils.device import resolve
from .utils.timing import PROVE, SETUP, VERIFY, Metrics, span


@dataclass
class Blake2fProver:
    """A BLAKE2f pipeline at fixed (k, instances, rounds) on one device,
    or with its proofs sharded over `mesh` (each rank holds its own)."""

    built: blake2f_circuit.Blake2fCircuit
    params: pcs.Params
    pk: keygen.ProvingKey
    metrics: Metrics
    mesh: object = None              # parallel.bootstrap.Mesh
    mesh_axis: object = "x"

    @property
    def n_inst(self) -> int:
        return self.built.n_inst

    def witness(self, h, m, t, f):
        """h (B,8,2), m (B,16,2), t (B,2,2) u64 pairs, f (B,) ->
        (advice dict, instance dict) of (n, 2) tensors on the device."""
        with self.metrics.phase("prove.witness"):
            return self.built.witness(h, m, t, f)

    def commit_advice(self, advice, seed: int) -> bytes:
        """The proof's advice-commitment bytes (blind seed `seed`)."""
        return prover.commit_advice(self.params, self.built.circ, advice,
                                    seed, self.metrics)

    def prove(self, h, m, t, f, seed: Optional[int] = 0,
              transcript_mode: str = "v1") -> Tuple[bytes, dict]:
        """h (B,8,2), m (B,16,2), t (B,2,2), f (B,) -> (proof bytes,
        instance dict of (n, 2) tensors). transcript_mode: "v1" or
        "halo2ce" (:mod:`.proof.transcript`)."""
        with self.metrics.phase(PROVE):
            adv, inst = self.witness(h, m, t, f)
            proof = prover.create_proof(self.params, self.pk, adv, inst,
                                        seed=seed, metrics=self.metrics,
                                        transcript_mode=transcript_mode,
                                        mesh=self.mesh,
                                        mesh_axis=self.mesh_axis)
        return proof, inst

    def verify(self, instance: dict, proof: bytes,
               transcript_mode: str = "v1") -> bool:
        """True if `proof` proves the circuit on `instance` (the dict that
        :meth:`prove` returned): on the host, the KZG pairing and its MSM
        in the native C++ core; the IPA check's n-point MSM on the
        params' device."""
        with self.metrics.phase(VERIFY):
            return verifier.verify_proof(self.params, self.pk.vk, instance,
                                         proof, transcript_mode)

    def mock_check(self, h, m, t, f) -> list:
        """The witness's constraint failures (:func:`.circuit.mock.check`,
        gates on the circuit's device); [] when it satisfies the circuit."""
        adv, inst = self.built.witness(h, m, t, f)
        return mock.check(self.built.circ, adv, inst, self.built.device)


def setup_blake2f(k: int = 17, n_inst: int = 1, rounds: int = 12,
                  srs_seed: int = 0, cache_dir: Optional[str] = None,
                  echo: bool = True, scheme: str = "kzg",
                  device=None, mesh=None, mesh_axis="x") -> Blake2fProver:
    """Build the circuit, make the commitment params (the KZG SRS or the
    IPA generators) and the proving key on `device` (CUDA by default;
    raises without CUDA unless device="cpu").

    cache_dir: read the params and the key from there, or make them and
    write them there (``srs.get_or_create``, ``ipa.setup(cache_dir=...)``,
    ``keygen(cache_dir=...)``; the reference's file names and formats).
    echo: print each phase's Start:/End: lines. scheme: "kzg" (BN254 +
    SHPLONK) or "ipa" (transparent, BN254; srs_seed is not used).

    mesh: a :class:`.parallel.bootstrap.Mesh` (KZG only): the proofs run
    sharded over `mesh_axis`; every rank calls this with the same
    arguments and `device` is its own card. With `cache_dir`, rank 0
    alone makes and writes a missing SRS or key while the others wait,
    then they read it: no two ranks write one file."""
    if scheme not in ("kzg", "ipa"):
        raise ValueError(f"unknown commitment scheme {scheme!r}")
    if scheme == "ipa" and mesh is not None:
        raise NotImplementedError(
            "the IPA backend is single-device: use KZG for a mesh")
    dev = resolve(device)
    metrics = Metrics(echo=echo)
    shared = mesh is not None and cache_dir is not None
    if shared and mesh.rank:
        mesh.barrier()                  # rank 0 has the cache's files
    with metrics.phase(SETUP):
        built = blake2f_circuit.Blake2fCircuit(k=k, n_inst=n_inst,
                                               rounds=rounds, device=dev)
        with span("params"):
            if scheme == "ipa":
                params = ipa.setup(k, cache_dir=cache_dir, device=dev)
            elif cache_dir is not None:
                params = srs.get_or_create(k, cache_dir, seed=srs_seed,
                                           device=dev)
            else:
                params = srs.setup(k, seed=srs_seed, device=dev)
        with metrics.phase("setup.keygen"):
            pk = keygen.keygen(params, built.circ, cache_dir=cache_dir)
    if shared and not mesh.rank:
        mesh.barrier()
    return Blake2fProver(built=built, params=params, pk=pk, metrics=metrics,
                         mesh=mesh, mesh_axis=mesh_axis)


def eip152_inputs(n_inst: int = 1):
    """The EIP-152 vector tiled to a batch (h, m, t, f numpy arrays)."""
    v = blake2.EIP152_VECTOR
    h = np.broadcast_to(u64.from_ints(v["h"]), (n_inst, 8, 2)).copy()
    m = np.broadcast_to(u64.from_ints(v["m"]), (n_inst, 16, 2)).copy()
    t = np.broadcast_to(u64.from_ints(v["t"]), (n_inst, 2, 2)).copy()
    f = np.ones((n_inst,), bool)
    return h, m, t, f
