"""The comparison that decides a run's ``correct``.

After the window, a sample of its proofs (drawn from the run's seed) is
judged against the plain reference: the reference works out each
proof's public column from the batch the benchmark made (the BLAKE2f
compression of every instance), its own verifying key (KZG: from the
SRS seed's τ) or generators (IPA), and verifies the proof. The numbers
compared, each with its limit (all exact, so every limit is 0):

* ``proofs_rejected``: sampled proofs that do not verify;
* ``pub_cells_differ``: cells of the public column that the program
  returned with the sampled proofs and that differ from the reference's;
* ``key_points_differ`` (KZG): commitments of the program's verifying key
  that differ from the reference's;
* ``key_check_failed`` (IPA): 1 when a random combination of the
  program's fixed and σ commitments is not the commitment to the same
  combination of the reference's columns;
* ``prove_errors``: proves of the window that raised.
"""

from __future__ import annotations

import multiprocessing
import random
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import circuit, verify

LIMITS = {"proofs_rejected": 0, "pub_cells_differ": 0,
          "key_points_differ": 0, "key_check_failed": 0, "prove_errors": 0}
POOL = 8            # processes of the IPA reference's MSM and generators


@dataclass
class Sample:
    """One proof of the window, as the benchmark keeps it for the check."""

    index: int
    h: np.ndarray            # (B, 8) uint64 words, as sent
    m: np.ndarray
    t: np.ndarray
    f: np.ndarray
    proof: bytes
    pub: Optional[np.ndarray] = None   # the program's public column (n,)


def judge(config: Dict, n_inst: int, samples: List[Sample],
          program_key: Optional[Dict], prove_errors: int, seed: int,
          log=print) -> Dict[str, int]:
    """The numbers compared, by name (see the module's docstring).

    program_key: {"fixed": {name: point}, "sigma": [point]} as the
    program's set-up made it (read by KZG only to count differences; IPA
    proofs are replayed against it, after it is checked)."""
    circ = circuit.build(config["k"], n_inst, config["rounds"])
    pubs = [circuit.instance_column(circ.n, s.h, s.m, s.t, s.f,
                                    config["rounds"]) for s in samples]
    out = {"prove_errors": prove_errors, "proofs_rejected": 0,
           "pub_cells_differ": sum(
               int(np.count_nonzero(s.pub != pub)) if s.pub is not None
               else circ.n for s, pub in zip(samples, pubs))}
    if config["scheme"] == "kzg":
        tau = verify.kzg_tau(config["k"], config["srs_seed"])
        key = verify.kzg_key(circ, tau)
        if program_key is not None:
            out["key_points_differ"] = sum(
                a != b for a, b in zip(key.points(), _key(program_key,
                                                          config).points()))
        for s, pub in zip(samples, pubs):
            try:
                verify.verify_kzg(circ, key, tau, pub, s.proof)
            except verify.Rejected as ex:
                out["proofs_rejected"] += 1
                log(f"proof {s.index} rejected: {ex}")
        return out
    key = _key(program_key, config)
    cols = verify.key_columns(circ)[1]
    rng = random.Random(seed)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(POOL) as pool:
        params = verify.ipa_params(config["k"], pool)
        pending = {}
        for s, pub in zip(samples, pubs):
            try:
                pending[s.index] = verify.verify_ipa_host(circ, key, params,
                                                          pub, s.proof)
            except verify.Rejected as ex:
                out["proofs_rejected"] += 1
                log(f"proof {s.index} rejected: {ex}")
        if verify.ipa_batch_holds(pool, params, list(pending.values()), key,
                                  cols, rng):
            out["key_check_failed"] = 0
        else:
            # find which part fails: the key alone, then each proof alone
            out["key_check_failed"] = int(not verify.ipa_batch_holds(
                pool, params, [], key, cols, rng))
            for i, p in pending.items():
                if not verify.ipa_batch_holds(pool, params, [p], key, None,
                                              rng):
                    out["proofs_rejected"] += 1
                    log(f"proof {i} rejected: the opening check fails")
        pool.close()
        pool.join()
    return out


def _key(program_key: Dict, config: Dict) -> verify.Key:
    return verify.Key(config["k"], dict(program_key["fixed"]),
                      list(program_key["sigma"]))


def verdict(numbers: Dict[str, int]) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())
