"""The port's whole proofs of the richer toy circuit of
``test_torch_prover.py`` (an instance column copied into advice, ``cst``,
three permutation chunks whose carries chain, a two-column lookup) on the
port's own SRS and keygen, against the JAX package's pinned bytes: the
witness that satisfies the circuit gives a proof the port's verifier
accepts, and rejects with a wrong instance value; the witness that breaks
a copy gives the JAX bytes too, and a proof the verifier rejects. Exact
bytes."""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_prover import (RICH_PROOF_SHA256, RICH_SEEDS, RICH_SHA256,
                               RICH_UNSAT_SHA256, _rich)
from zkodst_tpu_torch.circuit import expr as texpr
from zkodst_tpu_torch.circuit import ir as tir
from zkodst_tpu_torch.proof import keygen, prover, srs, verifier

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rich():
    """params, the key (one circuit for both witnesses), the instance and
    the proofs of the satisfied and the unsatisfied witness."""
    circ, bad_adv, inst = _rich(tir, texpr)
    _, adv, _ = _rich(tir, texpr, satisfied=True)
    params = srs.setup(5, seed=RICH_SEEDS[0], device="cpu")
    pk = keygen.keygen(params, circ)

    def prove(advice):
        return prover.create_proof(
            params, pk, {c: torch.from_numpy(v.astype(np.int64))
                         for c, v in advice.items()}, inst,
            seed=RICH_SEEDS[1])

    return params, pk.vk, inst, prove(adv), prove(bad_adv)


def test_whole_proof_equals_jax_bytes(rich):
    _, _, _, proof, _ = rich
    assert len(proof) == 1792
    assert hashlib.sha256(proof).hexdigest() == RICH_PROOF_SHA256


def test_verifier_accepts_proof(rich):
    params, vk, inst, proof, _ = rich
    assert verifier.verify_proof(params, vk, inst, proof) is True
    on_card_layout = {"pub": torch.from_numpy(inst["pub"].astype(np.int64))}
    assert verifier.verify_proof(params, vk, on_card_layout, proof) is True


@pytest.mark.parametrize("row", [0, 1])
def test_verifier_rejects_wrong_instance_value(rich, row):
    params, vk, inst, proof, _ = rich
    pub = inst["pub"].copy()
    pub[row, 0] ^= 1
    assert verifier.verify_proof(params, vk, {"pub": pub}, proof) is False


def test_unsatisfied_witness_proof_is_jax_bytes_and_rejected(rich):
    params, vk, inst, _, bad = rich
    assert hashlib.sha256(bad[:32 * 13]).hexdigest() == RICH_SHA256
    assert hashlib.sha256(bad).hexdigest() == RICH_UNSAT_SHA256
    assert verifier.verify_proof(params, vk, inst, bad) is False
