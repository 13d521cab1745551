"""The flagship slice on the port's CPU path (37 instances, k=17, blind
seed 2, SRS seed 0): the first advice commitment equals the golden proof's
first 32 bytes, and keygen gives the golden verifying-key transcript
digest. The SRS is the port's own setup(17); on the CPU that takes
minutes, and keygen's 35 full-width commitments far longer, hence `slow`.
The card checks all 1088 bytes through the grand products and the digest
in chip_smoke.py."""

import dataclasses
import json
import os

import pytest
import torch

from zkodst_tpu_torch import api
from zkodst_tpu_torch.circuit import blake2f
from zkodst_tpu_torch.proof import keygen, prover, srs
from zkodst_tpu_torch.proof.transcript import Blake2bWrite

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "flagship_proof_v1.json")


def _golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


@pytest.mark.slow
def test_first_advice_commitment_equals_golden():
    built = blake2f.Blake2fCircuit(k=17, n_inst=37, device="cpu")
    params = srs.setup(17, seed=0, device="cpu")
    adv, _ = built.witness(*api.eip152_inputs(37))
    first = dataclasses.replace(built.circ,
                                advice_names=built.circ.advice_names[:1])
    got = prover.commit_advice(params, first, adv, seed=2)
    assert got.hex() == _golden()["proof_hex"][:64]


@pytest.mark.slow
def test_flagship_vk_digest_equals_golden():
    built = blake2f.Blake2fCircuit(k=17, n_inst=37, device="cpu")
    pk = keygen.keygen(srs.setup(17, seed=0, device="cpu"), built.circ)
    tw = Blake2bWrite()
    pk.vk.hash_into(tw)
    assert hex(tw.squeeze_challenge()) == _golden()["vk_transcript_digest"]
