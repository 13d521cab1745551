"""The port's whole proof of the toy circuit (plain path) against
``tests/golden/toy_proof_v1.json`` (SRS seed 2, blind seed 42, the
reference's cached key), and the port's verifier on it: it accepts the
proof and rejects a flipped byte in a point (a low bit, and bit 254 of x,
which no point is written with), in a scalar and in W′, and a truncated
proof. Exact bytes; a verifier that raises fails the test."""

import json
import os

import pytest
import torch

from test_torch_keygen import GOLDEN, cached_npz, params_for, toy
from zkodst_tpu_torch.proof import keygen, prover, verifier

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

# 2 advice, A′/S′, permutation and lookup Z, 4 h points; then evaluations
N_POINTS = 10


@pytest.fixture(scope="module")
def toy_case():
    with open(os.path.join(GOLDEN, "toy_proof_v1.json")) as fh:
        g = json.load(fh)
    circ, wit = toy(5)
    params = params_for(5)
    pk = keygen.from_numpy(cached_npz(circ), params, circ)
    proof = prover.create_proof(params, pk, wit, {}, seed=g["blind_seed"])
    return params, pk.vk, proof, bytes.fromhex(g["proof_hex"])


def test_whole_proof_equals_fixture(toy_case):
    _, _, proof, want = toy_case
    assert len(proof) == 928
    assert proof == want


def test_verifier_accepts_proof(toy_case):
    params, vk, proof, _ = toy_case
    assert verifier.verify_proof(params, vk, {}, proof) is True


def _flip(proof: bytes, at: int, mask: int = 1) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= mask
    return bytes(bad)


@pytest.mark.parametrize("where", ["point", "scalar", "w_prime",
                                   "point_bit_254"])
def test_verifier_rejects_flipped_byte(toy_case, where):
    params, vk, proof, _ = toy_case
    # bit 254 of a point's x: the same point if it were cleared unchecked
    at, mask = {"point": (32 + 5, 1), "scalar": (32 * N_POINTS, 1),
                "w_prime": (len(proof) - 32, 1),
                "point_bit_254": (31, 0x40)}[where]
    assert verifier.verify_proof(params, vk, {},
                                 _flip(proof, at, mask)) is False


@pytest.mark.parametrize("cut", [1, 32, 900])
def test_verifier_rejects_truncated_proof(toy_case, cut):
    params, vk, proof, _ = toy_case
    assert verifier.verify_proof(params, vk, {}, proof[:-cut]) is False
    assert verifier.verify_proof(params, vk, {}, proof + bytes(cut)) is False
