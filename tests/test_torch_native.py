"""The port's native host core (``zkodst_tpu_torch/native``, the
reference's ``native/zkcore.cpp`` built with g++) against the port's
Python-int pairing and MSM, following ``tests/test_native.py``: the
pairing check and the G1 MSM on random points and scalars, the identity,
and the verifier's verdicts on the toy proof of
``tests/golden/toy_proof_v1.json`` and its flipped copies, which do not
change between ``native=True`` and ``native=False``."""

import json
import os
import random

import pytest
import torch

from test_torch_keygen import GOLDEN, cached_npz, params_for, toy
from zkodst_tpu_torch import native
from zkodst_tpu_torch.ops import pycurve
from zkodst_tpu_torch.proof import keygen, pairing, shplonk, verifier

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

G1, G2 = pycurve.G1_GEN, pycurve.G2_GEN
R = pycurve.R_ORDER


def test_native_source_is_the_references():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "native", "zkcore.cpp"), "rb") as fh:
        assert native.SRC.read_bytes() == fh.read()


def test_pairing_check_equals_python():
    rng = random.Random(17)
    for _ in range(2):
        a = rng.randrange(1, R)
        good = [(pycurve.G1.mul(G1, a), G2),
                (pycurve.G1.neg(G1), pycurve.G2.mul(G2, a))]
        bad = [(pycurve.G1.mul(G1, a + 1), G2),
               (pycurve.G1.neg(G1), pycurve.G2.mul(G2, a))]
        assert native.pairing_check(good) is pairing.pairing_check(good) \
            is True
        assert native.pairing_check(bad) is pairing.pairing_check(bad) \
            is False
    ident = [(None, G2), (G1, None)]
    assert native.pairing_check(ident) is pairing.pairing_check(ident) \
        is True


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_msm_equals_python(seed):
    rng = random.Random(seed)
    pts = [pycurve.G1.mul(G1, rng.randrange(1, R)) for _ in range(9)]
    pts[rng.randrange(9)] = None
    ks = [rng.randrange(R) for _ in range(9)]
    ks[0] = 0
    ks[1] = R - 1
    assert native.g1_msm(pts, ks) == shplonk.g1_msm(pts, ks)
    assert native.g1_msm(pts[:2], [0, 0]) is None


@pytest.fixture(scope="module")
def toy_case():
    with open(os.path.join(GOLDEN, "toy_proof_v1.json")) as fh:
        proof = bytes.fromhex(json.load(fh)["proof_hex"])
    circ, _ = toy(5)
    params = params_for(5)
    pk = keygen.from_numpy(cached_npz(circ), params, circ)
    return params, pk.vk, proof


@pytest.mark.parametrize("at,mask", [(None, 0), (37, 1), (320, 1),
                                     (928 - 32, 1), (928 - 1, 0x80)],
                         ids=["proof", "point", "scalar", "w_prime",
                              "w_prime_sign"])
def test_verdicts_equal_python(toy_case, at, mask):
    params, vk, proof = toy_case
    if at is not None:
        proof = bytearray(proof)
        proof[at] ^= mask
        proof = bytes(proof)
    want = at is None
    assert verifier.verify_proof(params, vk, {}, proof) is want
    assert verifier.verify_proof(params, vk, {}, proof,
                                 native=False) is want
