"""The port's halo2ce transcript mode against the JAX package's, following
``tests/test_transcript_compat.py``: the halo2curves point layout
round-trips and carries its sign in bit 6, not v1's bit 7; the two modes
absorb points differently and scalars alike; the verifying key enters as
one scalar equal to the JAX key's ``transcript_repr``; and the toy
circuit's whole halo2ce proof (SRS seed 2, blind seed 7) equals the JAX
prover's bytes, verifies in halo2ce mode only, and is rejected with a
flipped point or scalar byte and with bit 255 of a point set. The JAX
proof is pinned (its prover compiles for minutes on the CPU) and the
`heavy` test recomputes the pins."""

import hashlib
import json
import os

import pytest
import torch

from test_torch_keygen import GOLDEN, cached_npz, params_for, toy
from zkodst_tpu.proof import transcript as jtranscript
from zkodst_tpu_torch.ops import pycurve
from zkodst_tpu_torch.proof import keygen, prover, verifier
from zkodst_tpu_torch.proof.transcript import (
    MODES, Blake2bRead, Blake2bWrite, compress_g1, compress_g1_halo2ce,
    decompress_g1, decompress_g1_halo2ce)

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

# the JAX package on the toy circuit (SRS seed 2, keygen msm_window 4):
# the vk's transcript_repr and the halo2ce proof with blind seed 7
TOY_REPR = "0x46fde7981df56261991c9ed5728388aec5de562a3fe7b9693fff74e4dbf9b3f"
TOY_HALO2CE_SHA256 = \
    "67faebce827d431cd88ee9cf74712511f1d2e1b822571f709c60762309195911"
N_POINTS = 10           # points before the first evaluation (as v1)


def _odd_y_point():
    for i in range(1, 20):
        q = pycurve.G1.mul(pycurve.G1_GEN, i)
        if q[1] & 1:
            return q
    raise AssertionError("no point with odd y")


def test_modes():
    assert MODES == ("v1", "halo2ce", "pasta") == jtranscript.MODES
    with pytest.raises(ValueError, match="transcript mode"):
        Blake2bWrite("v2")
    with pytest.raises(ValueError, match="transcript mode"):
        Blake2bRead(b"", "v2")


def test_halo2ce_point_layout_roundtrip_equals_jax():
    for i in range(1, 8):
        q = pycurve.G1.mul(pycurve.G1_GEN, i * 7 + 1)
        enc = compress_g1_halo2ce(q)
        assert enc == jtranscript.compress_g1_halo2ce(q)
        assert len(enc) == 32 and enc[31] & 0x80 == 0
        assert decompress_g1_halo2ce(enc) == q
    assert compress_g1_halo2ce(None) == bytes(32)
    assert decompress_g1_halo2ce(bytes(32)) is None


def test_halo2ce_sign_bit_differs_from_v1():
    q = _odd_y_point()
    v1, ce = compress_g1(q), compress_g1_halo2ce(q)
    assert v1[:31] == ce[:31]
    assert v1[31] & 0x80 and not v1[31] & 0x40
    assert ce[31] & 0x40 and not ce[31] & 0x80
    # neither decoder takes the other's sign bit: v1 refuses bit 254, and
    # halo2ce refuses bit 255
    with pytest.raises(ValueError, match="bit 254"):
        decompress_g1(ce)
    with pytest.raises(ValueError, match="bit 255"):
        decompress_g1_halo2ce(v1)


def test_absorption_rules_equal_jax():
    q = pycurve.G1.mul(pycurve.G1_GEN, 12345)
    chal = {}
    for mode in MODES:
        t, j = Blake2bWrite(mode), jtranscript.Blake2bWrite(mode=mode)
        for tr in (t, j):
            tr.common_point(q)
            tr.common_scalar(42)
            tr.write_point(q)
        chal[mode] = t.squeeze_challenge()
        assert chal[mode] == j.squeeze_challenge()
        assert t.finalize() == j.finalize()
    assert chal["v1"] != chal["halo2ce"]


@pytest.fixture(scope="module")
def toy_case():
    circ, wit = toy(5)
    params = params_for(5)
    pk = keygen.from_numpy(cached_npz(circ), params, circ)
    proof = prover.create_proof(params, pk, wit, {}, seed=7,
                                transcript_mode="halo2ce")
    return params, pk.vk, proof


def test_vk_binds_as_one_scalar(toy_case):
    _, vk, _ = toy_case
    assert hex(vk.transcript_repr()) == TOY_REPR
    tw = Blake2bWrite("halo2ce")
    vk.hash_into(tw)
    tw2 = Blake2bWrite("halo2ce")
    tw2.common_scalar(vk.transcript_repr())
    assert tw.squeeze_challenge() == tw2.squeeze_challenge()


def test_whole_halo2ce_proof_equals_jax_bytes(toy_case):
    _, _, proof = toy_case
    assert len(proof) == 928
    assert hashlib.sha256(proof).hexdigest() == TOY_HALO2CE_SHA256


def test_halo2ce_proof_verifies_in_its_mode_only(toy_case):
    params, vk, proof = toy_case
    assert verifier.verify_proof(params, vk, {}, proof, "halo2ce") is True
    assert verifier.verify_proof(params, vk, {}, proof) is False
    with open(os.path.join(GOLDEN, "toy_proof_v1.json")) as fh:
        v1 = bytes.fromhex(json.load(fh)["proof_hex"])
    assert verifier.verify_proof(params, vk, {}, v1) is True
    assert verifier.verify_proof(params, vk, {}, v1, "halo2ce") is False


@pytest.mark.parametrize("at,mask", [(32 + 5, 1), (31, 0x80),
                                     (32 * N_POINTS, 1)],
                         ids=["point", "point_bit_255", "scalar"])
def test_halo2ce_verifier_rejects_flipped_byte(toy_case, at, mask):
    params, vk, proof = toy_case
    bad = bytearray(proof)
    bad[at] ^= mask
    assert verifier.verify_proof(params, vk, {}, bytes(bad),
                                 "halo2ce") is False


def test_read_transcript_replays_halo2ce(toy_case):
    _, _, proof = toy_case
    pt = Blake2bRead(proof, "halo2ce").read_point()
    assert pt is None or pycurve.G1.is_on_curve(pt)


@pytest.mark.heavy
def test_halo2ce_pins_are_jax_bytes():
    import test_circuit_ir as jtoy
    from zkodst_tpu.proof import keygen as jkeygen
    from zkodst_tpu.proof import prover as jprover
    from zkodst_tpu.proof import srs as jsrs

    circ = jtoy.toy_circuit()
    params = jsrs.setup(circ.k, seed=2)
    pk = jkeygen.keygen(params, circ, msm_window=4)
    assert hex(pk.vk.transcript_repr()) == TOY_REPR
    proof = jprover.create_proof(params, pk, jtoy.good_witness(), {},
                                 seed=7, transcript_mode="halo2ce")
    assert hashlib.sha256(proof).hexdigest() == TOY_HALO2CE_SHA256
