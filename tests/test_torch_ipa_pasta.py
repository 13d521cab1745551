"""The IPA backend on the Pasta pallas curve against the JAX package's,
following ``tests/test_ipa_pasta.py`` (K = 3): the pallas group operations
on the plain path against the host oracle, the generators on the curve
and equal to the JAX package's, and commit, open and verify with a wrong
value and a tampered byte rejected, the opening's bytes equal to the JAX
package's (pinned as sha256; the `heavy` test recomputes the pin), its
MSMs on the Pippenger of ops/msm.py (kernels 9–12 on pallas) and never on
the double-and-add, and the generators' square roots made at once on the
device; and the ``"pasta"`` transcript mode: its point codec round trip,
its scalars mod VESTA_BASE, and malformed encodings raising ValueError."""

import hashlib
import random

import numpy as np
import pytest
import torch

from zkodst_tpu.proof import ipa as jipa
from zkodst_tpu.proof import transcript as jtranscript
from zkodst_tpu_torch.ops import curve, msm, pycurve
from zkodst_tpu_torch.ops.field import PASTA_FR, to_limbs16
from zkodst_tpu_torch.ops.pyfield import PALLAS_BASE, VESTA_BASE
from zkodst_tpu_torch.proof import ipa
from zkodst_tpu_torch.proof.transcript import (Blake2bRead, Blake2bWrite,
                                               compress_pasta,
                                               decompress_pasta)

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

K = 3
GEN, G = pycurve.PASTA_G1_GEN, pycurve.PASTA_G1
# sha256 of the commitment's bytes and the opening, from the JAX package
# on the inputs of test_ipa_pasta.py (test_pin_is_jax_bytes recomputes it)
OPENING_SHA256 = \
    "45ec9cce8eb33a67d7b2aaf18b264418dfae711658e1309df5473a1edc4d9524"


def test_pasta_constants():
    assert pycurve.PASTA_G1.order == VESTA_BASE
    assert pycurve.PASTA_G1.is_on_curve(GEN)
    assert PALLAS_BASE.bit_length() == VESTA_BASE.bit_length() == 255
    assert curve.PASTA.b3 == 15 and curve.PASTA.F.kernel_id == 2
    assert PASTA_FR.kernel_id == 3


def test_pasta_device_ops_match_host_oracle():
    pts = [G.mul(GEN, 3 * i + 2) for i in range(4)]
    dev = curve.PASTA.from_affine_ints(pts)
    s = curve.PASTA.add(dev[:2], dev[2:])
    assert curve.PASTA.to_affine_ints(s) == [G.add(pts[0], pts[2]),
                                            G.add(pts[1], pts[3])]
    assert curve.PASTA.to_affine_ints(curve.PASTA.double(dev)) == \
        [G.add(p, p) for p in pts]
    idp = curve.PASTA.identity((1,))
    assert curve.PASTA.to_affine_ints(curve.PASTA.add(idp, dev[:1])) == \
        pts[:1]
    neg = curve.PASTA.from_affine_ints([G.neg(pts[0])])
    assert curve.PASTA.to_affine_ints(curve.PASTA.add(dev[:1], neg)) == \
        [None]


def test_pasta_scalar_mul_matches_host_oracle():
    pts = [G.mul(GEN, 5 * i + 1) for i in range(3)]
    ks = [0, 1, VESTA_BASE - 2]
    got = curve.PASTA.scalar_mul(curve.PASTA.from_affine_ints(pts),
                                 torch.from_numpy(np.stack([
                                     np.frombuffer(k.to_bytes(32, "little"),
                                                   np.int32)
                                     for k in ks])))
    assert curve.PASTA.to_affine_ints(got) == [G.mul(p, k)
                                               for p, k in zip(pts, ks)]


@pytest.fixture(scope="module")
def params():
    return ipa.setup(K, curve_name="pasta", device="cpu")


def test_pasta_generators_on_curve_and_equal_jax(params):
    assert params.curve == "pasta"
    pts = curve.PASTA.to_affine_ints(params.g)
    assert all(G.is_on_curve(p) for p in pts)
    assert G.is_on_curve(params.h) and G.is_on_curve(params.u)
    ref = jipa.setup(K, curve_name="pasta")
    np.testing.assert_array_equal(to_limbs16(params.g), ref.g)
    assert (params.h, params.u) == (ref.h, ref.u)


def _inputs():
    p = VESTA_BASE
    coeffs = [(7 * i + 3) % p for i in range(1 << K)]
    x = 987654321
    v = 0
    for c in reversed(coeffs):
        v = (v * x + c) % p
    return coeffs, 12345, x, v


@pytest.fixture(scope="module")
def opening(params):
    coeffs, blind, x, v = _inputs()
    cm = PASTA_FR.from_ints(coeffs)
    com = ipa.commit(params, cm, blind)
    tw = Blake2bWrite("pasta")
    ipa.open_poly(params, cm, blind, x, v, tw, rng=random.Random(1))
    return com, x, v, tw.finalize()


def test_pasta_opening_equals_jax_bytes(opening):
    com, _, _, proof = opening
    assert G.is_on_curve(com)
    assert len(proof) == K * 64 + 64
    assert hashlib.sha256(compress_pasta(com) + proof).hexdigest() \
        == OPENING_SHA256


def test_pasta_ipa_commit_open_verify(params, opening):
    com, x, v, proof = opening
    n = 1 << K
    assert ipa.verify_poly(params, com, x, v, Blake2bRead(proof, "pasta"),
                           n=n) is True
    assert ipa.verify_poly(params, com, x, (v + 1) % VESTA_BASE,
                           Blake2bRead(proof, "pasta"), n=n) is False
    bad = bytearray(proof)
    bad[1] ^= 1
    assert ipa.verify_poly(params, com, x, v,
                           Blake2bRead(bytes(bad), "pasta"), n=n) is False


def test_pasta_msms_are_pippenger(params, monkeypatch):
    """Commit and verify on pallas reach msm_many with the pallas curve,
    and no call reaches Curve.scalar_mul (the reference's ladder)."""
    seen = []
    real = msm.msm_many

    def rec(points, scalars, c=8, scalar_bits=None, curve=curve.BN254):
        seen.append((curve.name, tuple(scalars.shape)))
        return real(points, scalars, c, scalar_bits, curve)

    def ladder(*_):
        raise AssertionError("a pallas MSM reached Curve.scalar_mul")

    monkeypatch.setattr(msm, "msm_many", rec)
    monkeypatch.setattr(curve.Curve, "scalar_mul", ladder)
    coeffs, blind, x, v = _inputs()
    com = ipa.commit(params, PASTA_FR.from_ints(coeffs), blind)
    assert seen == [("pallas", (1, 1 << K, 8))]
    assert G.is_on_curve(com)


def test_pasta_sqrt_on_device_matches_host():
    """The generators' Tonelli–Shanks over all candidates at once: a root
    of every square (0 included), none taken for a non-square."""
    cfg = ipa._CFGS["pasta"]
    r = random.Random(5)
    vals = [r.randrange(PALLAS_BASE) for _ in range(24)] + [0, 1, 4, 13]
    roots = cfg.dev.F.to_ints(ipa._sqrt(cfg, cfg.dev.F.from_ints(vals)))
    for a, y in zip(vals, roots):
        host = cfg.base_pf.sqrt(a)
        assert (int(y) ** 2 % PALLAS_BASE == a) == (host is not None)
    assert sum(cfg.base_pf.sqrt(a) is not None for a in vals) >= 10


def test_pasta_codec_roundtrip_equals_jax():
    for i in range(1, 9):
        q = G.mul(GEN, 11 * i + 4)
        enc = compress_pasta(q)
        assert enc == jtranscript.compress_pasta(q)
        assert decompress_pasta(enc) == q
    assert compress_pasta(None) == bytes(32)
    assert decompress_pasta(bytes(32)) is None
    # x above 2^254 (the generator's x = p − 1) keeps bit 254
    assert compress_pasta(GEN)[31] & 0x40
    assert decompress_pasta(compress_pasta(GEN)) == GEN


def test_pasta_transcript_equals_jax():
    q = G.mul(GEN, 777)
    t, j = Blake2bWrite("pasta"), jtranscript.Blake2bWrite(mode="pasta")
    for tr in (t, j):
        tr.common_point(q)
        tr.write_point(q)
        tr.write_scalar(VESTA_BASE + 5)
    assert t.squeeze_challenge() == j.squeeze_challenge()
    assert t.finalize() == j.finalize()
    r = Blake2bRead(t.finalize(), "pasta")
    r.common_point(q)
    assert r.read_point() == q and r.read_scalar() == 5


# x = 2: 2³ + 5 = 13 is no square mod PALLAS_BASE
@pytest.mark.parametrize("data", [
    PALLAS_BASE.to_bytes(32, "little"),
    (2).to_bytes(32, "little"),
    bytes(31)], ids=["x_out_of_range", "not_on_curve", "short"])
def test_pasta_malformed_point_raises(data):
    with pytest.raises(ValueError):
        decompress_pasta(data)
    with pytest.raises(ValueError):
        Blake2bRead(data, "pasta").read_point()


def test_pasta_scalar_out_of_range_raises():
    with pytest.raises(ValueError, match="scalar out of range"):
        Blake2bRead(VESTA_BASE.to_bytes(32, "little"), "pasta").read_scalar()


@pytest.mark.heavy
def test_pin_is_jax_bytes():
    from zkodst_tpu.proof.transcript import Blake2bWrite as JWrite

    params = jipa.setup(K, curve_name="pasta")
    coeffs, blind, x, v = _inputs()
    cm = jipa.PASTA_FR.from_ints(coeffs)
    com = jipa.commit(params, cm, blind)
    tw = JWrite(mode="pasta")
    jipa.open_poly(params, cm, blind, x, v, tw, rng=random.Random(1))
    assert hashlib.sha256(compress_pasta(com) + tw.finalize()).hexdigest() \
        == OPENING_SHA256
