"""The port's IPA commitment (proof/ipa.py) on its plain path against the
JAX package's, following ``tests/test_ipa.py`` at K = 5: commit, open and
verify round trip, a wrong evaluation, a tampered opening, hiding, the
per-point multiopen and the setup cache; the bytes of one opening, one
per-point multiopen and one compressed multiopen equal the JAX package's
with the same rng seeds (pinned as sha256: the JAX IPA compiles for
minutes on the CPU, and the `heavy` test recomputes the pins); the
generators equal the JAX package's at k = 6 and its hash to the curve at
a dozen indices of k = 17; either package reads the other's
``ipa_bn254_k5.npz``."""

import hashlib
import random
import shutil

import numpy as np
import pytest
import torch

from zkodst_tpu.proof import ipa as jipa
from zkodst_tpu_torch.ops.field import FR, to_limbs16
from zkodst_tpu_torch.proof import ipa, shplonk
from zkodst_tpu_torch.proof.domain import Domain
from zkodst_tpu_torch.proof.transcript import (Blake2bRead, Blake2bWrite,
                                               compress_g1)

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

K = 5
N = 1 << K
P = FR.p
# sha256 of the commitments' compressed bytes and the proof, from the JAX
# package on the inputs below (test_pins_are_jax_bytes recomputes them)
OPENING_SHA256 = \
    "6de5d6f3857d6f0d8eaef64d5ba3a5942d2ad3ed050200f4148661528e17e390"
MULTIOPEN_SHA256 = \
    "9391b70ea5134552cf1fe6bfc45c68b179969b1f477b949df3ab35d5167dad1d"
COMPRESSED_SHA256 = \
    "c3aa398602c8d9215e38b53706e1b625d890563bb4988098a9bb37f319c15ce4"
K17_INDICES = (0, 1, 2, 3, 1000, 4095, 4096, 65535, 65536, 99991,
               131070, 131071)


def _eval(coeffs, x, p=P):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def opening_inputs():
    """(coeffs, blind, x, v) of the pinned opening."""
    rng = random.Random(2024)
    coeffs = [rng.randrange(P) for _ in range(N)]
    blind, x = rng.randrange(P), rng.randrange(P)
    return coeffs, blind, x, _eval(coeffs, x)


def multiopen_inputs():
    """(polys, blinds, (x1, x2)) of the pinned per-point multiopen."""
    rng = random.Random(2025)
    polys = [[rng.randrange(P) for _ in range(N)] for _ in range(3)]
    blinds = [rng.randrange(P) for _ in range(3)]
    return polys, blinds, (rng.randrange(P), rng.randrange(P))


def compressed_inputs():
    """(polys, point sets) of the pinned compressed multiopen: three
    polynomials at {x}, {x, xω} and {xω}."""
    rng = random.Random(2026)
    polys = [[rng.randrange(P) for _ in range(N)] for _ in range(3)]
    x = rng.randrange(P)
    xw = x * Domain(K).omega % P
    return polys, [(x,), (x, xw), (xw,)]


@pytest.fixture(scope="module")
def params():
    return ipa.setup(K, device="cpu")


@pytest.fixture(scope="module")
def opening(params):
    coeffs, blind, x, v = opening_inputs()
    cm = FR.from_ints(coeffs)
    com = ipa.commit(params, cm, blind)
    tw = Blake2bWrite()
    ipa.open_poly(params, cm, blind, x, v, tw, rng=random.Random(5))
    return cm, com, x, v, tw.finalize()


def test_opening_equals_jax_bytes(opening):
    _, com, _, _, proof = opening
    assert len(proof) == K * 64 + 64          # 2 points a round, 2 scalars
    assert hashlib.sha256(compress_g1(com) + proof).hexdigest() \
        == OPENING_SHA256


def test_commit_open_verify_roundtrip(params, opening):
    _, com, x, v, proof = opening
    assert ipa.verify_poly(params, com, x, v, Blake2bRead(proof)) is True


def test_wrong_eval_rejected(params, opening):
    _, com, x, v, proof = opening
    assert ipa.verify_poly(params, com, x, (v + 1) % P,
                           Blake2bRead(proof)) is False


@pytest.mark.parametrize("at", [1, -1], ids=["L0", "rho"])
def test_tampered_proof_rejected(params, opening, at):
    _, com, x, v, proof = opening
    bad = bytearray(proof)
    bad[at] ^= 1
    assert ipa.verify_poly(params, com, x, v, Blake2bRead(bytes(bad))) \
        is False


def test_hiding_commitments_differ(params, opening):
    cm, com, _, _, _ = opening
    assert ipa.commit(params, cm, 7) != com   # same polynomial, new blind


@pytest.fixture(scope="module")
def multiopen(params):
    polys, blinds, xs = multiopen_inputs()
    cms = [FR.from_ints(c) for c in polys]
    coms = [ipa.commit(params, cm, b) for cm, b in zip(cms, blinds)]
    claims_p, claims_v = [], []
    for c, cm, b, com in zip(polys, cms, blinds, coms):
        for x in xs:
            claims_p.append(ipa.IPAClaim(point=x, value=_eval(c, x),
                                         coeffs_mont=cm, blind=b))
            claims_v.append(ipa.IPAClaim(point=x, value=_eval(c, x),
                                         commitment=com))
    tw = Blake2bWrite()
    for com in coms:
        tw.common_point(com)
    ipa.open_claims(params, claims_p, tw, rng=random.Random(6))
    return coms, claims_v, tw.finalize()


def _replay(coms, proof):
    tr = Blake2bRead(proof)
    for com in coms:
        tr.common_point(com)
    return tr


def test_multiopen_equals_jax_bytes(multiopen):
    coms, _, proof = multiopen
    assert len(proof) == 2 * (K * 64 + 64)    # one opening a point
    assert hashlib.sha256(b"".join(compress_g1(c) for c in coms)
                          + proof).hexdigest() == MULTIOPEN_SHA256


def test_multiopen_roundtrip(params, multiopen):
    coms, claims_v, proof = multiopen
    assert ipa.verify_claims(params, claims_v, _replay(coms, proof),
                             n=N) is True


def test_multiopen_wrong_value_rejected(params, multiopen):
    coms, claims_v, proof = multiopen
    bad = [ipa.IPAClaim(point=c.point, value=c.value,
                        commitment=c.commitment) for c in claims_v]
    bad[2].value = (bad[2].value + 1) % P
    assert ipa.verify_claims(params, bad, _replay(coms, proof), n=N) is False


@pytest.fixture(scope="module")
def compressed(params):
    polys, sets = compressed_inputs()
    dom = Domain(K)
    cms = [FR.from_ints(c) for c in polys]
    coms = [ipa.commit(params, cm, 0) for cm in cms]
    claims = [shplonk.Claim(points=pts, evals=tuple(_eval(c, t)
                                                    for t in pts),
                            evals_dev=dom.ntt(cm))
              for c, cm, pts in zip(polys, cms, sets)]
    tw = Blake2bWrite()
    for com in coms:
        tw.common_point(com)
    ipa.open_claims_compressed(params, dom, claims, tw, rng=random.Random(8))
    verify = [shplonk.Claim(points=cl.points, evals=cl.evals,
                            commitment=com)
              for cl, com in zip(claims, coms)]
    return coms, verify, tw.finalize()


def test_compressed_multiopen_equals_jax_bytes(compressed):
    coms, _, proof = compressed
    assert len(proof) == 32 + K * 64 + 64     # W, then one opening
    assert hashlib.sha256(b"".join(compress_g1(c) for c in coms)
                          + proof).hexdigest() == COMPRESSED_SHA256


def test_compressed_multiopen_verifies(params, compressed):
    coms, verify, proof = compressed
    assert ipa.verify_claims_compressed(params, Domain(K), verify,
                                        _replay(coms, proof)) is True
    bad = [shplonk.Claim(points=cl.points, evals=cl.evals,
                         commitment=cl.commitment) for cl in verify]
    bad[1].evals = (bad[1].evals[0], (bad[1].evals[1] + 1) % P)
    assert ipa.verify_claims_compressed(params, Domain(K), bad,
                                        _replay(coms, proof)) is False


def test_generators_equal_jax_k6():
    own, ref = ipa.setup(6, device="cpu"), jipa.setup(6)
    np.testing.assert_array_equal(to_limbs16(own.g), ref.g)
    assert (own.h, own.u) == (ref.h, ref.u)


def test_generators_equal_jax_hash_to_curve_k17():
    cfg = ipa._CFGS["bn254"]
    msgs = [cfg.tag + i.to_bytes(8, "little") for i in K17_INDICES]
    got = cfg.dev.to_affine_ints(ipa.generators(cfg, msgs, "cpu"))
    assert got == [jipa._hash_to_curve(cfg.tag, i) for i in K17_INDICES]
    assert got == [ipa._hash_to_curve(cfg.tag, i) for i in K17_INDICES]


def test_setup_cache_roundtrip(tmp_path, params):
    p2 = ipa.setup(K, cache_dir=str(tmp_path), device="cpu")
    p3 = ipa.setup(K, cache_dir=str(tmp_path), device="cpu")
    assert torch.equal(p2.g, p3.g) and (p2.h, p2.u) == (p3.h, p3.u)
    assert torch.equal(p2.g, params.g)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["ipa_bn254_k5.npz"]


def test_cache_read_across_packages(tmp_path, params):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    ref = jipa.setup(K, cache_dir=str(jdir))
    shutil.copytree(jdir, tdir)
    own = ipa.setup(K, cache_dir=str(tdir), device="cpu")    # JAX's file
    np.testing.assert_array_equal(to_limbs16(own.g), ref.g)
    assert (own.h, own.u) == (ref.h, ref.u)
    port_dir = tmp_path / "port"
    ipa.setup(K, cache_dir=str(port_dir), device="cpu")      # the port's
    back = jipa.setup(K, cache_dir=str(port_dir))
    np.testing.assert_array_equal(back.g, ref.g)
    assert (back.h, back.u) == (ref.h, ref.u)


def test_unreadable_cache_is_made_again(tmp_path, params):
    (tmp_path / "ipa_bn254_k5.npz").write_bytes(b"not an archive")
    again = ipa.setup(K, cache_dir=str(tmp_path), device="cpu")
    assert torch.equal(again.g, params.g)
    assert ipa.load(str(tmp_path / "ipa_bn254_k5.npz"), K,
                    device="cpu").h == params.h


@pytest.mark.heavy
def test_pins_are_jax_bytes():
    import jax.numpy as jnp

    from zkodst_tpu.ops.field import FR as JFR
    from zkodst_tpu.proof import shplonk as jshplonk
    from zkodst_tpu.proof.domain import Domain as JDomain
    from zkodst_tpu.proof.transcript import Blake2bWrite as JWrite

    params = jipa.setup(K)
    coeffs, blind, x, v = opening_inputs()
    cm = np.asarray(JFR.from_ints(coeffs))
    com = jipa.commit(params, cm, blind)
    tw = JWrite()
    jipa.open_poly(params, cm, blind, x, v, tw, rng=random.Random(5))
    assert hashlib.sha256(compress_g1(com) + tw.finalize()).hexdigest() \
        == OPENING_SHA256

    polys, blinds, xs = multiopen_inputs()
    cms = [np.asarray(JFR.from_ints(c)) for c in polys]
    coms = [jipa.commit(params, c, b) for c, b in zip(cms, blinds)]
    claims = [jipa.IPAClaim(point=t, value=_eval(c, t), coeffs_mont=cm,
                            blind=b)
              for c, cm, b in zip(polys, cms, blinds) for t in xs]
    tw = JWrite()
    for c in coms:
        tw.common_point(c)
    jipa.open_claims(params, claims, tw, rng=random.Random(6))
    assert hashlib.sha256(b"".join(compress_g1(c) for c in coms)
                          + tw.finalize()).hexdigest() == MULTIOPEN_SHA256

    polys, sets = compressed_inputs()
    dom = JDomain(K)
    coms = [jipa.commit(params, np.asarray(JFR.from_ints(c)), 0)
            for c in polys]
    claims = [jshplonk.Claim(points=pts, evals=tuple(_eval(c, t)
                                                     for t in pts),
                             evals_dev=dom.ntt(jnp.asarray(
                                 JFR.from_ints(c))))
              for c, pts in zip(polys, sets)]
    tw = JWrite()
    for c in coms:
        tw.common_point(c)
    jipa.open_claims_compressed(params, dom, claims, tw,
                                rng=random.Random(8))
    assert hashlib.sha256(b"".join(compress_g1(c) for c in coms)
                          + tw.finalize()).hexdigest() == COMPRESSED_SHA256
