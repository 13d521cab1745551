"""The plain reference: BLAKE2f against the EIP-152 appendix, the circuit
and key against the port's and the JAX package's golden digest, the
verifier on the golden proof, and the IPA pieces at small sizes."""

import json
import os
import random

import numpy as np
import pytest

from zkbench.reference import blake2f, circuit, curve, field, verify
from zkbench.tests import fakes

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN_VK_DIGEST = \
    0x23d17472fd8d45e005dde8860ad03c8842f020047a2f1188bd087afc65f53415


def _decode(raw: bytes):
    rounds = int.from_bytes(raw[:4], "big")
    words = [int.from_bytes(raw[4 + 8 * i: 12 + 8 * i], "little")
             for i in range(26)]
    return rounds, words[:8], words[8:24], words[24:26], raw[212]


@pytest.mark.parametrize("n", [4, 5, 6, 7])
def test_blake2f_eip152_vectors(n):
    with open(os.path.join(DATA, "eip152_vectors.json")) as fh:
        vec = next(v for v in json.load(fh)["vectors"] if v["n"] == n)
    rounds, h, m, t, f = _decode(bytes.fromhex(vec["input"]))
    out = blake2f.compress(np.array([h], np.uint64), np.array([m], np.uint64),
                           np.array([t], np.uint64), np.array([f == 1]),
                           rounds)
    got = b"".join(int(x).to_bytes(8, "little") for x in out[0])
    assert got.hex() == vec["output"]


def test_blake2f_batch_matches_one_by_one():
    rng = np.random.default_rng(1)
    h = rng.integers(0, 1 << 64, (5, 8), dtype=np.uint64)
    m = rng.integers(0, 1 << 64, (5, 16), dtype=np.uint64)
    t = rng.integers(0, 1 << 64, (5, 2), dtype=np.uint64)
    f = np.array([1, 0, 1, 1, 0], bool)
    batch = blake2f.compress(h, m, t, f)
    for i in range(5):
        one = blake2f.compress(h[i:i + 1], m[i:i + 1], t[i:i + 1],
                               f[i:i + 1])
        assert (one[0] == batch[i]).all()


def test_circuit_matches_the_port():
    """The frozen layout, gates and copy permutation equal the port's."""
    from zkodst_tpu_torch.circuit import blake2f as port
    from zkodst_tpu_torch.proof import keygen

    pc = port.Blake2fCircuit(17, 3, 12, device="cpu")
    c = circuit.build(17, 3, 12)
    assert sorted(pc.circ.fixed) == sorted(c.fixed)
    for nm, col in pc.circ.fixed.items():
        words = col[:, 0].astype(np.uint64) | \
            (col[:, 1].astype(np.uint64) << np.uint64(32))
        assert (words == c.fixed[nm]).all(), nm
    assert [(g.name, repr(g.poly)) for g in pc.circ.gates] == \
        [(nm, repr(g)) for nm, g in c.gates]
    perm = keygen.perm_columns(pc.circ)
    assert perm == c.perm_cols
    cm, rm = c.sigma()
    for i, (a, b) in enumerate(keygen._build_sigma(pc.circ, perm)):
        assert (a == cm[i]).all() and (b == rm[i]).all()


def test_kzg_key_is_the_golden_one():
    """The reference's key of the flagship (k = 17, 37 instances, SRS seed
    0), worked out from τ, has the JAX package's golden digest."""
    key = fakes.reference_key(37)
    assert key.digest() == GOLDEN_VK_DIGEST


def test_golden_proof_verifies_and_faults_do_not():
    c = circuit.build(17, 37, 12)
    key = fakes.reference_key(37)
    tau = verify.kzg_tau(17, 0)
    pub = fakes.golden_pub()
    proof = fakes.golden_proof()
    verify.verify_kzg(c, key, tau, pub, proof)
    bad = bytearray(proof)
    bad[-40] ^= 2
    with pytest.raises(verify.Rejected):
        verify.verify_kzg(c, key, tau, pub, bytes(bad))
    other = pub.copy()
    other[circuit.ROW_OUT + 5 * circuit.R_PUB] ^= np.uint64(1 << 40)
    with pytest.raises(verify.Rejected):
        verify.verify_kzg(c, key, tau, other, proof)
    with pytest.raises(verify.Rejected):
        verify.verify_kzg(c, key, tau, pub, proof[:-32])
    with pytest.raises(verify.Rejected):
        verify.verify_kzg(c, key, tau + 1, pub, proof)


def test_instance_column_layout():
    h = np.arange(16, dtype=np.uint64).reshape(2, 8)
    m = np.arange(32, dtype=np.uint64).reshape(2, 16) + 100
    t = np.array([[7, 0], [9, 0]], np.uint64)
    f = np.array([True, False])
    col = circuit.instance_column(1 << 10, h, m, t, f, 12)
    out = blake2f.compress(h, m, t, f)
    for b in range(2):
        base = b * circuit.R_PUB
        assert col[base] == t[b, 0] and col[base + circuit.ROW_F] == f[b]
        assert (col[base + circuit.ROW_H: base + circuit.ROW_M] == h[b]).all()
        assert (col[base + circuit.ROW_OUT: base + circuit.R_PUB]
                == out[b]).all()
    assert not col[2 * circuit.R_PUB:].any()


def test_field_helpers():
    w = field.root_of_unity(4)
    assert pow(w, 16, field.R) == 1 and pow(w, 8, field.R) != 1
    xs = [3, 5, 7, 11]
    assert field.batch_inv(xs) == [pow(x, -1, field.R) for x in xs]
    vals = [random.Random(i).randrange(field.R) for i in range(16)]
    coeffs = field.intt(vals, w)
    for i, v in enumerate(vals):
        x = pow(w, i, field.R)
        assert sum(c * pow(x, j, field.R) for j, c in enumerate(coeffs)) \
            % field.R == v


def test_curve_and_msm_window():
    rng = random.Random(3)
    pts = [curve.mul(curve.GEN, rng.randrange(1, field.R)) for _ in range(20)]
    ks = [rng.randrange(field.R) for _ in range(20)]
    ks[3] = 0
    want = curve.lin_comb(pts, ks)
    for c in (3, 8):
        sums = [curve.msm_window(pts, ks, c, w) for w in range(-(-256 // c))]
        assert curve.combine_windows(sums, c) == want
    assert curve.decompress(curve.compress(want)) == want


def test_ipa_generators_match_the_port():
    from zkodst_tpu_torch.proof import ipa as port_ipa

    raw = verify._generators_bytes(0, 4) + verify._generators_bytes(500, 502)
    ours = verify._points_of(raw)
    theirs = [port_ipa._hash_to_curve(b"zkodst-ipa-g", i)
              for i in (0, 1, 2, 3, 500, 501)]
    assert ours == theirs
    assert verify._hash_to_curve(b"zkodst-ipa-h" + bytes(8)) == \
        port_ipa._hash_to_curve(b"zkodst-ipa-h", 0)


def test_ipa_batch_check_at_small_size():
    """The one-MSM check: an opening-shaped claim and a key combination
    hold when they are right and fail when either is off."""
    import multiprocessing

    k = 4
    n = 1 << k
    raw = verify._generators_bytes(0, n)
    gens = verify._points_of(raw)
    params = verify.IpaParams(k, raw, verify._hash_to_curve(b"h"),
                              verify._hash_to_curve(b"u"))
    rng = random.Random(5)
    us = [rng.randrange(1, field.R) for _ in range(k)]
    a0 = rng.randrange(field.R)
    s = verify.s_vector(us)
    g0 = curve.lin_comb(gens, s)
    rest = curve.neg(curve.mul(g0, a0))              # a0·G0 + rest = 0
    good = verify.IpaPending(a0, s, rest)
    cols = [[rng.randrange(field.R) for _ in range(n)] for _ in range(2)]
    omega = field.root_of_unity(k)
    coms = [curve.lin_comb(gens, field.intt(col, omega)) for col in cols]
    key = verify.Key(k, {"a": coms[0]}, [coms[1]])
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        def holds(pending, key, cols):
            return verify.ipa_batch_holds(pool, params, pending, key, cols,
                                          random.Random(9))
        assert holds([good], key, cols)
        assert not holds([verify.IpaPending(a0 + 1, s, rest)], key, cols)
        bad_key = verify.Key(k, {"a": coms[1]}, [coms[1]])
        assert not holds([good], bad_key, cols)
        assert holds([], key, cols)
        pool.close()
        pool.join()
