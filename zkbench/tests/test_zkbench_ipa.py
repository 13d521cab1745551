"""The IPA reference on a proof the port made on the card (k = 17, 37
random compressions, with its verifying key's commitments): it verifies,
and a flipped byte, a batch half of which the proof does not cover, and a
tampered key are each caught."""

import json
import os

import numpy as np
import pytest

from zkbench.reference import check

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "ipa_proof_k17.json")
CONFIG = {"scheme": "ipa", "k": 17, "rounds": 12}


@pytest.fixture(scope="module")
def fixture():
    with open(DATA) as fh:
        d = json.load(fh)

    def words(rows):
        return np.array([[int(x, 16) for x in r] for r in rows], np.uint64)

    def point(p):
        return None if p is None else (int(p[0], 16), int(p[1], 16))

    key = {"fixed": {k: point(v) for k, v in d["fixed"].items()},
           "sigma": [point(p) for p in d["sigma"]]}
    return (words(d["h"]), words(d["m"]), words(d["t"]),
            np.array(d["f"], bool), bytes.fromhex(d["proof"]), key)


def _sample(i, h, m, t, f, proof):
    return check.Sample(i, h, m, t, f, proof, pub=None)


def test_ipa_reference_accepts_and_catches(fixture):
    h, m, t, f, proof, key = fixture
    flipped = bytearray(proof)
    flipped[-70] ^= 4
    half = h.copy()
    half[18:, 3] ^= np.uint64(1 << 20)
    samples = [_sample(0, h, m, t, f, proof),
               _sample(1, h, m, t, f, bytes(flipped)),
               _sample(2, half, m, t, f, proof),
               _sample(3, h, m, t, f, proof)]
    got = check.judge(CONFIG, 37, samples, key, 0, 11, log=lambda s: None)
    assert got["proofs_rejected"] == 2
    assert got["key_check_failed"] == 0


def test_ipa_reference_catches_a_tampered_key(fixture):
    h, m, t, f, proof, key = fixture
    bad = {"fixed": dict(key["fixed"]), "sigma": list(key["sigma"])}
    bad["sigma"][3], bad["sigma"][4] = bad["sigma"][4], bad["sigma"][3]
    got = check.judge(CONFIG, 37, [_sample(0, h, m, t, f, proof)], bad, 0,
                      12, log=lambda s: None)
    assert got["key_check_failed"] == 1
    assert not check.verdict(got)
