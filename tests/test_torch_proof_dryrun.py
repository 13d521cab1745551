"""The port's whole proofs of the toy circuit at k = 5 and 6 (plain path)
against ``tests/golden/dryrun_proof_k{5,6}_v1.json`` (SRS seed 2, blind
seed 11): at k = 5 with the reference's cached key, at k = 6 with the
port's own keygen, whose extended-coset selectors equal the cached key's
``sel_*``. The port's verifier accepts both. Exact bytes."""

import json
import os

import pytest
import torch

from test_torch_keygen import GOLDEN, cached_npz, params_for, toy
from zkodst_tpu_torch.ops.field import to_limbs16
from zkodst_tpu_torch.proof import keygen, prover, verifier

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

CASES = {"dryrun_proof_k5_v1": (5, "cached"),
         "dryrun_proof_k6_v1": (6, "keygen")}
_PROOFS: dict = {}


def _case(fixture):
    """(params, pk, proof, golden bytes), made once per fixture."""
    if fixture not in _PROOFS:
        with open(os.path.join(GOLDEN, f"{fixture}.json")) as fh:
            g = json.load(fh)
        k, key = CASES[fixture]
        circ, wit = toy(k)
        params = params_for(k)
        pk = (keygen.from_numpy(cached_npz(circ), params, circ)
              if key == "cached" else keygen.keygen(params, circ))
        proof = prover.create_proof(params, pk, wit, {},
                                    seed=g["blind_seed"])
        _PROOFS[fixture] = (params, pk, proof, bytes.fromhex(g["proof_hex"]))
    return _PROOFS[fixture]


@pytest.mark.parametrize("fixture", sorted(CASES))
def test_whole_proof_equals_fixture(fixture):
    _, _, proof, want = _case(fixture)
    assert len(proof) == len(want) == 928
    assert proof == want


@pytest.mark.parametrize("fixture", sorted(CASES))
def test_verifier_accepts_proof_and_fixture(fixture):
    params, pk, proof, want = _case(fixture)
    assert verifier.verify_proof(params, pk.vk, {}, proof) is True
    assert verifier.verify_proof(params, pk.vk, {}, want) is True


def test_own_keygen_selectors_equal_cached_key():
    _, pk, _, _ = _case("dryrun_proof_k6_v1")
    npz = cached_npz(toy(6)[0])
    for name, sel in pk.ext_selectors.items():
        assert sel.shape == (4 << 6, 8)
        assert (to_limbs16(sel) == npz[f"sel_{name}"]).all()
