"""keygen → create_proof → verify_proof over the IPA backend on the toy
circuit, following ``tests/test_ipa_pipeline.py``: the whole proof (blind
seed 3) equals the JAX package's bytes and the verifying key's transcript
digest equals its digest (both pinned: the JAX IPA pipeline compiles for
minutes on the CPU, and the `heavy` test recomputes the pins); the proof
verifies, and is rejected with a byte flipped at its start, middle and
end; a bad witness is rejected; the blinds follow the seed; a KZG proof
does not verify under the IPA key (nor the IPA proof under the KZG key);
the key's cache file is ``pk_ipa_<fingerprint>.npz``. ``chip_smoke.py``
holds the card's toy proof to the same pin."""

import hashlib
import json
import os

import pytest
import torch

from test_torch_keygen import GOLDEN, cached_npz, params_for, toy, vk_digest
from zkodst_tpu_torch.proof import ipa, keygen, prover, verifier

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

# the JAX package on the toy circuit (ipa.setup(5), keygen msm_window 4):
# the vk's transcript digest and the proof with blind seed 3
TOY_IPA_VK_DIGEST = \
    "0x275836325061ee89c097ede0f4c4fded1e72371d51fceab1bbfbce93176decfd"
TOY_IPA_SHA256 = \
    "488377f10558d62a9833b7178e144e45d9294d18e332a90ffcd0b84225e75321"
TOY_IPA_BYTES = 1280     # the KZG toy proof's 928, less W′, plus 5 L/R
                         # pairs and two scalars


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cache = tmp_path_factory.mktemp("pk_cache")
    circ, wit = toy(5)
    params = ipa.setup(circ.k, device="cpu")
    pk = keygen.keygen(params, circ, cache_dir=str(cache))
    proof = prover.create_proof(params, pk, wit, {}, seed=3)
    return circ, wit, params, pk, proof, cache


def test_ipa_proof_equals_jax_bytes(setup):
    *_, proof, _ = setup
    assert len(proof) == TOY_IPA_BYTES
    assert hashlib.sha256(proof).hexdigest() == TOY_IPA_SHA256


def test_ipa_vk_digest_equals_jax(setup):
    _, _, _, pk, _, _ = setup
    assert vk_digest(pk.vk) == TOY_IPA_VK_DIGEST


def test_ipa_prove_and_verify(setup):
    _, _, params, pk, proof, _ = setup
    assert verifier.verify_proof(params, pk.vk, {}, proof) is True


@pytest.mark.parametrize("where", ["start", "middle", "end"])
def test_ipa_proof_tamper_rejected(setup, where):
    _, _, params, pk, proof, _ = setup
    pos = {"start": 0, "middle": len(proof) // 2, "end": len(proof) - 1}
    bad = bytearray(proof)
    bad[pos[where]] ^= 1
    assert verifier.verify_proof(params, pk.vk, {}, bytes(bad)) is False


def test_ipa_bad_witness_rejected(setup):
    _, wit, params, pk, _, _ = setup
    w = {c: v.clone() for c, v in wit.items()}
    w["b"][3] = torch.tensor([999, 0])      # violates the square gate
    proof = prover.create_proof(params, pk, w, {}, seed=5)
    assert verifier.verify_proof(params, pk.vk, {}, proof) is False


def test_ipa_blinds_follow_the_seed(setup):
    """The advice commitments (the proof's first bytes) under seeds 6, 6
    and 7: the blinds are drawn from the seed alone."""
    circ, wit, params, _, proof, _ = setup
    a6 = prover.commit_advice(params, circ, wit, 6)
    assert prover.commit_advice(params, circ, wit, 6) == a6
    assert prover.commit_advice(params, circ, wit, 7) != a6
    assert prover.commit_advice(params, circ, wit, 3) == proof[:len(a6)]


def test_kzg_proof_rejected_by_ipa_params(setup):
    circ, _, params, pk, proof, _ = setup
    with open(os.path.join(GOLDEN, "toy_proof_v1.json")) as fh:
        kzg = bytes.fromhex(json.load(fh)["proof_hex"])
    kzg_params = params_for(5)
    kzg_pk = keygen.from_numpy(cached_npz(circ), kzg_params, circ)
    assert verifier.verify_proof(kzg_params, kzg_pk.vk, {}, kzg,
                                 native=False) is True
    assert verifier.verify_proof(params, pk.vk, {}, kzg) is False
    assert verifier.verify_proof(kzg_params, kzg_pk.vk, {}, proof,
                                 native=False) is False


def test_pk_ipa_cache_naming(setup):
    circ, _, params, pk, _, cache = setup
    name = f"pk_ipa_{keygen.circuit_fingerprint(circ)}.npz"
    assert sorted(os.listdir(cache)) == [name]
    before = os.stat(cache / name).st_mtime_ns
    again = keygen.keygen(params, circ, cache_dir=str(cache))
    assert os.stat(cache / name).st_mtime_ns == before
    assert again.vk.fixed_commitments == pk.vk.fixed_commitments
    assert again.vk.sigma_commitments == pk.vk.sigma_commitments


@pytest.mark.parametrize("pin", ["toy_ipa", "pasta_k3"])
def test_chip_smoke_holds_the_same_pin(pin):
    """The card's check holds the pins these tests hold: the toy circuit's
    IPA proof and the Pasta opening at K = 3 (tests/test_torch_ipa_pasta.py).
    """
    import chip_smoke

    if pin == "toy_ipa":
        assert chip_smoke.TOY_IPA_SHA256 == TOY_IPA_SHA256
        assert chip_smoke.TOY_IPA_BYTES == TOY_IPA_BYTES
    else:
        import test_torch_ipa_pasta

        assert chip_smoke.PASTA_PINS[3] == test_torch_ipa_pasta.OPENING_SHA256


@pytest.mark.heavy
def test_ipa_pins_are_jax_bytes():
    import test_circuit_ir as jtoy
    from zkodst_tpu.proof import ipa as jipa
    from zkodst_tpu.proof import keygen as jkeygen
    from zkodst_tpu.proof import prover as jprover

    circ = jtoy.toy_circuit()
    params = jipa.setup(circ.k)
    pk = jkeygen.keygen(params, circ, msm_window=4)
    assert vk_digest(pk.vk) == TOY_IPA_VK_DIGEST
    proof = jprover.create_proof(params, pk, jtoy.good_witness(), {}, seed=3)
    assert hashlib.sha256(proof).hexdigest() == TOY_IPA_SHA256
