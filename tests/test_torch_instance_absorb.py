"""Instance binding in the port's two transcript modes against the JAX
package's, following ``tests/test_instance_absorb.py``: on the toy circuit
with an instance column (pub[0] = b[1], ``instance_len`` 2), the whole v1
and halo2ce proofs (SRS seed 2, blind seed 3) equal the JAX prover's
bytes and verify in their mode only; a changed public value is rejected in
both modes; in halo2ce mode a nonzero row past the declared prefix is
rejected by the verifier and raised on by the prover, and so is a circuit
that declares no length. The JAX proofs are pinned (its prover compiles
for minutes on the CPU) and the `heavy` test recomputes the pins."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from test_torch_keygen import params_for, toy
from zkodst_tpu_torch.circuit.expr import V
from zkodst_tpu_torch.circuit.ir import CircuitDef, CopyGroup, Gate, Lookup
from zkodst_tpu_torch.ops import u64
from zkodst_tpu_torch.proof import keygen, prover, verifier

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

# the JAX package's proofs of pub_circuit() with blind seed 3 (SRS seed 2)
PUB_SHA256 = {
    "v1": "dc4b2308c7603649dfb7af3239008a36111d85d804d7ed6a3f27493765cd18b9",
    "halo2ce":
        "93b8a63101f78079db4e36bd1a7bc0bdc7f9452adac6928f7d2413940e588257",
}


def pub_circuit(ir=None, expr_v=V):
    """The toy circuit with an instance column: pub[0] must equal b[1]
    (tests/test_instance_absorb.py), in the port's IR unless `ir` names
    the reference's module."""
    toy_circ, _ = toy(5)
    if ir is None:
        ir = CircuitDef, CopyGroup, Gate, Lookup
    cdef, copy, gate, lookup = ir
    circ = cdef(
        k=5, advice_names=["a", "b"], instance_names=["pub"],
        fixed={"q": toy_circ.fixed["q"], "t": toy_circ.fixed["t"]},
        gates=[gate("square",
                    expr_v("q") * (expr_v("a") * expr_v("a") - expr_v("b")))],
        lookups=[lookup("a_range", ["a"], ["t"])],
        copies=[copy("b", np.array([1]), "pub", np.array([0]))],
        instance_len={"pub": 2})
    circ.validate()
    return circ


@pytest.fixture(scope="module")
def case():
    circ = pub_circuit()
    _, wit = toy(5)
    params = params_for(5)
    pk = keygen.keygen(params, circ)
    pub = np.zeros((32, 2), np.uint32)
    pub[0] = wit["b"][1].numpy().astype(np.uint32)
    inst = {"pub": pub}
    proofs = {mode: prover.create_proof(params, pk, wit, inst, seed=3,
                                        transcript_mode=mode)
              for mode in ("v1", "halo2ce")}
    return params, pk, wit, inst, proofs


@pytest.mark.parametrize("mode", ["v1", "halo2ce"])
def test_proof_equals_jax_bytes_and_verifies(case, mode):
    params, pk, _, inst, proofs = case
    proof = proofs[mode]
    assert hashlib.sha256(proof).hexdigest() == PUB_SHA256[mode]
    assert verifier.verify_proof(params, pk.vk, inst, proof, mode) is True
    other = "v1" if mode == "halo2ce" else "halo2ce"
    assert verifier.verify_proof(params, pk.vk, inst, proof, other) is False


@pytest.mark.parametrize("mode", ["v1", "halo2ce"])
def test_changed_instance_rejected(case, mode):
    params, pk, _, inst, proofs = case
    bad = {"pub": inst["pub"].copy()}
    bad["pub"][0] = u64.from_int(12345)
    assert verifier.verify_proof(params, pk.vk, bad, proofs[mode],
                                 mode) is False


def test_halo2ce_rejects_unbound_suffix_rows(case):
    params, pk, wit, inst, proofs = case
    forged = {"pub": inst["pub"].copy()}
    forged["pub"][5] = u64.from_int(999)       # past the prefix of 2
    assert verifier.verify_proof(params, pk.vk, forged, proofs["halo2ce"],
                                 "halo2ce") is False
    with pytest.raises(ValueError, match="unbound"):
        prover.create_proof(params, pk, wit, forged, seed=8,
                            transcript_mode="halo2ce")


def test_halo2ce_requires_declared_length(case):
    params, pk, wit, inst, proofs = case
    circ = pub_circuit()
    circ.instance_len = {}
    pk2 = dataclasses.replace(pk, vk=dataclasses.replace(pk.vk, circ=circ))
    with pytest.raises(ValueError, match="instance_len"):
        prover.create_proof(params, pk2, wit, inst, seed=7,
                            transcript_mode="halo2ce")
    assert verifier.verify_proof(params, pk2.vk, inst, proofs["halo2ce"],
                                 "halo2ce") is False


@pytest.mark.heavy
def test_pins_are_jax_bytes():
    import test_circuit_ir as jtoy
    from zkodst_tpu.circuit import expr as jexpr
    from zkodst_tpu.circuit import ir as jir
    from zkodst_tpu.proof import keygen as jkeygen
    from zkodst_tpu.proof import prover as jprover
    from zkodst_tpu.proof import srs as jsrs

    circ = pub_circuit((jir.CircuitDef, jir.CopyGroup, jir.Gate,
                        jir.Lookup), jexpr.V)
    params = jsrs.setup(5, seed=2)
    pk = jkeygen.keygen(params, circ, msm_window=4)
    wit = jtoy.good_witness()
    pub = np.zeros((32, 2), np.uint32)
    pub[0] = wit["b"][1]
    for mode, want in PUB_SHA256.items():
        proof = jprover.create_proof(params, pk, wit, {"pub": pub}, seed=3,
                                     transcript_mode=mode)
        assert hashlib.sha256(proof).hexdigest() == want
