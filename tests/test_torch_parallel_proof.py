"""The port's whole proof sharded over two gloo ranks on the CPU: the toy
circuit (k = 5, SRS seed 2, blind seed 42, the reference's cached key)
proved with ``create_proof(mesh=...)`` equals
``tests/golden/toy_proof_v1.json`` on every rank, as the JAX package's
sharded proof equals its single-device one (``tests/test_sharded_prover.py``),
and the port's verifier accepts it. Without a seed, rank 0's entropy
reaches both ranks: they return the same bytes, which verify. IPA under a
mesh raises, as in the reference."""

import json
import os

import pytest
import torch

from test_torch_keygen import GOLDEN, cached_npz, params_for, toy
from test_torch_parallel import ranks
from zkodst_tpu_torch import api
from zkodst_tpu_torch.parallel import bootstrap
from zkodst_tpu_torch.proof import ipa, keygen, prover, verifier

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

WORLD = 2


def _prove(world):
    """This rank's sharded proofs of the toy circuit: blind seed 42, then
    OS entropy."""
    mesh = bootstrap.make_mesh((world,), ("x",))
    circ, wit = toy(5)
    params = params_for(5)
    pk = keygen.from_numpy(cached_npz(circ), params, circ)
    return [prover.create_proof(params, pk, wit, {}, seed=seed, mesh=mesh,
                                mesh_axis="x") for seed in (42, None)]


@pytest.fixture(scope="module")
def toy_case(tmp_path_factory):
    got = ranks(_prove, WORLD, tmp_path_factory.mktemp("prove"),
                timeout=600)
    with open(os.path.join(GOLDEN, "toy_proof_v1.json")) as fh:
        want = bytes.fromhex(json.load(fh)["proof_hex"])
    circ, _ = toy(5)
    params = params_for(5)
    vk = keygen.from_numpy(cached_npz(circ), params, circ).vk
    return got, want, params, vk


def test_sharded_proof_equals_fixture_on_every_rank(toy_case):
    got, want, _, _ = toy_case
    assert [seeded for seeded, _ in got] == [want] * WORLD


def test_verifier_accepts_sharded_proof(toy_case):
    got, _, params, vk = toy_case
    assert verifier.verify_proof(params, vk, {}, got[0][0]) is True


def test_unseeded_ranks_agree_and_verify(toy_case):
    got, want, params, vk = toy_case
    fresh = [unseeded for _, unseeded in got]
    assert fresh == [fresh[0]] * WORLD
    assert fresh[0] != want and len(fresh[0]) == len(want)
    assert verifier.verify_proof(params, vk, {}, fresh[0]) is True


def test_ipa_under_a_mesh_raises():
    circ, wit = toy(5)
    params = ipa.setup(circ.k, device="cpu")
    mesh = object()          # refused before the mesh is read
    with pytest.raises(NotImplementedError, match="single-device"):
        prover.create_proof(params, None, wit, {}, seed=1, mesh=mesh)
    with pytest.raises(NotImplementedError, match="single-device"):
        api.setup_blake2f(k=5, scheme="ipa", device="cpu", mesh=mesh)
