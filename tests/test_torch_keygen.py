"""The port's keygen (plain path) against the JAX package's on the toy
circuit, the verifying-key transcript digest against every toy fixture,
and the loader of the reference's cached proving keys against the port's
own keygen. Exact equality: σ maps, canonical field columns, affine
commitments."""

import functools
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_circuit_ir as jtoy
from zkodst_tpu.circuit.ir import CopyGroup as JCopyGroup
from zkodst_tpu.proof import keygen as jkeygen
from zkodst_tpu.proof import srs as jsrs
from zkodst_tpu_torch.circuit.expr import V
from zkodst_tpu_torch.circuit.ir import CircuitDef, CopyGroup, Gate, Lookup
from zkodst_tpu_torch.ops import u64
from zkodst_tpu_torch.ops.field import to_limbs16
from zkodst_tpu_torch.proof import keygen, srs
from zkodst_tpu_torch.proof.transcript import Blake2bWrite

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CACHE = os.path.join(GOLDEN, "dryrun_cache")
FIXTURES = {"toy_proof_v1": 5, "dryrun_proof_k5_v1": 5,
            "dryrun_proof_k6_v1": 6}


def toy(k: int):
    """The toy circuit of tests/test_circuit_ir.py at degree k, built with
    the port's IR (the reference's ``__graft_entry__._toy_circuit_k``):
    q·(a² − b) = 0, a ∈ {0..15}, b[2] copied from b[1]. Returns (circuit,
    witness of (n, 2) int64 tensors)."""
    n = 1 << k

    def u64col(vals):
        out = np.zeros((n, 2), np.uint32)
        out[: len(vals)] = u64.from_ints(list(vals))
        return out

    sel = np.zeros((n, 2), np.uint32)
    sel[:8, 0] = 1
    circ = CircuitDef(
        k=k, advice_names=["a", "b"], instance_names=[],
        fixed={"q": sel, "t": u64col(range(16))},
        gates=[Gate("square", V("q") * (V("a") * V("a") - V("b")))],
        lookups=[Lookup("a_range", ["a"], ["t"])],
        copies=[CopyGroup("b", np.array([1]), "b", np.array([2]))])
    circ.validate()
    a_vals = [(i * 7) % 16 for i in range(8)]
    a_vals[2] = a_vals[1]
    wit = {"a": u64col(a_vals), "b": u64col([v * v for v in a_vals])}
    return circ, {c: torch.from_numpy(v.astype(np.int64))
                  for c, v in wit.items()}


def params_for(k: int):
    """The toy fixtures' SRS (seed 2), as the reference saved it."""
    return srs.load(os.path.join(CACHE, f"srs_bn254_k{k}_s2.npz"),
                    device="cpu")


def cached_npz(circ):
    return np.load(os.path.join(
        CACHE, f"pk_{keygen.circuit_fingerprint(circ)}.npz"))


@functools.lru_cache(maxsize=None)
def port_key(k: int):
    """The port's own keygen of the toy circuit (made once per k)."""
    return keygen.keygen(params_for(k), toy(k)[0])


def vk_digest(vk) -> str:
    tw = Blake2bWrite()
    vk.hash_into(tw)
    return hex(tw.squeeze_challenge())


def _same_cols(got, want):
    np.testing.assert_array_equal(to_limbs16(got), np.asarray(want))


def test_fingerprint_matches_jax():
    circ, _ = toy(5)
    assert keygen.circuit_fingerprint(circ) == \
        jkeygen._circuit_fingerprint(jtoy.toy_circuit())


def test_keygen_matches_jax(tmp_path):
    """Against the reference's keygen on the same SRS; its commitments and
    σ maps come from its cached key (copied, so nothing is written to the
    repository), its columns are recomputed by its own NTT."""
    cache = tmp_path / "cache"
    shutil.copytree(CACHE, cache)
    jpk = jkeygen.keygen(jsrs.load(os.path.join(CACHE, "srs_bn254_k5_s2.npz")),
                         jtoy.toy_circuit(), cache_dir=str(cache))
    pk = port_key(5)
    assert pk.vk.perm_cols == jpk.vk.perm_cols
    assert pk.vk.perm_chunks == jpk.vk.perm_chunks
    for (c, r), (jc, jr) in zip(pk.sigma_maps, jpk.sigma_maps):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(r, jr)
    assert len(pk.sigma_maps) == len(jpk.sigma_maps)
    _same_cols(pk.roots, jpk.roots)
    for name in jpk.fixed_evals:
        _same_cols(pk.fixed_evals[name], jpk.fixed_evals[name])
        _same_cols(pk.fixed_coeffs[name], jpk.fixed_coeffs[name])
    _same_cols(torch.stack(pk.sigma_evals), jnp.stack(jpk.sigma_evals))
    _same_cols(torch.stack(pk.sigma_coeffs), jnp.stack(jpk.sigma_coeffs))
    assert pk.vk.fixed_commitments == jpk.vk.fixed_commitments
    assert pk.vk.sigma_commitments == jpk.vk.sigma_commitments
    assert vk_digest(pk.vk) == vk_digest(jpk.vk)


def test_build_sigma_matches_jax():
    """σ maps by the copied union-find equal the reference's on a circuit
    with a cycle over two columns."""
    circ, _ = toy(5)
    circ.copies.append(CopyGroup("a", np.array([3, 4]), "b",
                                 np.array([4, 5])))
    jcirc = jtoy.toy_circuit()
    jcirc.copies.append(JCopyGroup("a", np.array([3, 4]), "b",
                                   np.array([4, 5])))
    perm = keygen.perm_columns(circ)
    got = keygen._build_sigma(circ, perm)
    want = jkeygen._build_sigma(jcirc, perm)
    for (c, r), (jc, jr) in zip(got, want):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(r, jr)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_vk_digest_equals_fixture(fixture):
    with open(os.path.join(GOLDEN, f"{fixture}.json")) as fh:
        want = json.load(fh)["vk_transcript_digest"]
    assert vk_digest(port_key(FIXTURES[fixture]).vk) == want


@pytest.mark.parametrize("k", [5, 6])
def test_from_numpy_equals_keygen(k):
    circ, _ = toy(k)
    pk = keygen.from_numpy(cached_npz(circ), params_for(k), circ)
    own = port_key(k)
    assert pk.vk.fixed_commitments == own.vk.fixed_commitments
    assert pk.vk.sigma_commitments == own.vk.sigma_commitments
    assert pk.vk.perm_cols == own.vk.perm_cols
    for (c, r), (oc, orow) in zip(pk.sigma_maps, own.sigma_maps):
        np.testing.assert_array_equal(c, oc)
        np.testing.assert_array_equal(r, orow)
    for name in own.fixed_evals:
        assert torch.equal(pk.fixed_evals[name], own.fixed_evals[name])
        assert torch.equal(pk.fixed_coeffs[name], own.fixed_coeffs[name])
    assert torch.equal(torch.stack(pk.sigma_evals),
                       torch.stack(own.sigma_evals))
    assert torch.equal(torch.stack(pk.sigma_coeffs),
                       torch.stack(own.sigma_coeffs))
    assert torch.equal(pk.roots, own.roots)
