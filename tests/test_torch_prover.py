"""The port's prover (plain path) through the grand-product commitments:
its lookup permutation indices, lookup phase, Z passes, instance
absorption and transcript against the JAX package's on the same inputs,
and the proof bytes through the Z commitments against every toy fixture
and a richer circuit's JAX bytes. The whole proofs are held in
``test_torch_proof_*.py``. Exact equality throughout."""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_keygen import FIXTURES, GOLDEN, cached_npz, params_for, toy
from zkodst_tpu.circuit import ir as jir
from zkodst_tpu.ops import field as jfield
from zkodst_tpu.proof import prover as jprover
from zkodst_tpu.proof import transcript as jtranscript
from zkodst_tpu_torch.circuit import ir as tir
from zkodst_tpu_torch.ops import field as tfield
from zkodst_tpu_torch.ops import pycurve
from zkodst_tpu_torch.proof import keygen, prover, transcript

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

JF, TF = jfield.FR, tfield.FR
N, U = 32, 32 - tir.BLINDING_ROWS - 1
rng = np.random.default_rng(97)


def _rand(shape):
    vals = [int.from_bytes(rng.bytes(40), "little") % TF.p
            for _ in range(int(np.prod(shape)))]
    return np.asarray(vals, dtype=object).reshape(shape)


def _both(vals):
    """The same field values as a JAX (…, 16) array and a port tensor."""
    j = JF.from_ints(vals)
    return jnp.asarray(j), tfield.from_limbs16(j)


def _same(got, want):
    np.testing.assert_array_equal(tfield.to_limbs16(got), np.asarray(want))


def _perm_case(name):
    r = np.random.default_rng(len(name))
    tb = np.zeros(N, np.uint32)
    if name == "ties":                     # the toy table: 0..15, then 0s
        tb[:16] = np.arange(16)
        inp = r.integers(0, 16, N).astype(np.uint32)
    elif name == "all_used":               # every table value looked up
        tb[:U] = r.permutation(U)
        inp = np.concatenate([tb[:U], tb[:N - U]])
        r.shuffle(inp)
    else:                                  # leftovers, values absent
        tb[:U] = r.permutation(np.arange(100, 100 + U))
        inp = r.choice(tb[:5], N).astype(np.uint32)
    return inp, tb


@pytest.mark.parametrize("case", ["ties", "all_used", "leftovers"])
def test_lookup_perm_indices_match_jax(case):
    inp, tb = _perm_case(case)
    want = jprover._lookup_perm_indices(inp, tb, U)
    got = prover._lookup_perm_indices(torch.from_numpy(inp.astype(np.int64)),
                                      torch.from_numpy(tb.astype(np.int64)),
                                      U)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _two_column_lookup():
    """The functional two-column table of tests/test_circuit_ir.py
    ("ok", [a, b] ⊆ [td, ts]), with a witness drawn from its rows."""
    def u64col(vals):
        out = np.zeros((N, 2), np.uint32)
        out[: len(vals)] = [[v, 0] for v in vals]
        return out

    td, ts = [0, 1, 1, 2, 9], [0, 5, 5, 7, 3]
    rows = rng.integers(0, len(td), U)
    fixed = {"td": u64col(td), "ts": u64col(ts)}
    adv = {"a": u64col([td[i] for i in rows]),
           "b": u64col([ts[i] for i in rows])}
    lk = ("ok", ["a", "b"], ["td", "ts"])
    jc = jir.CircuitDef(k=5, advice_names=["a", "b"], instance_names=[],
                        fixed=fixed, lookups=[jir.Lookup(*lk)])
    tc = tir.CircuitDef(k=5, advice_names=["a", "b"], instance_names=[],
                        fixed=fixed, lookups=[tir.Lookup(*lk)])
    jc.validate()
    return jc, tc, {**fixed, **adv}


def test_lookup_phase_matches_jax():
    jc, tc, cols = _two_column_lookup()
    jcols = {c: jir.u64_cols_to_field(JF, jnp.asarray(v))
             for c, v in cols.items()}
    tcols = {c: tir.u64_cols_to_field(TF, torch.from_numpy(v.astype(
        np.int64))) for c, v in cols.items()}
    perms = {"ok": prover._lookup_perm_indices(
        torch.from_numpy(cols["a"][:, 0].astype(np.int64)),
        torch.from_numpy(cols["td"][:, 0].astype(np.int64)), U)}
    theta = int(_rand(()))
    jb, tb = _both(_rand((2, tir.BLINDING_ROWS)))
    want = jprover._build_lookup_phase(jc)(
        jcols, jnp.asarray(JF.from_int(theta)),
        jnp.asarray(np.stack([np.stack([p.numpy() for p in perms["ok"]])])
                    .astype(np.int32)), jb)
    got = prover.lookup_columns(tc, tcols, theta, perms, tb)
    for g, w in zip(got, want):
        _same(g, w)


def test_perm_z_pass_matches_jax():
    m = 2
    (jc, tc), (js, ts), (ji, ti) = (_both(_rand((m, N))) for _ in range(3))
    (jb, tb), (jg, tg), (jk, tk) = (_both(_rand(())) for _ in range(3))
    z, zlast = jprover._perm_z_pass(jc, js, ji, jb, jg, jk,
                                    jnp.arange(N) < U)
    got, carry = prover.perm_z_pass(tc, ts, ti, tb, tg, tk, U)
    _same(got, z)
    _same(carry, zlast)


def test_lookup_z_pass_matches_jax():
    (ja, ta), (js, ts), (jap, tap), (jsp, tsp) = (_both(_rand(N))
                                                  for _ in range(4))
    (jb, tb), (jg, tg) = (_both(_rand(())) for _ in range(2))
    want = jprover._lookup_z_pass(ja, js, jap, jsp, jb, jg,
                                  jnp.arange(N) < U)
    _same(prover.lookup_z_pass(ta, ts, tap, tsp, tb, tg, U), want)


@pytest.mark.parametrize("with_instance", [False, True],
                         ids=["none", "pub"])
def test_absorb_instances_matches_jax(with_instance):
    names = ["pub"] if with_instance else []
    inst = {"pub": rng.integers(0, 1 << 32, (N, 2), dtype=np.uint64)
            .astype(np.uint32)}
    jc = jir.CircuitDef(k=5, advice_names=[], instance_names=names, fixed={})
    tc = tir.CircuitDef(k=5, advice_names=[], instance_names=names, fixed={})
    jt, tt = jtranscript.Blake2bWrite(), transcript.Blake2bWrite()
    jprover.absorb_instances(jt, jc, inst)
    prover.absorb_instances(tt, tc, {"pub": torch.from_numpy(
        inst["pub"].astype(np.int64))})
    want = jt.squeeze_challenge()
    assert tt.squeeze_challenge() == want
    if not with_instance:                  # the digest of the empty input
        tt = transcript.Blake2bWrite()
        tt.common_scalar(int.from_bytes(hashlib.blake2b(
            digest_size=64).digest(), "little"))
        assert tt.squeeze_challenge() == want


def test_transcript_matches_jax():
    jt, tt = jtranscript.Blake2bWrite(), transcript.Blake2bWrite()
    pt = pycurve.G1.mul(pycurve.G1_GEN, 12345)
    for t in (jt, tt):
        t.common_scalar(17)
        t.write_point(pt)
        t.write_point(None)
        t.write_scalar(TF.p + 5)
    assert tt.squeeze_challenge() == jt.squeeze_challenge()
    assert tt.squeeze_challenge() == jt.squeeze_challenge()
    assert tt.finalize() == jt.finalize()


def _through_grand_products(params, pk, advice, instance, seed) -> bytes:
    """The proof's bytes up to the challenge y (the first three phases of
    create_proof)."""
    pr = prover.Prover(params, pk, advice, instance, seed)
    pr.advice()
    pr.lookups()
    pr.grand_products()
    return pr.tw.finalize()


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_proof_through_grand_products_equals_fixture(fixture):
    """The slice as a whole: 2 advice, A′ and S′ of one lookup and one
    permutation chunk's and one lookup's Z — 6 points, 192 bytes — equal
    the fixture's proof prefix. The key is the reference's cached key
    (tests/test_torch_keygen.py holds it equal to the port's keygen)."""
    with open(os.path.join(GOLDEN, f"{fixture}.json")) as fh:
        g = json.load(fh)
    k = FIXTURES[fixture]
    circ, wit = toy(k)
    params = params_for(k)
    pk = keygen.from_numpy(cached_npz(circ), params, circ)
    proof = _through_grand_products(params, pk, wit, {}, g["blind_seed"])
    assert len(proof) == 192
    assert proof.hex() == g["proof_hex"][:384]


# A toy circuit with the flagship's structure that the toy fixtures lack:
# an instance column copied into advice, a `cst` column, six permutation
# columns (three chunks, each chunk's last product carried into the next)
# and a second lookup over two columns.
RICH_SEEDS = (3, 7)                     # SRS seed, blind seed
# the JAX package's create_proof on this circuit and these seeds (the
# `heavy` test below recomputes them): its first 13 points (4 advice,
# 4 A′/S′, 3 + 2 Z) and its whole 1792 bytes, for the witness that breaks
# a copy and for the one that satisfies the circuit
RICH_SHA256 = "8c3987a9ca2586ffedf1d9006bfe6aa6a821682a62a62e6cc56ecf755647d555"
RICH_UNSAT_SHA256 = \
    "cd58429dd941ebf5a50426712f2750db1ea3cf2137db78861b8f5e0f64d2b6c4"
RICH_PROOF_SHA256 = \
    "5672400aa262b44fe778989618d340c739f6a6c33a265f98dbc595881c0853e2"
RICH_VK = "0x7ef7a34ad04072fef9deef929d9d9f26061530e2e9adec66477a17e380de8de"


def _rich(ir, expr, satisfied: bool = False):
    """(circuit, advice, instance) in the IR of either package. The
    witness breaks the copy b[1] = b[2] unless `satisfied` (a[2] = a[1]);
    the circuit is the same either way."""
    from zkodst_tpu_torch.ops import u64

    def col(vals):
        out = np.zeros((N, 2), np.uint32)
        out[: len(vals)] = u64.from_ints(list(vals))
        return out

    r = np.random.default_rng(5)
    a = [int(x) for x in r.integers(0, 16, 20)]
    td, ts = [0, 1, 2, 3, 7, 9], [0, 6, 7, 1 << 40, 2, 3]
    rows = r.integers(0, len(td), 20)
    if satisfied:
        a[2] = a[1]
    c, d = [td[i] for i in rows], [ts[i] for i in rows]
    sel = np.zeros((N, 2), np.uint32)
    sel[:8, 0] = 1
    V = expr.V
    circ = ir.CircuitDef(
        k=5, advice_names=["a", "b", "c", "d"], instance_names=["pub"],
        fixed={"q": sel, "t": col(range(16)), "td": col(td),
               "ts": col(ts), "cst": col([c[4]])},
        gates=[ir.Gate("square", V("q") * (V("a") * V("a") - V("b")))],
        lookups=[ir.Lookup("a_range", ["a"], ["t"]),
                 ir.Lookup("pair", ["c", "d"], ["td", "ts"])],
        copies=[ir.CopyGroup("b", np.array([1]), "b", np.array([2])),
                ir.CopyGroup("a", np.array([3]), "pub", np.array([0])),
                ir.CopyGroup("c", np.array([4]), "cst", np.array([0]))],
        instance_len={"pub": 2})
    circ.validate()
    adv = {"a": col(a), "b": col([x * x for x in a]), "c": col(c),
           "d": col(d)}
    return circ, adv, {"pub": col([a[3], 77])}


def test_rich_circuit_proof_equals_jax_bytes():
    from zkodst_tpu_torch.circuit import expr as texpr
    from zkodst_tpu_torch.proof import srs

    circ, adv, inst = _rich(tir, texpr)
    params = srs.setup(5, seed=RICH_SEEDS[0], device="cpu")
    pk = keygen.keygen(params, circ)
    tw = transcript.Blake2bWrite()
    pk.vk.hash_into(tw)
    assert hex(tw.squeeze_challenge()) == RICH_VK
    proof = _through_grand_products(
        params, pk, {c: torch.from_numpy(v.astype(np.int64))
                     for c, v in adv.items()}, inst, RICH_SEEDS[1])
    assert len(proof) == 32 * (4 + 4 + 3 + 2)
    assert hashlib.sha256(proof).hexdigest() == RICH_SHA256


@pytest.mark.heavy
def test_rich_circuit_pins_are_jax_bytes():
    """The pins above are the JAX package's own, and the JAX verifier
    accepts the port's whole proof of the satisfied witness and rejects
    the other (its full prove compiles for minutes on the CPU, hence
    tier 2)."""
    from zkodst_tpu.circuit import expr as jexpr
    from zkodst_tpu.proof import keygen as jkeygen
    from zkodst_tpu.proof import srs as jsrs
    from zkodst_tpu.proof import verifier as jverifier
    from zkodst_tpu_torch.circuit import expr as texpr
    from zkodst_tpu_torch.proof import srs

    circ, adv, inst = _rich(jir, jexpr)
    params = jsrs.setup(5, seed=RICH_SEEDS[0])
    pk = jkeygen.keygen(params, circ)
    tw = jtranscript.Blake2bWrite()
    pk.vk.hash_into(tw)
    assert hex(tw.squeeze_challenge()) == RICH_VK
    proof = jprover.create_proof(params, pk, adv, inst, seed=RICH_SEEDS[1])
    assert hashlib.sha256(proof[:32 * 13]).hexdigest() == RICH_SHA256
    assert hashlib.sha256(proof).hexdigest() == RICH_UNSAT_SHA256
    assert jverifier.verify_proof(params, pk.vk, inst, proof) is False
    _, adv_ok, _ = _rich(jir, jexpr, satisfied=True)
    proof = jprover.create_proof(params, pk, adv_ok, inst,
                                 seed=RICH_SEEDS[1])
    assert hashlib.sha256(proof).hexdigest() == RICH_PROOF_SHA256

    tcirc, tadv, _ = _rich(tir, texpr, satisfied=True)
    tparams = srs.setup(5, seed=RICH_SEEDS[0], device="cpu")
    ported = prover.create_proof(
        tparams, keygen.keygen(tparams, tcirc),
        {c: torch.from_numpy(v.astype(np.int64)) for c, v in tadv.items()},
        inst, seed=RICH_SEEDS[1])
    assert jverifier.verify_proof(params, pk.vk, inst, ported) is True
