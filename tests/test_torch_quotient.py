"""The pieces of the port's quotient, evaluations and multiopen (plain
path) against the JAX package on the same inputs: kernel 3's twin, the
coset transforms, the extended-coset selector tables, the constraint
enumeration and its y-fold, the query schedule, the evaluations, SHPLONK's
host interpolation and the transcript's read side. Exact equality
throughout: every value is canonical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_circuit_ir as jtoy
from test_torch_keygen import cached_npz, toy
from test_torch_prover import _rich
from zkodst_tpu.circuit import expr as jexpr
from zkodst_tpu.circuit import ir as jir
from zkodst_tpu.ops import field as jfield
from zkodst_tpu.ops import ntt as jntt
from zkodst_tpu.proof import constraints as jconstraints
from zkodst_tpu.proof import domain as jdomain
from zkodst_tpu.proof import keygen as jkeygen
from zkodst_tpu.proof import prover as jprover
from zkodst_tpu.proof import shplonk as jshplonk
from zkodst_tpu.proof import transcript as jtranscript
from zkodst_tpu.proof import verifier as jverifier
from zkodst_tpu_torch.circuit import expr as texpr
from zkodst_tpu_torch.circuit import ir as tir
from zkodst_tpu_torch.kernels import mulmod
from zkodst_tpu_torch.ops import field as tfield
from zkodst_tpu_torch.ops import ntt as tntt
from zkodst_tpu_torch.ops import pycurve
from zkodst_tpu_torch.ops.pyfield import FR as PFR
from zkodst_tpu_torch.proof import constraints, keygen, prover, shplonk
from zkodst_tpu_torch.proof import transcript, verifier
from zkodst_tpu_torch.proof.domain import Domain

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

JF, TF = jfield.FR, tfield.FR
rng = np.random.default_rng(101)


def _rand() -> int:
    return int.from_bytes(rng.bytes(40), "little") % PFR.p


def _vals(shape):
    """Random field values with 0, 1 and p − 1 first."""
    vals = [0, 1, PFR.p - 1] + [_rand() for _ in range(
        int(np.prod(shape)) - 3)]
    return np.asarray(vals, dtype=object).reshape(shape)


def _same(got, want):
    np.testing.assert_array_equal(tfield.to_limbs16(got), np.asarray(want))


def test_submod_plain_matches_ints_and_jax():
    a, b = _vals((8, 8)), _vals((8, 8))[::-1]
    ja, jb = JF.from_ints(a), JF.from_ints(b)
    got = mulmod.submod_plain(TF, tfield.from_limbs16(ja),
                              tfield.from_limbs16(jb))
    _same(got, jax.jit(JF.sub)(ja, jb))
    np.testing.assert_array_equal(TF.to_ints(got), (a - b) % PFR.p)
    one = TF.const(TF.ONE)                  # a broadcast first operand
    np.testing.assert_array_equal(
        TF.to_ints(mulmod.submod_plain(TF, one, tfield.from_limbs16(jb))),
        (1 - b) % PFR.p)


@pytest.mark.parametrize("n", [64, 256])
def test_coset_transforms_match_jax(n):
    a = JF.from_ints(_vals((2, n)))
    w = PFR.root_of_unity(n.bit_length() - 1)
    g = jdomain.GEN
    got = tntt.coset_ntt(TF, tfield.from_limbs16(a), w, g)
    _same(got, jntt.coset_ntt(JF, jnp.asarray(a), w, g))
    back = tntt.coset_intt(TF, got, w, g)
    _same(back, jntt.coset_intt(JF, jnp.asarray(tfield.to_limbs16(got)), w,
                                g))
    assert torch.equal(back, tfield.from_limbs16(a))


def test_extended_domain_matches_jax():
    dom, jdom = Domain(5), jdomain.Domain(5)
    assert (dom.ext_k, dom.ext_n, dom.ext_omega, dom.zeta) == \
        (jdom.ext_k, jdom.ext_n, jdom.ext_omega, jdom.zeta)
    c = JF.from_ints(_vals((3, dom.n)))
    ext = dom.coeff_to_extended(tfield.from_limbs16(c))
    _same(ext, jdom.coeff_to_extended(jnp.asarray(c)))
    back = dom.extended_to_coeff(ext)
    assert torch.equal(back[:, :dom.n], tfield.from_limbs16(c))
    assert not back[:, dom.n:].any()
    x = _rand()
    assert dom.vanishing_eval(x) == jdom.vanishing_eval(x)
    assert dom.lagrange_eval(3, x) == jdom.lagrange_eval(3, x)
    assert dom.l0_llast_lblind_eval(x) == jdom.l0_llast_lblind_eval(x)


@pytest.mark.parametrize("k", [5, 6])
def test_selectors_extended_match_jax_and_cached_keys(k):
    got = Domain(k).selectors_extended(device="cpu")
    want = jdomain.Domain(k).selectors_extended()
    npz = cached_npz(toy(k)[0])
    assert sorted(got) == sorted(want)
    for name in want:
        _same(got[name], want[name])
        _same(got[name], npz[f"sel_{name}"])


def _circuits():
    return {"toy": (toy(5)[0], jtoy.toy_circuit()),
            "rich": (_rich(tir, texpr)[0], _rich(jir, jexpr)[0])}


def _vks(name):
    tc, jc = _circuits()[name]
    perm = keygen.perm_columns(tc)
    return (keygen.VerifyingKey(tc.k, {}, [], perm, tc),
            jkeygen.VerifyingKey(jc.k, {}, [], perm, jc))


@pytest.mark.parametrize("circuit", ["toy", "rich"])
def test_constraints_match_jax(circuit):
    """One host-int context for both enumerations, at random challenges
    and column values: the same terms in the same order, the same fold."""
    tvk, jvk = _vks(circuit)
    rec = prover._RecCtx()
    constraints.enumerate_constraints(tvk, rec)
    u = tvk.circ.usable_rows
    ev = {(name, r): _rand() for name in rec.names
          for r in (-1, 0, 1, u)}
    x, l0, llast, lblind = (_rand() for _ in range(4))
    chal = dict(zip(("theta", "beta", "gamma", "y"),
                    (_rand() for _ in range(4))))
    tctx = verifier._PointCtx(ev, x, chal, l0, llast, lblind)
    jctx = jverifier._PointCtx(ev, x, chal, l0, llast, lblind)
    terms = constraints.enumerate_constraints(tvk, tctx)
    assert terms == jconstraints.enumerate_constraints(jvk, jctx)
    assert constraints.fold_y(tctx, terms) == \
        jconstraints.fold_y(jctx, terms)
    jrec = jprover._RecCtx()
    jconstraints.enumerate_constraints(jvk, jrec)
    assert rec.names == jrec.names


@pytest.mark.parametrize("circuit", ["toy", "rich"])
def test_query_schedule_matches_jax(circuit):
    tvk, jvk = _vks(circuit)
    assert prover.query_schedule(tvk) == jprover.query_schedule(jvk)
    dom, x = Domain(tvk.k), _rand()
    for r in (-1, 0, 1, tvk.circ.usable_rows):
        assert prover.rotation_point(dom, x, r) == \
            jprover.rotation_point(jdomain.Domain(tvk.k), x, r)


def test_eval_many_matches_host_horner():
    coeffs = _vals((3, 16))
    points = [_rand(), _rand()]
    got = prover.eval_many(list(TF.from_ints(coeffs)), points)
    for i in range(3):
        for j, x in enumerate(points):
            assert got[i][j] == shplonk._poly_eval(list(coeffs[i]), x)


@pytest.mark.parametrize("dim", [0, 1])
def test_field_sum_along_any_dim(dim):
    vals = _vals((7, 5))                       # odd lengths carry a row
    got = TF.to_ints(TF.sum(TF.from_ints(vals), dim=dim))
    np.testing.assert_array_equal(got, vals.sum(axis=dim) % PFR.p)


def test_shplonk_host_interpolation_matches_jax():
    pts = [_rand() for _ in range(3)]
    evs = [_rand() for _ in range(3)]
    assert shplonk._interp(pts, evs) == jshplonk._interp(pts, evs)
    r = shplonk._interp(pts, evs)
    x = _rand()
    assert shplonk._poly_eval(r, x) == jshplonk._poly_eval(r, x)
    assert [shplonk._poly_eval(r, p) for p in pts] == evs


def test_transcript_read_replays_write():
    pt = pycurve.G1.mul(pycurve.G1_GEN, 54321)
    tw = transcript.Blake2bWrite()
    jw = jtranscript.Blake2bWrite()
    for t in (tw, jw):
        t.common_scalar(3)
        t.write_point(pt)
        t.write_point(None)
        t.write_scalar(PFR.p - 2)
    want = tw.squeeze_challenge()
    assert want == jw.squeeze_challenge()
    proof = tw.finalize()
    for data in (proof[:32], proof[32:64]):
        assert transcript.decompress_g1(data) == \
            jtranscript.decompress_g1(data)
    tr = transcript.Blake2bRead(proof)
    tr.common_scalar(3)
    assert tr.read_point() == pt
    assert tr.read_point() is None
    assert tr.read_scalar() == PFR.p - 2
    assert tr.done() and tr.squeeze_challenge() == want
    bad = transcript.Blake2bRead(bytes(32) + (PFR.p).to_bytes(32, "little"))
    assert bad.read_point() is None
    with pytest.raises(ValueError, match="scalar out of range"):
        bad.read_scalar()
    with pytest.raises(ValueError, match="proof too short"):
        bad.read_scalar()
    off_curve = (4).to_bytes(32, "little")    # 4³ + 3 is no square
    with pytest.raises(ValueError, match="not on the curve"):
        transcript.decompress_g1(off_curve)
    with pytest.raises(AssertionError):
        jtranscript.decompress_g1(off_curve)
    high = bytearray(proof[:32])
    high[31] |= 0x40                          # bit 254: never written
    with pytest.raises(ValueError, match="bit 254"):
        transcript.decompress_g1(bytes(high))
