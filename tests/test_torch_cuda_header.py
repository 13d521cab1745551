"""The CUDA kernels' shared arithmetic header (cuda/csrc/field.cuh), built
for the host with g++, against the plain twins and Python ints. The header
is __host__ __device__, so this checks the Montgomery multiply, add, sub
(on BN254's two fields and the two Pasta fields, whose moduli are above
2^254) and the complete EC addition and doubling (on BN254 and pallas)
that every kernel runs, without
a card (the host build takes the header's portable arithmetic; the card
takes its PTX carry chains, held to the same twins by
test_torch_kernels_cuda.py)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkodst_tpu_torch.ops import curve, pycurve
from zkodst_tpu_torch.ops.field import FQ, FR, PASTA_FP, PASTA_FR, \
    ints_to_limbs

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zkodst_tpu_torch", "cuda", "csrc")

SHIM = r"""
#include "field.cuh"
template <class M>
void fe_op_in(int op, const uint32_t* x, const uint32_t* y, uint32_t* r) {
  if (op == 0) zk::mont_mul<M>(x, y, r);
  else if (op == 1) zk::add_mod<M>(x, y, r);
  else zk::sub_mod<M>(x, y, r);
}
extern "C" {
// field: 0 Fr, 1 Fq, 2 PallasFp, 3 PallasFr (the kernels' field ids)
void fe_op(int field, int op, const uint32_t* a, const uint32_t* b,
           uint32_t* o, long long n) {
  for (long long i = 0; i < n; ++i) {
    const uint32_t *x = a + 8 * i, *y = b + 8 * i;
    uint32_t* r = o + 8 * i;
    if (field == 0) fe_op_in<zk::Fr>(op, x, y, r);
    else if (field == 1) fe_op_in<zk::Fq>(op, x, y, r);
    else if (field == 2) fe_op_in<zk::PallasFp>(op, x, y, r);
    else fe_op_in<zk::PallasFr>(op, x, y, r);
  }
}
void pt_add_pallas(const uint32_t* p, const uint32_t* q, uint32_t* o,
                   long long n) {
  for (long long i = 0; i < n; ++i) {
    zk::Pt x, y, s;
    zk::load_pt(p + 24 * i, 1, 0, x);
    zk::load_pt(q + 24 * i, 1, 0, y);
    zk::ec_add<zk::Pallas>(x, y, s);
    zk::store_pt(o + 24 * i, 1, 0, s);
  }
}
void pt_dbl_pallas(const uint32_t* p, uint32_t* o, long long n) {
  for (long long i = 0; i < n; ++i) {
    zk::Pt x, s;
    zk::load_pt(p + 24 * i, 1, 0, x);
    zk::ec_dbl<zk::Pallas>(x, s);
    zk::store_pt(o + 24 * i, 1, 0, s);
  }
}
void identity_pallas(uint32_t* o) {
  zk::Pt p;
  zk::set_identity<zk::Pallas>(p);
  zk::store_pt(o, 1, 0, p);
}
// points as (n, 3, 8) words
void pt_add(const uint32_t* p, const uint32_t* q, uint32_t* o, long long n) {
  for (long long i = 0; i < n; ++i) {
    zk::Pt x, y, s;
    zk::load_pt(p + 24 * i, 1, 0, x);
    zk::load_pt(q + 24 * i, 1, 0, y);
    zk::ec_add(x, y, s);
    zk::store_pt(o + 24 * i, 1, 0, s);
  }
}
void pt_dbl(const uint32_t* p, uint32_t* o, long long n) {
  for (long long i = 0; i < n; ++i) {
    zk::Pt x, s;
    zk::load_pt(p + 24 * i, 1, 0, x);
    zk::ec_dbl(x, s);
    zk::store_pt(o + 24 * i, 1, 0, s);
  }
}
void identity(uint32_t* o) {
  zk::Pt p;
  zk::set_identity(p);
  zk::store_pt(o, 1, 0, p);
}
// in place on (n, 8) words: (u, v) <- (u + w·v, u − w·v)
void bfly(int field, uint32_t* u, uint32_t* v, const uint32_t* w,
          long long n) {
  for (long long i = 0; i < n; ++i) {
    if (field == 0) zk::butterfly<zk::Fr>(u + 8 * i, v + 8 * i, w + 8 * i);
    else zk::butterfly<zk::Fq>(u + 8 * i, v + 8 * i, w + 8 * i);
  }
}
void one(int field, uint32_t* o) {
  if (field == 0) zk::Fr::one(o);
  else if (field == 1) zk::Fq::one(o);
  else if (field == 2) zk::PallasFp::one(o);
  else zk::PallasFr::one(o);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the header")
    d = tmp_path_factory.mktemp("hdr")
    src, so = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.fe_op.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P,
                          ctypes.c_longlong]
    lib.pt_add.argtypes = [P, P, P, ctypes.c_longlong]
    lib.pt_add_pallas.argtypes = [P, P, P, ctypes.c_longlong]
    lib.identity_pallas.argtypes = [P]
    lib.pt_dbl_pallas.argtypes = [P, P, ctypes.c_longlong]
    lib.pt_dbl.argtypes = [P, P, ctypes.c_longlong]
    lib.identity.argtypes = [P]
    lib.bfly.argtypes = [ctypes.c_int, P, P, P, ctypes.c_longlong]
    lib.one.argtypes = [ctypes.c_int, P]
    return lib


def _run(fn, *arrays, out_shape):
    arrs = [np.ascontiguousarray(a, dtype=np.uint32) for a in arrays]
    out = np.zeros(out_shape, np.uint32)
    fn(*[a.ctypes.data for a in arrs], out.ctypes.data)
    return out


rng = np.random.default_rng(61)


FIELDS = [FR, FQ, PASTA_FP, PASTA_FR]
FIELD_IDS = ["fr", "fq", "pasta_fp", "pasta_fr"]


@pytest.mark.parametrize("op", [0, 1, 2], ids=["mul", "add", "sub"])
@pytest.mark.parametrize("F", FIELDS, ids=FIELD_IDS)
def test_field_ops(lib, F, op):
    """Every pair of 200 random values and the edges 0, 1, p − 1, p − 2,
    2^255 mod p and R = 2^256 mod p (the Pasta moduli are above 2^254, so
    there the sums of canonical values reach past 2^255)."""
    a = [int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(200)]
    b = [int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(200)]
    edges = [0, 1, F.p - 1, F.p - 2, (1 << 255) % F.p, F.r]
    a = a + edges * len(edges)
    b = b + [e for e in edges for _ in range(len(edges))]
    A, B = F.from_ints(a), F.from_ints(b)
    n = len(a)
    got = _run(lambda x, y, o: lib.fe_op(F.kernel_id, op, x, y, o, n),
               A.numpy().view(np.uint32), B.numpy().view(np.uint32),
               out_shape=(n, 8))
    plain = {0: F.mul, 1: F.add, 2: F.sub}[op](A, B)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))
    want = [{0: x * y, 1: x + y, 2: x - y}[op] % F.p for x, y in zip(a, b)]
    assert [int(v) for v in F.to_ints(torch.from_numpy(
        got.view(np.int32)))] == want


def test_ec_add_and_identity(lib):
    G, GEN = pycurve.G1, pycurve.G1_GEN
    ks = [int(k) for k in rng.integers(1, 1 << 40, 64)]
    a = [G.mul(GEN, k) for k in ks] + [None, GEN, GEN]
    b = [G.mul(GEN, k + 7) for k in ks] + [GEN, None, GEN]
    P, Q = curve.from_affine_ints(a), curve.from_affine_ints(b)
    n = len(a)
    got = _run(lambda x, y, o: lib.pt_add(x, y, o, n),
               P.numpy().view(np.uint32), Q.numpy().view(np.uint32),
               out_shape=(n, 3, 8))
    plain = curve.add(P, Q).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, plain)
    ident = np.zeros((3, 8), np.uint32)
    lib.identity(ident.ctypes.data)
    np.testing.assert_array_equal(ident, curve.identity().numpy()
                                  .view(np.uint32))
    assert curve.to_affine_ints(torch.from_numpy(got.view(np.int32))) \
        == [G.add(x, y) for x, y in zip(a, b)]
    assert ints_to_limbs(FQ.r).tolist() == ident[1].tolist()


def test_pallas_ec_add_and_identity(lib):
    """The complete addition on pallas (b3 = 15) against its plain twin
    limb for limb and the host oracle PASTA_G1: random points, the
    identity on either side, P + P and P + (−P)."""
    G, GEN = pycurve.PASTA_G1, pycurve.PASTA_G1_GEN
    ks = [int(k) for k in rng.integers(1, 1 << 40, 48)]
    a = [G.mul(GEN, k) for k in ks] + [None, GEN, GEN, GEN]
    b = [G.mul(GEN, k + 3) for k in ks] + [GEN, None, GEN, G.neg(GEN)]
    C = curve.PASTA
    proj = C.add(C.from_affine_ints(a), C.from_affine_ints([GEN] * len(a)))
    P, Q = proj, C.from_affine_ints(b)        # P with Z ≠ 1
    n = len(a)
    got = _run(lambda x, y, o: lib.pt_add_pallas(x, y, o, n),
               P.numpy().view(np.uint32), Q.numpy().view(np.uint32),
               out_shape=(n, 3, 8))
    np.testing.assert_array_equal(got, C.add(P, Q).numpy().view(np.uint32))
    assert C.to_affine_ints(torch.from_numpy(got.view(np.int32))) == \
        [G.add(G.add(x, GEN), y) for x, y in zip(a, b)]
    ident = np.zeros((3, 8), np.uint32)
    lib.identity_pallas(ident.ctypes.data)
    np.testing.assert_array_equal(ident, C.identity().numpy().view(np.uint32))


@pytest.mark.parametrize("F", [PASTA_FP, PASTA_FR],
                         ids=["pasta_fp", "pasta_fr"])
def test_pasta_one(lib, F):
    """The header's Montgomery 1 of the Pasta fields (their one() is the
    identity's Y on pallas and the kernels' raw input of R)."""
    one = np.zeros(8, np.uint32)
    lib.one(F.kernel_id, one.ctypes.data)
    np.testing.assert_array_equal(one, F.ONE)


@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_butterfly_and_one(lib, F):
    """The NTT kernels' butterfly and the kernels' Montgomery 1."""
    vals = [[int.from_bytes(rng.bytes(40), "little") % F.p
             for _ in range(64)] + [0, 1, F.p - 1] for _ in range(3)]
    U, V, Wt = (F.from_ints(v) for v in vals)
    u, v, w = (X.numpy().view(np.uint32).copy() for X in (U, V, Wt))
    lib.bfly(F.kernel_id, u.ctypes.data, v.ctypes.data, w.ctypes.data,
             u.shape[0])
    t = F.mul(V, Wt)
    np.testing.assert_array_equal(u, F.add(U, t).numpy().view(np.uint32))
    np.testing.assert_array_equal(v, F.sub(U, t).numpy().view(np.uint32))
    one = np.zeros(8, np.uint32)
    lib.one(F.kernel_id, one.ctypes.data)
    np.testing.assert_array_equal(one, F.ONE)


@pytest.mark.parametrize("name", ["bn254", "pasta"])
def test_ec_dbl(lib, name):
    """ec_dbl on each curve (b3 = 9 on BN254, 15 on pallas) equals its
    twin dbl_limbs limb for limb on projective points (Z ≠ 1) and the
    identity, maps the identity to exactly (0 : 1 : 0), and gives the same
    affine point as ec_add(P, P) and the oracle's P + P. Both groups have
    prime order, so no point of them has Y = 0."""
    C, G, GEN, dbl, add = {
        "bn254": (curve.BN254, pycurve.G1, pycurve.G1_GEN, lib.pt_dbl,
                  lib.pt_add),
        "pasta": (curve.PASTA, pycurve.PASTA_G1, pycurve.PASTA_G1_GEN,
                  lib.pt_dbl_pallas, lib.pt_add_pallas)}[name]
    a = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 40, 48)]
    b = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 40, 48)]
    proj = C.add(C.from_affine_ints(a), C.from_affine_ints(b))
    P = torch.cat([proj, C.from_affine_ints([None, GEN])])
    pts = [G.add(x, y) for x, y in zip(a, b)] + [None, GEN]
    n = P.shape[0]
    pw = P.numpy().view(np.uint32)
    got = _run(lambda x, o: dbl(x, o, n), pw, out_shape=(n, 3, 8))
    twin = curve.dbl_limbs(P.to(torch.int64) & 0xFFFFFFFF, C)
    np.testing.assert_array_equal(got, twin.to(torch.int32).numpy()
                                  .view(np.uint32))
    np.testing.assert_array_equal(got[-2], C.identity().numpy()
                                  .view(np.uint32))
    added = _run(lambda x, y, o: add(x, y, o, n), pw, pw,
                 out_shape=(n, 3, 8))
    want = [G.add(x, x) for x in pts]
    assert C.to_affine_ints(torch.from_numpy(got.view(np.int32))) == want
    assert C.to_affine_ints(torch.from_numpy(added.view(np.int32))) == want
