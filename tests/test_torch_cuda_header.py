"""The CUDA kernels' shared arithmetic header (cuda/csrc/field.cuh), built
for the host with g++, against the plain twins and Python ints. The header
is __host__ __device__, so this checks the Montgomery multiply, add, sub
and the complete EC addition and doubling that every kernel runs, without
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
from zkodst_tpu_torch.ops.field import FQ, FR, ints_to_limbs

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zkodst_tpu_torch", "cuda", "csrc")

SHIM = r"""
#include "field.cuh"
extern "C" {
void fe_op(int field, int op, const uint32_t* a, const uint32_t* b,
           uint32_t* o, long long n) {
  for (long long i = 0; i < n; ++i) {
    const uint32_t *x = a + 8 * i, *y = b + 8 * i;
    uint32_t* r = o + 8 * i;
    if (field == 0) {
      if (op == 0) zk::mont_mul<zk::Fr>(x, y, r);
      else if (op == 1) zk::add_mod<zk::Fr>(x, y, r);
      else zk::sub_mod<zk::Fr>(x, y, r);
    } else {
      if (op == 0) zk::mont_mul<zk::Fq>(x, y, r);
      else if (op == 1) zk::add_mod<zk::Fq>(x, y, r);
      else zk::sub_mod<zk::Fq>(x, y, r);
    }
  }
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
  else zk::Fq::one(o);
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


@pytest.mark.parametrize("op", [0, 1, 2], ids=["mul", "add", "sub"])
@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_field_ops(lib, F, op):
    a = [int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(200)]
    b = [int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(200)]
    edges = [0, 1, F.p - 1, F.r]
    a, b = a + edges * 4, b + [e for e in edges for _ in range(4)]
    A, B = F.from_ints(a), F.from_ints(b)
    n = len(a)
    got = _run(lambda x, y, o: lib.fe_op(F.kernel_id, op, x, y, o, n),
               A.numpy().view(np.uint32), B.numpy().view(np.uint32),
               out_shape=(n, 8))
    plain = {0: F.mul, 1: F.add, 2: F.sub}[op](A, B)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))


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


def test_ec_dbl(lib):
    """ec_dbl equals its twin dbl_limbs limb for limb on projective points
    (Z ≠ 1) and the identity, maps the identity to exactly (0 : 1 : 0), and
    gives the same affine point as ec_add(P, P) and the oracle's P + P.
    BN254's G1 has prime order, so no point of it has Y = 0."""
    G, GEN = pycurve.G1, pycurve.G1_GEN
    a = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 40, 48)]
    b = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 40, 48)]
    proj = curve.add(curve.from_affine_ints(a), curve.from_affine_ints(b))
    P = torch.cat([proj, curve.from_affine_ints([None, GEN])])
    pts = [G.add(x, y) for x, y in zip(a, b)] + [None, GEN]
    n = P.shape[0]
    pw = P.numpy().view(np.uint32)
    got = _run(lambda x, o: lib.pt_dbl(x, o, n), pw, out_shape=(n, 3, 8))
    twin = curve.dbl_limbs(P.to(torch.int64) & 0xFFFFFFFF)
    np.testing.assert_array_equal(got, twin.to(torch.int32).numpy()
                                  .view(np.uint32))
    np.testing.assert_array_equal(got[-2], curve.identity().numpy()
                                  .view(np.uint32))
    added = _run(lambda x, y, o: lib.pt_add(x, y, o, n), pw, pw,
                 out_shape=(n, 3, 8))
    want = [G.add(x, x) for x in pts]
    assert curve.to_affine_ints(torch.from_numpy(got.view(np.int32))) == want
    assert curve.to_affine_ints(torch.from_numpy(added.view(np.int32))) \
        == want
