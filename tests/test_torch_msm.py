"""The port's Pippenger MSM (plain path) against a naive Python-curve sum,
and its batched Lagrange commitment with the 64-bit body / full-width tail
split against the same oracle on the k=6 SRS fixture. The comparisons
with the JAX package are in test_torch_msm_jax.py."""

import os

import numpy as np
import pytest
import torch

from zkodst_tpu_torch.ops import curve, msm, pycurve
from zkodst_tpu_torch.ops.field import FR, ints_to_limbs
from zkodst_tpu_torch.proof import srs

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

G, GEN = pycurve.G1, pycurve.G1_GEN
R = pycurve.R_ORDER
FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "dryrun_cache",
                       "srs_bn254_k6_s2.npz")
rng = np.random.default_rng(53)


def _naive(pts, scalars):
    acc = None
    for p, s in zip(pts, scalars):
        acc = G.add(acc, G.mul(p, s))
    return acc


def _scalars(n, kind):
    if kind == "u64":
        s = [int(x) for x in rng.integers(0, 1 << 64, n, dtype=np.uint64)]
        s[2:40] = [(1 << 64) - 1] * 38           # one segment across chains
    elif kind == "full":
        s = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    else:                                        # edge: 0, 1, r-1, repeats
        s = [[0, 1, R - 1, 3][i % 4] for i in range(n)]
    s[0], s[1] = 0, 1
    return s


@pytest.mark.parametrize("n,kind", [(512, "u64"), (512, "edge"),
                                    (1024, "full")])
def test_msm_matches_naive(n, kind):
    pts = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 30, n)]
    sc = _scalars(n, kind)
    limbs = FR.const(ints_to_limbs(sc))
    bits = 64 if kind == "u64" else msm.SCALAR_BITS
    got = msm.msm(curve.from_affine_ints(pts), limbs, c=13, scalar_bits=bits)
    assert curve.to_affine_ints(got) == [_naive(pts, sc)]


def test_msm_many_mont_batches():
    n = 512
    pts = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 30, n)]
    batch = [_scalars(n, "full"), _scalars(n, "edge")]
    got = msm.msm_many_mont(curve.from_affine_ints(pts), FR.from_ints(batch),
                            c=8)
    assert curve.to_affine_ints(got) == [_naive(pts, s) for s in batch]


def test_commit_lagrange_many_body_tail_split():
    params = srs.load(FIXTURE, device="cpu")
    n = params.n
    lag = curve.to_affine_ints(params.g1_lagrange)
    cols = []
    for _ in range(3):
        body = [int(x) for x in rng.integers(0, 1 << 64, n - 8,
                                             dtype=np.uint64)]
        cols.append(body + [int.from_bytes(rng.bytes(32), "little") % R
                            for _ in range(8)])
    got = srs.commit_lagrange_many(params, FR.from_ints(cols), c=13,
                                   body_bits=64, tail_rows=8)
    assert got == [_naive(lag, col) for col in cols]
    full = srs.commit_lagrange_many(params, FR.from_ints(cols), c=13)
    assert full == got
