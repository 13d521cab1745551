"""The port's Pippenger MSM (plain path) against a naive Python-curve sum,
on BN254 and on the Pasta pallas curve (the IPA backend's MSMs: 255-bit
scalars, padded and unpadded point counts), and its batched Lagrange
commitment with the 64-bit body / full-width tail split against the same
oracle on the k=6 SRS fixture. The comparisons with the JAX package are in
test_torch_msm_jax.py."""

import os

import numpy as np
import pytest
import torch

from zkodst_tpu_torch.ops import curve, msm, pycurve
from zkodst_tpu_torch.ops.field import FR, PASTA_FR, ints_to_limbs
from zkodst_tpu_torch.ops.pyfield import VESTA_BASE
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


PG, PGEN = pycurve.PASTA_G1, pycurve.PASTA_G1_GEN
# scalars the pallas MSM must read whole: 2^254 and p − 1 set bit 254,
# which a 254-bit window split drops
PALLAS_EDGES = [0, 1, 1 << 254, VESTA_BASE - 1]


def pallas_inputs(n, seed):
    """n pallas points (one the identity) and two rows of normal-form
    scalars: random ones with the edges at their head, and the edges
    cycling."""
    r = np.random.default_rng(seed)
    pts = [PG.mul(PGEN, int(k)) for k in r.integers(1, 1 << 30, n)]
    pts[n // 2] = None
    full = [int.from_bytes(r.bytes(32), "little") % VESTA_BASE
            for _ in range(n)]
    full[:4] = PALLAS_EDGES
    edge = [PALLAS_EDGES[i % 4] for i in range(n)]
    return pts, [full, edge]


@pytest.mark.parametrize("n", [8, 100, 256])
def test_pallas_msm_many_matches_naive(n):
    """msm_many(curve=PASTA), B = 2, at N = 8, 100 (padded to 128) and 256,
    equals the naive host sum; the default width reads bit 254."""
    pts, rows = pallas_inputs(n, 67 + n)
    C = curve.PASTA
    got = msm.msm_many(C.from_affine_ints(pts),
                       PASTA_FR.const(ints_to_limbs(rows)), c=13, curve=C)
    want = [None] * 2
    for b, row in enumerate(rows):
        for p, s in zip(pts, row):
            want[b] = PG.add(want[b], PG.mul(p, s))
    assert C.to_affine_ints(got) == want


@pytest.mark.parametrize("name", ["bn254", "pallas"])
def test_msm_windows_read_points_through_the_index(name, monkeypatch):
    """At n = 4096 (c = 12, so the Σ d·B_d scans take the chained form)
    kernel 11 runs gathered once per window pass: a spy where the MSM
    looks it up sees one call with an `index` per `_windows` pass, and
    calls without one only inside `_weighted_total`. The MSM of 64-bit
    scalars (six windows) equals the naive sum, taken as (Σ s_i·k_i)·G
    over the points k_i·G."""
    n = 4096
    C, grp, gen, order, F = (
        (curve.BN254, G, GEN, R, FR) if name == "bn254"
        else (curve.PASTA, PG, PGEN, VESTA_BASE, PASTA_FR))
    r = np.random.default_rng(71)
    ks = [int(k) for k in r.integers(1, 1 << 30, n)]
    sc = [int(s) for s in r.integers(0, 1 << 64, n, dtype=np.uint64)]
    sc[:4] = [0, 1, (1 << 64) - 1, 0]
    pts = [grp.mul(gen, k) for k in ks]
    passes, totals, scans = [], [], []
    windows, total, scan = msm._windows, msm._weighted_total, \
        msm.chain_scan_local

    def spy_windows(*a):
        passes.append(1)
        return windows(*a)

    def spy_total(*a):
        totals.append(1)
        try:
            return total(*a)
        finally:
            totals.pop()

    def spy_scan(*a, index=None, **kw):
        scans.append((index is not None, bool(totals)))
        return scan(*a, index=index, **kw)
    monkeypatch.setattr(msm, "_windows", spy_windows)
    monkeypatch.setattr(msm, "_weighted_total", spy_total)
    monkeypatch.setattr(msm, "chain_scan_local", spy_scan)
    got = msm.msm(C.from_affine_ints(pts), F.const(ints_to_limbs(sc)), c=12,
                  scalar_bits=64, curve=C)
    assert len(passes) == 1
    assert [s for s in scans if s[0]] == [(True, False)] * len(passes)
    dense = [s for s in scans if not s[0]]
    assert dense and all(inside for _, inside in dense)
    want = grp.mul(gen, sum(s * k for s, k in zip(sc, ks)) % order)
    assert C.to_affine_ints(got[None]) == [want]
