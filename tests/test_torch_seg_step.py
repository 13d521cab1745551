"""Kernel 9's plain forms and the MSM glue around it against the JAX
package, on the CPU at small shapes.

Each form of ``seg_step_plain`` (natural; gathered and in place, each
element reading its chain's carry through an index; chains, in place on
chain-major elements, the carry applied before each chain's first start)
must equal the JAX package's ``_seg_step`` limb for limb on the
materialised inputs that the reference builds (the carry repeated or
gathered to full size, a keep row, the scan in natural order), at no
adds, about a quarter and all. The port's chained scan (chain-major) and
``_weighted_total`` are held to the reference's ``_seg_scan_chained_full``
and ``_weighted_total_packed`` as points (the flat scans associate
additions differently), ``_weighted_total`` on both of its branches, and
on the Pasta pallas curve to the host group."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkodst_tpu.ops import curve as jcurve
from zkodst_tpu.ops import msm as jmsm
from zkodst_tpu_torch.kernels import ec
from zkodst_tpu_torch.ops import curve, msm, pycurve
from zkodst_tpu_torch.ops.field import to_limbs16

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

G, GEN = pycurve.G1, pycurve.G1_GEN
B, N, W = 2, 64, 8              # rows, elements a row, chains
S = N // W
rng = np.random.default_rng(97)
# the share of elements that add: none, about a quarter, all
DENSITIES = [0.0, 0.25, 1.0]


def _points(n, gen=GEN, grp=G):
    pts = [grp.mul(gen, int(k)) for k in rng.integers(1, 1 << 30, n)]
    pts[5] = None                                # the identity
    return pts


@pytest.fixture(scope="module")
def rows():
    """(B, 24, N) points, (B, 24, N) addends, (B, 24, W) carries."""
    p = [_points(N) for _ in range(B)]
    q = [_points(N) for _ in range(B)]
    q[0][7] = p[0][7]                            # doubling
    q[1][9] = G.neg(p[1][9])                     # P + (−P)
    carry = [_points(W) for _ in range(B)]
    pack = lambda rs: torch.cat([curve.pack(curve.from_affine_ints(r))
                                 for r in rs])
    return pack(p), pack(q), pack(carry)


def _keep(density):
    return torch.from_numpy(rng.random((B, N)) >= density)


def _jax(packed_row):
    """(24, n) port layout -> the reference's (48, n) 16-bit layout."""
    return jnp.asarray(to_limbs16(curve.unpack(packed_row[None])[0])
                       .reshape(-1, 48).T)


def _jax_step(p, q, keep):
    """The reference's _seg_step on each row: (B, n) arrays of 48 rows."""
    out = []
    for b in range(p.shape[0]):
        f = jnp.asarray(keep[b].numpy().astype(np.uint32))[None]
        v, _ = jmsm._seg_step(_jax(p[b]), _jax(q[b]), f, f)
        out.append(np.asarray(v))
    return out


def _same_as_jax(got, want):
    for b, w in enumerate(want):
        assert np.array_equal(np.asarray(_jax(got[b])), w)


@pytest.mark.parametrize("density", DENSITIES)
def test_natural_form_equals_jax(rows, density):
    p, q, _ = rows
    keep = _keep(density)
    _same_as_jax(ec.seg_step(p, q, keep), _jax_step(p, q, keep))


@pytest.mark.parametrize("density", DENSITIES)
def test_gathered_in_place_equals_jax(rows, density):
    """In place, each element adding the carry its index names: the
    reference on the carry gathered to full size."""
    p, _, carry = rows
    keep = _keep(density)
    idx = torch.from_numpy(rng.integers(0, W, (B, N)))
    full = torch.stack([carry[b][:, idx[b]] for b in range(B)])
    want = _jax_step(p, full, keep)
    x = p.clone()
    got = ec.seg_step(x, carry, keep, out=x, q_index=idx)
    assert got is x
    _same_as_jax(x, want)


@pytest.mark.parametrize("density", DENSITIES)
def test_chains_form_equals_jax(rows, density):
    """In place on chain-major elements, chain l's carry on its elements
    before its first start: the reference on the scan in natural order,
    the carry repeated S times and the keep row it derives."""
    local, _, carry = rows
    if density == 0.0:
        fs = torch.zeros((B, W), dtype=torch.int64)
    elif density == 1.0:
        fs = torch.full((B, W), S, dtype=torch.int64)
    else:
        fs = torch.from_numpy(rng.integers(0, S // 2 + 1, (B, W)))
    nat = local.reshape(B, 24, S, W).transpose(2, 3).reshape(B, 24, N)
    full = carry.repeat_interleave(S, dim=2)
    keep = ~(torch.arange(N) % S < fs.repeat_interleave(S, dim=1))
    x = local.clone()
    assert ec.seg_step(x, carry, fs=fs, out=x) is x
    got = x.reshape(B, 24, S, W).transpose(2, 3).reshape(B, 24, N)
    _same_as_jax(got, _jax_step(nat, full, keep))


def test_forms_refuse_what_they_cannot_take(rows):
    p, q, carry = rows
    keep = _keep(0.25)
    fs = torch.zeros((B, W), dtype=torch.int64)
    with pytest.raises(ValueError, match="chains form"):
        ec.seg_step(p, carry, keep, fs=fs)
    with pytest.raises(ValueError, match="chains form"):
        ec.seg_step(p, q, fs=fs)
    with pytest.raises(ValueError, match="shapes"):
        ec.seg_step(p, carry, keep)
    with pytest.raises(ValueError, match="q_index"):
        ec.seg_step(p, carry, keep, q_index=torch.zeros((B, W),
                                                        dtype=torch.int64))
    with pytest.raises(ValueError, match="keep or fs"):
        ec.seg_step(p, q)


def _jax_affine(pt48):
    n = pt48.shape[1]
    return jcurve.to_affine_ints(np.asarray(pt48).T.reshape(n, 3, 16))


@pytest.mark.parametrize("starts", ["first", "sparse", "chain_heads"])
def test_seg_scan_chained_equals_jax(rows, starts):
    """n = 64, W = 8: the port's chained scan (kernels 11, 10 and 9's
    chains form, chain-major in and out) against zkodst_tpu/ops/msm.py's
    _seg_scan_chained_full (natural order), as points."""
    p, _, _ = rows
    p = p[:1]
    st = np.zeros(N, bool)
    if starts == "first":
        st[0] = True
    elif starts == "sparse":
        st[[0, 3, 17, 18, 40]] = True             # chains 1, 3–7 have none
    else:
        st[::S] = True
    cm = torch.from_numpy(st)[None]
    cm = cm.reshape(1, W, S).transpose(1, 2).reshape(1, N)
    pcm = p.reshape(1, 24, W, S).transpose(2, 3).reshape(1, 24, N)
    got = msm._seg_scan_chained(pcm, cm, W, curve.BN254)
    got = got.reshape(1, 24, S, W).transpose(2, 3).reshape(1, 24, N)
    want = jmsm._seg_scan_chained_full(_jax(p[0]), jnp.asarray(st), W)
    assert curve.to_affine_ints(curve.unpack(got)[0]) == _jax_affine(want)


def _buckets(nb, grp, gen, cv):
    pts = [grp.mul(gen, int(k)) for k in rng.integers(1, 1 << 20, nb)]
    pts[0] = grp.mul(gen, 99)                    # weight 0: not counted
    pts[3] = None
    return pts, curve.pack(cv.from_affine_ints(pts))


@pytest.mark.parametrize("nb", [256, 2048])
def test_weighted_total_equals_jax(nb):
    """Σ d·B_d: the flat branch (256 buckets) and the chained one (2048,
    the sum of the suffix sums as one element) against the reference's
    _weighted_total_packed, as points, and against the host sum."""
    pts, packed = _buckets(nb, G, GEN, curve.BN254)
    got = curve.to_affine_ints(curve.unpack(
        msm._weighted_total(packed, curve.BN254))[0])
    want = _jax_affine(jmsm._weighted_total_packed(_jax(packed[0])))
    assert got == want
    acc = None
    for d, pt in enumerate(pts):
        acc = G.add(acc, G.mul(pt, d)) if pt is not None and d else acc
    assert got == [acc]


@pytest.mark.parametrize("nb", [256, 2048])
def test_weighted_total_pallas(nb):
    """The same on the pallas curve (the Pasta IPA's MSM), against the
    host group PASTA_G1."""
    PG, PGEN = pycurve.PASTA_G1, pycurve.PASTA_G1_GEN
    C = curve.PASTA
    pts, packed = _buckets(nb, PG, PGEN, C)
    got = C.to_affine_ints(curve.unpack(msm._weighted_total(packed, C))[0])
    acc = None
    for d, pt in enumerate(pts):
        acc = PG.add(acc, PG.mul(pt, d)) if pt is not None and d else acc
    assert got == [acc]
