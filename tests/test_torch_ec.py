"""The plain twins of the port's EC kernels (8–12) against the Python
curve oracle and the JAX package's CPU paths, at small shapes (N = 512).

The scans are compared as affine points: the JAX paths associate additions
differently, which changes projective representatives but not points. The
doubling and scale_reduce's Horner follow the JAX package's own sequence
(RCB16 Alg. 9 and 7 over canonical field values), so those are compared
limb for limb, projective triple against projective triple. The twins of
kernels 9–12 on the Pasta pallas curve (the IPA backend's MSM) are held
to the host oracle PASTA_G1, and the doubling on pallas to JAX
``PASTA.double``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkodst_tpu.ops import curve as jcurve
from zkodst_tpu.ops import msm as jmsm
from zkodst_tpu_torch.kernels import ec
from zkodst_tpu_torch.ops import curve, pycurve
from zkodst_tpu_torch.ops.field import from_limbs16, to_limbs16

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

G, GEN = pycurve.G1, pycurve.G1_GEN
N = 512
rng = np.random.default_rng(41)


def _points(n, zero_every=0):
    pts = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 30, n)]
    if zero_every:
        pts[::zero_every] = [None] * len(pts[::zero_every])
    return pts


@pytest.fixture(scope="module")
def data():
    a, b = _points(N, zero_every=37), _points(N)
    b[5] = a[5]                                  # doubling
    b[6] = G.neg(a[6])                           # P + (−P)
    flags = rng.integers(0, 5, N) == 0
    flags[200:300] = False                       # a segment across runs
    return a, b, flags


def _packed(pts):
    return curve.pack(curve.from_affine_ints(pts))          # (1, 24, n)


def _affine(packed):
    return curve.to_affine_ints(curve.unpack(packed))


def _jax_packed(packed):
    """(1, 24, n) port layout -> the reference's (48, n) 16-bit layout."""
    return jnp.asarray(to_limbs16(curve.unpack(packed)[0]).reshape(-1, 48).T)


def _from_jax(pt48):
    n = pt48.shape[1]
    return curve.pack(from_limbs16(np.asarray(pt48).T.reshape(n, 3, 16)))


def _scan_oracle(pts, starts):
    out, acc = [], None
    for p, s in zip(pts, starts):
        acc = p if s else G.add(acc, p)
        out.append(acc)
    return out


def test_ec_add(data):
    a, b, _ = data
    got = ec.ec_add(_packed(a), _packed(b))
    assert _affine(got) == [G.add(x, y) for x, y in zip(a, b)]
    ja = jnp.asarray(jcurve.from_affine_ints(a))
    jb = jnp.asarray(jcurve.from_affine_ints(b))
    assert jcurve.to_affine_ints(np.asarray(jcurve.add(ja, jb))) \
        == _affine(got)


def test_seg_step(data):
    a, b, flags = data
    keep = torch.from_numpy(flags)[None]
    got = ec.seg_step(_packed(a), _packed(b), keep)
    want = [x if k else G.add(x, y) for x, y, k in zip(a, b, flags)]
    assert _affine(got) == want
    f = jnp.asarray(flags.astype(np.uint32))[None]
    jv, _ = jmsm._seg_step(_jax_packed(_packed(a)), _jax_packed(_packed(b)),
                           f, f)
    assert _affine(_from_jax(jv)) == want


@pytest.mark.parametrize("W", [128, 256])
def test_chain_scan_local(data, W):
    a, _, flags = data
    got = _affine(ec.chain_scan_local(_packed(a), torch.from_numpy(flags)[None],
                                      W))
    S = N // W
    for lane in range(W):
        idx = [s * W + lane for s in range(S)]
        starts = [True] + [bool(flags[i]) for i in idx[1:]]
        assert [got[i] for i in idx] == _scan_oracle([a[i] for i in idx],
                                                     starts)
    jv = jmsm._chain_scan_local(_jax_packed(_packed(a)),
                                jnp.asarray(flags), W)
    assert _affine(_from_jax(jv)) == got


def _chain_major(W):
    """Natural element l·S + k of a row at chain-major place k·W + l."""
    return np.arange(N).reshape(W, N // W).T.reshape(-1)


@pytest.mark.parametrize("W", [128, 256])
def test_chain_scan_local_gathered(data, W):
    """The gathered form's twin: chain l's k-th element is the row's
    (l·S + k)-th, the point of a permutation `index` there, read from the
    (N, 3, 8) table, with its flag in the same order. Held to the scan
    oracle, and to JAX ``_chain_scan_local`` on the explicitly gathered
    chain-major input."""
    a, _, flags = data
    index = np.random.default_rng(47).permutation(N)
    got = _affine(ec.chain_scan_local(
        curve.from_affine_ints(a), torch.from_numpy(flags)[None], W,
        index=torch.from_numpy(index)[None]))
    S = N // W
    for lane in range(W):
        rows = range(lane * S, (lane + 1) * S)
        starts = [True] + [bool(flags[j]) for j in rows[1:]]
        assert [got[k * W + lane] for k in range(S)] == _scan_oracle(
            [a[index[j]] for j in rows], starts)
    cm = _chain_major(W)
    jv = jmsm._chain_scan_local(
        _jax_packed(_packed([a[index[j]] for j in cm])),
        jnp.asarray(flags[cm]), W)
    assert _affine(_from_jax(jv)) == got


def test_chain_scan_local_gathered_rejects_bad_input(data):
    a, _, flags = data
    table = curve.from_affine_ints(a)
    f = torch.from_numpy(flags)[None]
    index = torch.arange(N)[None]
    with pytest.raises(ValueError, match="points"):
        ec.chain_scan_local(curve.pack(table), f, 128, index=index)
    with pytest.raises(ValueError, match="flags"):
        ec.chain_scan_local(table, f[:, :256], 128, index=index)
    with pytest.raises(ValueError, match="multiple"):
        ec.chain_scan_local(table, f, 384, index=index)


def _chain_aggregate_row(a, n):
    """A row of n lanes laid out as the MSM's chain aggregates: points
    drawn from `a`, sparse starts, a long stretch with none, and starts at
    multiples of 8, 128, 256 and 512 lanes (thread, warp and block
    boundaries of the kernel's layouts)."""
    r = np.random.default_rng(43)
    pts = [a[i] for i in r.integers(0, len(a), n)]
    flags = r.integers(0, 9, n) == 0
    flags[300:900] = False
    flags[512::512] = True
    flags[1280] = flags[1792] = flags[1152] = True
    flags[1544:1600:8] = True
    return pts, flags


@pytest.mark.parametrize("n", [8, 256, 512, 2048])
def test_seg_scan_tiles(data, n):
    a, _, flags = data
    if n > N:
        a, flags = _chain_aggregate_row(a, n)
    else:
        a, flags = a[:n], flags[:n]
    got = _affine(ec.seg_scan_tiles(_packed(a), torch.from_numpy(flags)[None]))
    starts = [True] + list(flags[1:])
    assert got == _scan_oracle(a, starts)
    if n >= N:
        jv = jmsm._seg_scan_packed_flat(_jax_packed(_packed(a)),
                                        jnp.asarray(flags))
        assert _affine(_from_jax(jv)) == got


def test_seg_scan_tiles_path_run(data, monkeypatch):
    """The path's largest call, (80, 24, 2048), scans runs of 16 lanes a
    thread (a row of 8 warps, padded nowhere but in the association); one
    such row, with the call's thread budget cut so that a single row takes
    the same run, against the oracle and JAX."""
    assert ec._scan_run(80, 2048) == 16
    monkeypatch.setattr(ec, "SCAN_CALL_THREADS", 64)
    assert ec._scan_run(1, 2048) == 16
    a, flags = _chain_aggregate_row(data[0], 2048)
    got = _affine(ec.seg_scan_tiles(_packed(a), torch.from_numpy(flags)[None]))
    assert got == _scan_oracle(a, [True] + list(flags[1:]))
    jv = jmsm._seg_scan_packed_flat(_jax_packed(_packed(a)), jnp.asarray(flags))
    assert _affine(_from_jax(jv)) == got


def test_seg_scan_tiles_rows_are_independent(data):
    """Rows scanned together give each row's own scan, and a row without
    any start but its first lane is one segment."""
    a, _, flags = data
    rows = [a, a[::-1], a]
    starts = [flags, flags[::-1], np.zeros(N, bool)]
    P = torch.cat([_packed(r) for r in rows])
    got = _affine(ec.seg_scan_tiles(P, torch.from_numpy(np.stack(starts))))
    for i, (r, f) in enumerate(zip(rows, starts)):
        assert got[i * N:(i + 1) * N] == _scan_oracle(r, [True] + list(f[1:]))


@jax.jit
def _jax_horner(win_sums, c):
    """The JAX msm's combine of window sums off the TPU (zkodst_tpu/ops/
    msm.py, the Horner after `scale_reduce`), with c as a loop bound."""
    def combine(acc, s):
        acc = jax.lax.fori_loop(0, c, lambda _, a: jcurve.double(a), acc)
        return jcurve.add(acc, s), None

    acc, _ = jax.lax.scan(combine, win_sums[-1], win_sums[:-1][::-1])
    return acc


def _to_jax(pts):
    """(..., 3, 8) port points -> the reference's (..., 3, 16) layout."""
    return jnp.asarray(to_limbs16(pts))


# curve -> (the port's curve, the host group and generator, JAX's double)
CURVES = {"bn254": (curve.BN254, G, GEN, jcurve.double),
          "pasta": (curve.PASTA, pycurve.PASTA_G1, pycurve.PASTA_G1_GEN,
                    jcurve.PASTA.double)}


@pytest.mark.parametrize("name", list(CURVES))
def test_dbl_limbs_equals_jax_double(name):
    """The twin of zk::ec_dbl against JAX `double` on the same curve, limb
    for limb, on projective points (Z ≠ 1, from an add) and the
    identity."""
    C, H, gen, jdouble = CURVES[name]
    r = np.random.default_rng(47)
    a = [H.mul(gen, int(k)) for k in r.integers(1, 1 << 30, 40)]
    b = [H.mul(gen, int(k)) for k in r.integers(1, 1 << 30, 40)]
    proj = C.add(C.from_affine_ints(a), C.from_affine_ints(b))
    P = torch.cat([proj, C.from_affine_ints([None, gen])])
    got = curve.dbl_limbs(P.to(torch.int64) & 0xFFFFFFFF, C).to(torch.int32)
    want = np.asarray(jdouble(_to_jax(P)))
    np.testing.assert_array_equal(to_limbs16(got), want)
    assert torch.equal(got[-2], C.identity())
    assert C.to_affine_ints(got) == [H.add(p, p) for p in (
        [H.add(x, y) for x, y in zip(a, b)] + [None, gen])]


@pytest.mark.parametrize("c,nlive", [(13, 5), (8, 3), (4, 64), (13, 20)])
def test_scale_reduce(c, nlive):
    """The twin of kernel 12 against the JAX msm's Horner combine, limb for
    limb, and against the oracle as an affine point; some windows are the
    identity (an empty window sum)."""
    ks = [int(k) for k in rng.integers(1, 1 << 40, nlive)]
    for w in range(1, nlive, 4):
        ks[w] = 0
    pts = [G.mul(GEN, k) if k else None for k in ks]
    ws = _packed(pts)
    out = ec.scale_reduce(ws, c)                         # (1, 24)
    got = curve.to_affine_ints(curve.unpack(out[:, :, None]))
    want = G.mul(GEN, sum(k << (c * w) for w, k in enumerate(ks)))
    assert got == [want]
    jv = _jax_horner(jnp.asarray(jcurve.from_affine_ints(pts)), c)
    np.testing.assert_array_equal(
        to_limbs16(curve.unpack(out[:, :, None])[0, 0]), np.asarray(jv))


# -- kernels 9–12 on the Pasta pallas curve -----------------------------------

PG, PGEN = pycurve.PASTA_G1, pycurve.PASTA_G1_GEN
NP = 256


@pytest.fixture(scope="module")
def pallas_data():
    """NP pallas points with identities, a second row with P + P and
    P + (−P) against the first, and sparse segment starts with a stretch
    of none."""
    r = np.random.default_rng(89)
    a = [PG.mul(PGEN, int(k)) for k in r.integers(1, 1 << 30, NP)]
    a[::29] = [None] * len(a[::29])
    b = [PG.mul(PGEN, int(k)) for k in r.integers(1, 1 << 30, NP)]
    b[5], b[6] = a[5], PG.neg(a[6])
    flags = r.integers(0, 5, NP) == 0
    flags[100:180] = False
    return a, b, flags


def _pallas_packed(pts):
    return curve.pack(curve.PASTA.from_affine_ints(pts))


def _pallas_affine(packed):
    return curve.PASTA.to_affine_ints(curve.unpack(packed))


def _pallas_scan_oracle(pts, starts):
    out, acc = [], None
    for p, s in zip(pts, starts):
        acc = p if s else PG.add(acc, p)
        out.append(acc)
    return out


@pytest.mark.parametrize("kernel", ["seg_step", "chain_scan_local",
                                    "chain_scan_gathered",
                                    "seg_scan_tiles", "scale_reduce"])
def test_pallas_twins_match_host_oracle(pallas_data, kernel):
    """The twin of each of kernels 9–12 on pallas (b3 = 15) against the
    host group PASTA_G1 as affine points."""
    a, b, flags = pallas_data
    C = curve.PASTA
    f = torch.from_numpy(flags)[None]
    if kernel == "seg_step":
        got = _pallas_affine(ec.seg_step(_pallas_packed(a), _pallas_packed(b),
                                         f, curve=C))
        assert got == [x if k else PG.add(x, y)
                       for x, y, k in zip(a, b, flags)]
    elif kernel == "chain_scan_local":
        W = 64
        got = _pallas_affine(ec.chain_scan_local(_pallas_packed(a), f, W,
                                                 curve=C))
        for lane in range(W):
            idx = list(range(lane, NP, W))
            starts = [True] + [bool(flags[i]) for i in idx[1:]]
            assert [got[i] for i in idx] == _pallas_scan_oracle(
                [a[i] for i in idx], starts)
    elif kernel == "chain_scan_gathered":
        W = 64
        S = NP // W
        index = np.random.default_rng(48).permutation(NP)
        got = _pallas_affine(ec.chain_scan_local(
            C.from_affine_ints(a), f, W, curve=C,
            index=torch.from_numpy(index)[None]))
        for lane in range(W):
            rows = range(lane * S, (lane + 1) * S)
            starts = [True] + [bool(flags[j]) for j in rows[1:]]
            assert [got[k * W + lane] for k in range(S)] == \
                _pallas_scan_oracle([a[index[j]] for j in rows], starts)
    elif kernel == "seg_scan_tiles":
        got = _pallas_affine(ec.seg_scan_tiles(_pallas_packed(a), f,
                                               curve=C))
        assert got == _pallas_scan_oracle(a, [True] + list(flags[1:]))
    else:
        c, ks = 4, [3, 0, 1 << 40, 7, (1 << 254) + 5]
        ws = _pallas_packed([PG.mul(PGEN, k) if k else None for k in ks])
        out = ec.scale_reduce(ws, c, curve=C)
        got = C.to_affine_ints(curve.unpack(out[:, :, None]))
        assert got == [PG.mul(PGEN, sum(k << (c * w)
                                        for w, k in enumerate(ks)))]
