"""The plain twins of the port's EC kernels (8–12) against the Python
curve oracle and the JAX package's CPU paths, at small shapes (N = 512).

Points are compared as affine points: the JAX paths associate additions
differently, which changes projective representatives but not points."""

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


@pytest.mark.parametrize("n", [8, 256, 512])
def test_seg_scan_tiles(data, n):
    a, _, flags = data
    a, flags = a[:n], flags[:n]
    got = _affine(ec.seg_scan_tiles(_packed(a), torch.from_numpy(flags)[None]))
    starts = [True] + list(flags[1:])
    assert got == _scan_oracle(a, starts)
    if n == N:
        jv = jmsm._seg_scan_packed_flat(_jax_packed(_packed(a)),
                                        jnp.asarray(flags))
        assert _affine(_from_jax(jv)) == got


@jax.jit
def _jax_horner(win_sums, c):
    """The JAX msm's combine of window sums off the TPU (zkodst_tpu/ops/
    msm.py, the Horner after `scale_reduce`), with c as a loop bound."""
    def combine(acc, s):
        acc = jax.lax.fori_loop(0, c, lambda _, a: jcurve.double(a), acc)
        return jcurve.add(acc, s), None

    acc, _ = jax.lax.scan(combine, win_sums[-1], win_sums[:-1][::-1])
    return acc


@pytest.mark.parametrize("c,nlive", [(13, 5), (8, 3)])
def test_scale_reduce(c, nlive):
    ks = [int(k) for k in rng.integers(1, 1 << 40, nlive)]
    pts = [G.mul(GEN, k) for k in ks]
    ws = _packed(pts)
    got = curve.to_affine_ints(curve.unpack(ec.scale_reduce(ws, c)[:, :, None]))
    want = G.mul(GEN, sum(k << (c * w) for w, k in enumerate(ks)))
    assert got == [want]
    jv = _jax_horner(jnp.asarray(jcurve.from_affine_ints(pts)), c)
    assert jcurve.to_affine_ints(np.asarray(jv)[None]) == got
