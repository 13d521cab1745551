"""The port's Pippenger MSM and its batched Lagrange commitment (plain
path) against the JAX package's ``msm`` and ``commit_lagrange_many`` on the
same inputs, run as the JAX package runs them on the CPU. Points are
compared as affine points: the two associate additions differently. On the
Pasta pallas curve the port's Pippenger is held to the JAX IPA's
``_msm_mont_cfg`` (a per-lane double-and-add and a pairwise fold)."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from zkodst_tpu.ops import curve as jcurve
import pytest

from zkodst_tpu.ops import msm as jmsm
from zkodst_tpu.proof import ipa as jipa
from zkodst_tpu.proof import srs as jsrs
from zkodst_tpu_torch.ops import curve, msm, pycurve
from zkodst_tpu_torch.ops.field import FR, PASTA_FR, ints_to_limbs, \
    to_limbs16
from zkodst_tpu_torch.proof import srs
from test_torch_msm import pallas_inputs

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

G, GEN = pycurve.G1, pycurve.G1_GEN
R = pycurve.R_ORDER
FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "dryrun_cache",
                       "srs_bn254_k6_s2.npz")
rng = np.random.default_rng(59)


def test_msm_matches_jax():
    n = 512
    pts = [G.mul(GEN, int(k)) for k in rng.integers(1, 1 << 30, n)]
    pts[7] = None                                # the identity
    sc = [int(x) for x in rng.integers(0, 1 << 64, n, dtype=np.uint64)]
    sc[2:40] = [(1 << 64) - 1] * 38              # one segment across chains
    sc[40:48] = [0, 1, 2, 3] * 2
    P = curve.from_affine_ints(pts)
    S = FR.const(ints_to_limbs(sc))
    got = msm.msm(P, S, c=8, scalar_bits=64)
    want = jmsm.msm(jnp.asarray(to_limbs16(P)), jnp.asarray(to_limbs16(S)),
                    c=8, scalar_bits=64)
    assert curve.to_affine_ints(got[None]) \
        == jcurve.to_affine_ints(np.asarray(want)[None])


def test_commit_lagrange_many_matches_jax():
    params = srs.load(FIXTURE, device="cpu")
    n = params.n
    cols = []
    for _ in range(3):
        body = [int(x) for x in rng.integers(0, 1 << 64, n - 8,
                                             dtype=np.uint64)]
        cols.append(body + [int.from_bytes(rng.bytes(32), "little") % R
                            for _ in range(8)])
    mont = FR.from_ints(cols)
    got = srs.commit_lagrange_many(params, mont, c=13, body_bits=64,
                                   tail_rows=8)
    want = jsrs.commit_lagrange_many(jsrs.load(FIXTURE),
                                     jnp.asarray(to_limbs16(mont)), c=13,
                                     body_bits=64, tail_rows=8)
    assert got == want


@pytest.mark.parametrize("n", [8, 100, 256])
def test_pallas_msm_matches_jax(n):
    """msm_many(curve=PASTA), B = 2 (scalars 0, 1, 2^254 and p − 1 among
    them), against the JAX IPA's pallas MSM of each row."""
    pts, rows = pallas_inputs(n, 71 + n)
    C = curve.PASTA
    P = C.from_affine_ints(pts)
    got = C.to_affine_ints(msm.msm_many(
        P, PASTA_FR.const(ints_to_limbs(rows)), c=13, curve=C))
    cfg = jipa._CFGS["pasta"]
    jp = jnp.asarray(to_limbs16(P))
    for b, row in enumerate(rows):
        want = jipa._msm_mont_cfg(
            cfg, jp, jnp.asarray(to_limbs16(PASTA_FR.from_ints(row))))
        assert cfg.dev.to_affine_ints(np.asarray(want)[None]) == [got[b]]
