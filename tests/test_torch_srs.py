"""The port's SRS (made by its own fixed-base ladder) against the JAX
package's: the committed k=6 fixture and a fresh JAX setup(5)."""

import os

import numpy as np
import pytest
import torch

from zkodst_tpu.proof import srs as jsrs
from zkodst_tpu_torch.ops import curve, pycurve
from zkodst_tpu_torch.ops.field import from_limbs16
from zkodst_tpu_torch.proof import srs

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "dryrun_cache",
                       "srs_bn254_k6_s2.npz")


@pytest.fixture(scope="module")
def k6():
    return srs.setup(6, seed=2, device="cpu")


@pytest.mark.parametrize("basis", ["g1", "g1_lagrange"])
def test_setup_k6_equals_fixture(k6, basis):
    ref = np.load(FIXTURE)[basis]
    assert curve.to_affine_ints(getattr(k6, basis)) \
        == curve.to_affine_ints(from_limbs16(ref))


def test_load_fixture(k6):
    params = srs.load(FIXTURE, device="cpu")
    assert params.k == 6
    assert params.s_g2 == k6.s_g2 and params.g2 == pycurve.G2_GEN
    assert curve.to_affine_ints(params.g1) == curve.to_affine_ints(k6.g1)


def test_from_numpy_of_jax_setup_equals_port_setup():
    ref = jsrs.setup(5, seed=0)
    params = srs.from_numpy(np.asarray(ref.g1), np.asarray(ref.g1_lagrange),
                            ref.g2, ref.s_g2, device="cpu")
    mine = srs.setup(5, seed=0, device="cpu")
    assert params.k == mine.k == 5
    for basis in ("g1", "g1_lagrange"):
        assert curve.to_affine_ints(getattr(params, basis)) \
            == curve.to_affine_ints(getattr(mine, basis))
    assert params.s_g2 == mine.s_g2
