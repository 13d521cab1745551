"""The port's NTT (plain path) against the JAX package's ``ops/ntt.py`` on
the same inputs, and the tail/head twins of kernels 6–7 at every slab
width. Exact equality: the outputs are canonical field values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkodst_tpu.ops import field as jfield
from zkodst_tpu.ops import ntt as jntt
from zkodst_tpu.proof import domain as jdomain
from zkodst_tpu_torch.kernels import ntt as kntt
from zkodst_tpu_torch.ops import field as tfield
from zkodst_tpu_torch.ops import ntt as tntt
from zkodst_tpu_torch.ops.pyfield import FR as PFR
from zkodst_tpu_torch.proof import domain as tdomain

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

JF, TF = jfield.FR, tfield.FR
rng = np.random.default_rng(83)


def _column(shape):
    vals = [int.from_bytes(rng.bytes(40), "little") % PFR.p
            for _ in range(int(np.prod(shape)))]
    vals[:3] = [0, 1, PFR.p - 1]
    return np.asarray(vals, dtype=object).reshape(shape)


@pytest.mark.parametrize("n", [8, 32, 64])
def test_ntt_and_intt_match_jax(n):
    a = JF.from_ints(_column((3, n)))
    w = PFR.root_of_unity(n.bit_length() - 1)
    ta = tfield.from_limbs16(a)
    got = tntt.ntt(TF, ta, w)
    np.testing.assert_array_equal(tfield.to_limbs16(got),
                                  np.asarray(jntt.ntt(JF, jnp.asarray(a), w)))
    back = tntt.intt(TF, got, w)
    np.testing.assert_array_equal(
        tfield.to_limbs16(back),
        np.asarray(jntt.intt(JF, jnp.asarray(tfield.to_limbs16(got)), w)))
    assert torch.equal(back, ta)


def test_powers_table_matches_jax():
    g = PFR.root_of_unity(6)
    got = tntt.powers_table(TF, g, 37)
    np.testing.assert_array_equal(tfield.to_limbs16(got),
                                  np.asarray(jntt.powers_table(JF, g, 37)))


@pytest.mark.parametrize("T", [2, 4, 8, 16, 32, 64])
def test_tail_and_head_twins_at_every_slab(T):
    """Tail (bit reversal + stages h < T) then one head per stage h ≥ T is
    the same transform whatever T is: the reference's own result."""
    n = 64
    a = JF.from_ints(_column((2, n)))
    w = PFR.root_of_unity(6)
    want = np.asarray(jntt.ntt(JF, jnp.asarray(a), w))
    pw = tntt.powers_table(TF, w, n // 2)
    x = kntt.ntt_tail_plain(TF, tfield.from_limbs16(a), pw, T)
    h = T
    while h < n:
        x = kntt.ntt_head_plain(TF, x, pw, h)
        h *= 2
    np.testing.assert_array_equal(tfield.to_limbs16(x), want)


def test_domain_transforms_match_jax():
    k = 5
    a = JF.from_ints(_column((2, 1 << k)))
    td, jd = tdomain.Domain(k), jdomain.Domain(k)
    assert (td.omega, td.usable, tdomain.DELTA, tdomain.GEN) == \
        (jd.omega, jd.usable, jdomain.DELTA, jdomain.GEN)
    np.testing.assert_array_equal(
        tfield.to_limbs16(td.intt(tfield.from_limbs16(a))),
        np.asarray(jd.intt(jnp.asarray(a))))
    np.testing.assert_array_equal(
        tfield.to_limbs16(td.ntt(tfield.from_limbs16(a))),
        np.asarray(jd.ntt(jnp.asarray(a))))


def test_wrappers_check_shapes():
    x = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        kntt.ntt_tail(TF, x, torch.zeros((3, 8), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        kntt.ntt_tail(TF, x, torch.zeros((4, 8), dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        kntt.ntt_head(TF, x, torch.zeros((4, 8), dtype=torch.int32), 8)
