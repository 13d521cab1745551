"""The port's field add, prefix products and batch inverse (plain path)
against the JAX package's ``ops/field.py`` on the same inputs, and the
twins of kernels 2, 4 and 5 against Python ints. A small chain width W
makes ``cumprod_incl`` take the chained path (kernels 4 → 5 → 1) that the
flagship takes at W = 2048. Exact equality throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkodst_tpu.ops import field as jfield
from zkodst_tpu_torch.kernels import mulmod as kmul
from zkodst_tpu_torch.ops import field as tfield

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

PAIRS = [(jfield.FR, tfield.FR), (jfield.FQ, tfield.FQ)]
rng = np.random.default_rng(89)


def _vals(p, n, nonzero=False):
    lo = 1 if nonzero else 0
    v = [lo + int.from_bytes(rng.bytes(40), "little") % (p - lo)
         for _ in range(n)]
    v[:2] = [1, p - 1]
    return v


@pytest.mark.parametrize("pair", PAIRS, ids=["fr", "fq"])
def test_add_matches_jax(pair):
    JF, TF = pair
    a, b = _vals(JF.p, 40), _vals(JF.p, 40)
    want = np.asarray(jax.jit(JF.add)(JF.from_ints(a), JF.from_ints(b)))
    got = TF.add(TF.from_ints(a), TF.from_ints(b))
    np.testing.assert_array_equal(tfield.to_limbs16(got), want)
    c = TF.from_ints(b[0])                         # a broadcast constant
    assert list(TF.to_ints(TF.add(TF.from_ints(a), c))) == \
        [(x + b[0]) % TF.p for x in a]


@pytest.mark.parametrize("W", [4, 16, 2048])
@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
def test_cumprod_incl_matches_jax(reverse, W):
    JF, TF = jfield.FR, tfield.FR
    a = JF.from_ints(_vals(JF.p, 64))
    want = np.asarray(jax.jit(lambda x: JF.cumprod_incl(x, reverse=reverse))(
        jnp.asarray(a)))
    got = TF.cumprod_incl(tfield.from_limbs16(a), reverse=reverse, W=W)
    np.testing.assert_array_equal(tfield.to_limbs16(got), want)


def test_cumprod_incl_pads_a_ragged_column():
    TF = tfield.FR
    v = _vals(TF.p, 50)
    got = TF.to_ints(TF.cumprod_incl(TF.from_ints(v), W=8))
    acc, want = 1, []
    for x in v:
        acc = acc * x % TF.p
        want.append(acc)
    assert list(got) == want


def test_inv_batch_matches_jax():
    JF, TF = jfield.FR, tfield.FR
    v = _vals(JF.p, 64, nonzero=True)
    want = np.asarray(jax.jit(JF.inv_batch)(jnp.asarray(JF.from_ints(v))))
    got = TF.inv_batch(TF.from_ints(v))
    np.testing.assert_array_equal(tfield.to_limbs16(got), want)
    assert list(TF.to_ints(got)) == [pow(x, -1, TF.p) for x in v]
    assert list(TF.to_ints(TF.inv(TF.from_ints([0, 2])))) == \
        [0, pow(2, -1, TF.p)]


@pytest.mark.parametrize("F", [tfield.FR, tfield.FQ], ids=["fr", "fq"])
def test_chain_and_tile_twins(F):
    v = _vals(F.p, 48)
    x = F.from_ints(v)
    W, S = 6, 8
    runs = F.to_ints(kmul.chain_cumprod(F, x, W)).reshape(W, S)
    tile = F.to_ints(kmul.cumprod_tile(F, x))
    acc = 1
    for i, val in enumerate(v):
        acc = acc * val % F.p
        assert tile[i] == acc
    for r in range(W):
        acc = 1
        for s in range(S):
            acc = acc * v[r * S + s] % F.p
            assert runs[r, s] == acc
    with pytest.raises(ValueError):
        kmul.chain_cumprod(F, x, 5)
