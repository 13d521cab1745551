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


@pytest.mark.parametrize("F", [tfield.FR, tfield.FQ], ids=["fr", "fq"])
def test_chain_cumprod_reverse_twin(F):
    """With reverse, element e of run l is x[e] · … · x[(l+1)·S − 1]."""
    v = _vals(F.p, 48)
    W, S = 6, 8
    got = F.to_ints(kmul.chain_cumprod(F, F.from_ints(v), W, reverse=True))
    for r in range(W):
        acc = 1
        for s in reversed(range(S)):
            acc = acc * v[r * S + s] % F.p
            assert got[r * S + s] == acc


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("exclusive", [False, True], ids=["incl", "excl"])
@pytest.mark.parametrize("n,m,stride,offset", [
    (40, None, 1, 0),            # the whole column
    (48, 6, 8, 7),               # run totals of a forward chain (S = 8)
    (48, 6, 8, 0),               # run totals of a reversed chain
    (50, 7, 7, 3), (5, 1, 3, 4)])
def test_cumprod_tile_twin_strided(n, m, stride, offset, reverse, exclusive):
    """The m elements x[offset + i·stride], scanned either way, inclusive
    or exclusive, into a new tensor and into `out`, equal Python ints."""
    F = tfield.FQ
    v = _vals(F.p, n)
    x = F.from_ints(v)
    g = v[offset::stride][:n if m is None else m]
    order = list(reversed(range(len(g)))) if reverse else range(len(g))
    want, acc = [0] * len(g), 1
    for i in order:
        if exclusive:
            want[i] = acc
        acc = acc * g[i] % F.p
        if not exclusive:
            want[i] = acc
    kw = dict(m=m, stride=stride, offset=offset, reverse=reverse,
              exclusive=exclusive)
    assert list(F.to_ints(kmul.cumprod_tile(F, x, **kw))) == want
    out = torch.empty((len(g), 8), dtype=torch.int32)
    assert kmul.cumprod_tile(F, x, out=out, **kw) is out
    assert list(F.to_ints(out)) == want


def test_cumprod_tile_rejects_reads_past_the_column():
    x = tfield.FR.from_ints(_vals(tfield.FR.p, 48))
    for kw in (dict(m=7, stride=8, offset=0), dict(m=6, stride=8, offset=8),
               dict(m=3, stride=0), dict(m=49), dict(m=2, offset=-1)):
        with pytest.raises(ValueError):
            kmul.cumprod_tile(tfield.FR, x, **kw)


def test_cumprod_incl_pads_a_ragged_column_reverse():
    """The reverse case of test_cumprod_incl_pads_a_ragged_column: the
    column is padded with ones at its end and walked from there."""
    JF, TF = jfield.FR, tfield.FR
    v = _vals(TF.p, 50)
    a = JF.from_ints(v)
    want = np.asarray(jax.jit(lambda x: JF.cumprod_incl(x, reverse=True))(
        jnp.asarray(a)))
    got = TF.cumprod_incl(tfield.from_limbs16(a), reverse=True, W=8)
    np.testing.assert_array_equal(tfield.to_limbs16(got), want)
    acc, suf = 1, []
    for x in reversed(v):
        acc = acc * x % TF.p
        suf.append(acc)
    assert list(TF.to_ints(got)) == suf[::-1]


@pytest.mark.parametrize("n,W", [(64, 16), (50, 8), (16, 16)],
                         ids=["chained", "ragged", "tile"])
def test_inv_batch_chained_matches_jax(monkeypatch, n, W):
    """inv_batch above a small chain width W (kernels 4 → 5 → 1 on its
    buffers), on a column that is not a multiple of W, and at W."""
    monkeypatch.setattr(tfield, "CHAIN_W", W)
    JF, TF = jfield.FR, tfield.FR
    v = _vals(JF.p, n, nonzero=True)
    want = np.asarray(jax.jit(JF.inv_batch)(jnp.asarray(JF.from_ints(v))))
    got = TF.inv_batch(TF.from_ints(v))
    np.testing.assert_array_equal(tfield.to_limbs16(got), want)
    assert list(TF.to_ints(got)) == [pow(x, -1, TF.p) for x in v]


def test_mulmod_writes_into_out():
    F = tfield.FR
    a, b = F.from_ints(_vals(F.p, 12)), F.from_ints(_vals(F.p, 3))
    want = kmul.mulmod(F, a.view(3, 4, 8), b[:, None, :])
    out = torch.empty((3, 4, 8), dtype=torch.int32)
    assert F.mul(a.view(3, 4, 8), b[:, None, :], out=out) is out
    assert torch.equal(out, want)
