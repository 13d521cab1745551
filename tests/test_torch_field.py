"""The port's field arithmetic (plain path) against the JAX reference and
the Python-int oracle. Exact equality: all arithmetic is exact."""

import jax
import numpy as np
import pytest
import torch

from zkodst_tpu.circuit import ir as jir
from zkodst_tpu.ops import field as jfield
from zkodst_tpu_torch.circuit import ir as tir
from zkodst_tpu_torch.ops import field as tfield

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

rng = np.random.default_rng(31)
PAIRS = [(jfield.FR, tfield.FR), (jfield.FQ, tfield.FQ)]


def _operands(F, n=64):
    a = [int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(n)]
    b = [int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(n)]
    edges = [0, 1, F.p - 1, F.r % F.p]
    a += edges + edges
    b += edges + edges[::-1]
    return a, b


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
@pytest.mark.parametrize("pair", PAIRS, ids=["fr", "fq"])
def test_ops_match_jax_and_ints(pair, op):
    JF, TF = pair
    a, b = _operands(JF)
    JA, JB = JF.from_ints(a), JF.from_ints(b)
    want = np.asarray(jax.jit(getattr(JF, op))(JA, JB))
    TA, TB = tfield.from_limbs16(JA), tfield.from_limbs16(JB)
    got = getattr(TF, op)(TA, TB)
    np.testing.assert_array_equal(tfield.to_limbs16(got), want)
    py = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    assert list(TF.to_ints(got)) == [py(x, y) % TF.p for x, y in zip(a, b)]


@pytest.mark.parametrize("pair", PAIRS, ids=["fr", "fq"])
def test_from_ints_and_limb_converters(pair):
    JF, TF = pair
    a, _ = _operands(JF, 32)
    t = TF.from_ints(a)
    np.testing.assert_array_equal(tfield.to_limbs16(t), JF.from_ints(a))
    assert torch.equal(tfield.from_limbs16(tfield.to_limbs16(t)), t)
    assert list(TF.to_ints(t)) == a
    assert list(TF.to_ints(TF.neg(t))) == [(-x) % TF.p for x in a]


@pytest.mark.parametrize("shape,const", [
    ((8,), True), ((3, 5, 8), False), ((1, 8), True), ((1, 5, 8), False)])
def test_mulmod_sees_a_broadcast_constant(shape, const):
    """The mulmod wrapper hands the kernel one element, not a copy, when
    the second operand is one value broadcast over the first."""
    from zkodst_tpu_torch.kernels.mulmod import _is_const

    b = torch.arange(8, dtype=torch.int32).expand(shape) if const else \
        torch.zeros(shape, dtype=torch.int32)
    a = torch.zeros((3, 5, 8), dtype=torch.int32)
    assert _is_const(torch.broadcast_tensors(a, b)[1]) is const


def test_u64_cols_to_field_matches_jax():
    cols = rng.integers(0, 1 << 32, size=(3, 40, 2), dtype=np.uint64)
    cols[0, :4] = [[0, 0], [1, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0, 1]]
    cols = cols.astype(np.uint32)
    want = np.asarray(jir.u64_cols_to_field(jfield.FR, cols))
    got = tir.u64_cols_to_field(tfield.FR,
                                torch.from_numpy(cols.astype(np.int64)))
    np.testing.assert_array_equal(tfield.to_limbs16(got), want)
