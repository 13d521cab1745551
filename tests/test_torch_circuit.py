"""The port's BLAKE2f circuit against the JAX package's: the host layout
(columns, copies, scatter plan, gate expressions) and the witness."""

import numpy as np
import pytest
import torch

from zkodst_tpu.circuit import blake2f as jbc
from zkodst_tpu.ops import u64 as ju64
from zkodst_tpu_torch import api
from zkodst_tpu_torch.circuit import blake2f as tbc
from zkodst_tpu_torch.ops import blake2, u64

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def circuits():
    return (jbc.Blake2fCircuit(k=17, n_inst=1, rounds=12),
            tbc.Blake2fCircuit(k=17, n_inst=1, rounds=12, device="cpu"))


def test_layout_equals_jax(circuits):
    jc, tc = circuits
    assert (tc.rows_per_inst, tc.ncells) == (jc.rows_per_inst, jc.ncells)
    J, T = jc.circ, tc.circ
    assert T.advice_names == J.advice_names
    assert T.instance_names == J.instance_names
    assert T.instance_len == J.instance_len
    assert sorted(T.fixed) == sorted(J.fixed)
    for name in J.fixed:
        np.testing.assert_array_equal(T.fixed[name], J.fixed[name])
    assert [(g.name, repr(g.poly)) for g in T.gates] \
        == [(g.name, repr(g.poly)) for g in J.gates]
    assert [(lk.name, list(lk.input_cols), list(lk.table_cols))
            for lk in T.lookups] \
        == [(lk.name, list(lk.input_cols), list(lk.table_cols))
            for lk in J.lookups]
    assert len(T.copies) == len(J.copies)
    for a, b in zip(T.copies, J.copies):
        assert (a.col_a, a.col_b) == (b.col_a, b.col_b)
        np.testing.assert_array_equal(a.rows_a, b.rows_a)
        np.testing.assert_array_equal(a.rows_b, b.rows_b)
    assert sorted(tc._scatter) == sorted(jc._scatter)
    for col, (rows, idxs) in jc._scatter.items():
        np.testing.assert_array_equal(tc._scatter[col][0].numpy(), rows)
        np.testing.assert_array_equal(tc._scatter[col][1].numpy(), idxs)


def test_witness_rounds12_equals_oracle(circuits):
    _, tc = circuits
    h, m, t, f = api.eip152_inputs(1)
    _, inst = tc.witness(h, m, t, f)
    pub = inst["pub"].numpy()
    outs = [int(x) for x in u64.to_ints(pub[tbc.ROW_OUT:tbc.ROW_OUT + 8])]
    v = blake2.EIP152_VECTOR
    assert outs == blake2.blake2f_py(list(v["h"]), list(v["m"]), v["t"],
                                     v["f"])
    assert b"".join(x.to_bytes(8, "little") for x in outs).hex() \
        == v["expected"]


def _random_inputs(n_inst, seed):
    r = np.random.default_rng(seed)
    h = r.integers(0, 1 << 32, (n_inst, 8, 2), dtype=np.uint64)
    m = r.integers(0, 1 << 32, (n_inst, 16, 2), dtype=np.uint64)
    t = r.integers(0, 1 << 32, (n_inst, 2, 2), dtype=np.uint64)
    f = r.integers(0, 2, n_inst).astype(bool)
    return (h.astype(np.uint32), m.astype(np.uint32), t.astype(np.uint32), f)


def _compare_with_jax(rounds, n_inst=2):
    inputs = _random_inputs(n_inst, 7 + rounds)
    jc = jbc.Blake2fCircuit(k=17, n_inst=n_inst, rounds=rounds)
    tc = tbc.Blake2fCircuit(k=17, n_inst=n_inst, rounds=rounds,
                            device="cpu")
    jadv, jinst = jc.witness(*inputs)
    tadv, tinst = tc.witness(*inputs)
    for name in jbc.ADVICE:
        np.testing.assert_array_equal(tadv[name].numpy(),
                                      np.asarray(jadv[name]), err_msg=name)
    np.testing.assert_array_equal(tinst["pub"].numpy(),
                                  np.asarray(jinst["pub"]))
    # and the outputs are F itself
    pub = tinst["pub"].numpy()
    h, m, t, f = inputs
    for i in range(n_inst):
        base = jbc.R_PUB * i + jbc.ROW_OUT
        want = blake2.blake2f_py(list(ju64.to_ints(h[i])),
                                 list(ju64.to_ints(m[i])),
                                 tuple(ju64.to_ints(t[i])), bool(f[i]),
                                 rounds)
        assert [int(x) for x in u64.to_ints(pub[base:base + 8])] == want


@pytest.mark.parametrize("rounds", [0, 1])
def test_witness_equals_jax(rounds):
    _compare_with_jax(rounds)


@pytest.mark.slow
def test_witness_equals_jax_rounds12():
    _compare_with_jax(12)
