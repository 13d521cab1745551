"""The port's mock checker and the IR helpers it needs, against the JAX
package's on the same inputs: ``eval_expr`` on random columns,
``column_kind``, ``max_gate_degree`` and ``validate`` (with the error it
raises), and whole failure lists (kind, name, rows, text, order) on the toy
circuit of ``tests/test_circuit_ir.py``, the rich circuit of
``tests/test_torch_prover.py`` and the BLAKE2f circuit at k = 17 (one
round, one instance). The JAX gate checker at k = 17 takes about a minute
a witness on the CPU, so its BLAKE2f lists are pinned here and recomputed
by the `heavy` test; ``test_torch_mock_cells.py`` and
``test_torch_mock_words.py`` hold the witnesses with one cell flipped in
an advice column."""

import numpy as np
import pytest
import torch

import test_circuit_ir as jtoy
from test_torch_prover import _rich
from zkodst_tpu.circuit import expr as jexpr
from zkodst_tpu.circuit import ir as jir
from zkodst_tpu.circuit import mock as jmock
from zkodst_tpu.ops import field as jfield
from zkodst_tpu_torch.circuit import blake2f as tbc
from zkodst_tpu_torch.circuit import expr as texpr
from zkodst_tpu_torch.circuit import ir as tir
from zkodst_tpu_torch.circuit import mock
from zkodst_tpu_torch.ops import field as tfield
from zkodst_tpu_torch.ops import u64

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

# The JAX package's mock.check on the EIP-152 witness of
# Blake2fCircuit(k=17, n_inst=1, rounds=1): with bit 0 of the middle
# nonzero cell of an advice column flipped (column: (row, failures)), and
# with bit 0 of the first output word in `pub` flipped. A failure is
# (kind, name, rows).
BLAKE2F_CELLS = {
    "d1": (194, [("gate", "add.limbs", [194]), ("lookup", "l16b", [194])]),
    "s1": (194, [("lookup", "l16b", [194]), ("copy", "cb<->s1", [197, 328])]),
    "w": (167, [("gate", "dec", [167]), ("copy", "w<->w", [167])]),
    "ca": (215, [("gate", "xor", [215]), ("copy", "ca<->s0", [215])]),
    "ce": (204, [("gate", "add.sum", [204])]),
}
BLAKE2F_PUB = [("copy", "pub<->w", [27])]


def _port_list(fails):
    return [(f.kind, f.name, [int(r) for r in f.rows]) for f in fails]


def assert_same_failures(port, ref):
    """Equal failure lists: kind, name, rows and text, in order."""
    assert _port_list(port) == _port_list(ref)
    assert [str(f) for f in port] == [str(f) for f in ref]


# -- eval_expr and the IR helpers --------------------------------------------

def _random_field(rng, shape):
    vals = [int.from_bytes(rng.bytes(40), "little") % tfield.FR.p
            for _ in range(int(np.prod(shape)))]
    return np.asarray(vals, dtype=object).reshape(shape)


def _exprs(ex):
    V, Const = ex.V, ex.Const
    return [
        V("a") * V("b", 1) - 3 * V("c", -2) + Const((1 << 64) - 1),
        (V("a") - V("b")) * (V("a") - V("b")) * V("c", 3),
        -(V("c") + 7) * (V("a", -1) * V("a", -1) - V("b")),
        V("a") * 0 + Const(tfield.FR.p - 1) * V("b"),
        Const(5) * Const(7) - V("c", 1),
    ]


def test_eval_expr_equals_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n = 16
    vals = {c: _random_field(rng, (n,)) for c in "abc"}
    tcols = {c: tfield.FR.from_ints(v) for c, v in vals.items()}
    jcols = {c: jnp.asarray(jfield.FR.from_ints(v)) for c, v in vals.items()}
    tcache, jcache = {}, {}
    for te, je in zip(_exprs(texpr), _exprs(jexpr)):
        assert repr(te) == repr(je)
        got = texpr.eval_expr(
            te, tfield.FR,
            lambda c, r: torch.roll(tcols[c], -r, 0), "cpu", tcache)
        want = jexpr.eval_expr(
            je, jfield.FR,
            lambda c, r: jnp.roll(jcols[c], -r, axis=0), jcache)
        assert got.shape == (n, 8)
        np.testing.assert_array_equal(tfield.to_limbs16(got),
                                      np.asarray(want))
    # shared subtrees are evaluated once and kept in the cache
    assert len(tcache) == len(jcache)


def test_ir_helpers_equal_jax():
    tcirc = _rich(tir, texpr)[0]
    jcirc = _rich(jir, jexpr)[0]
    for name in ("a", "pub", "q", "cst"):
        assert tcirc.column_kind(name) == jcirc.column_kind(name)
    with pytest.raises(KeyError):
        tcirc.column_kind("nope")
    assert tcirc.max_gate_degree() == jcirc.max_gate_degree() == 3
    assert tir.CircuitDef(k=5, advice_names=[], instance_names=[],
                          fixed={}).max_gate_degree() == 0
    built = tbc.Blake2fCircuit(k=17, n_inst=1, rounds=1, device="cpu")
    assert built.circ.max_gate_degree() == 4


def _unfunctional(ir):
    n = 32
    fixed = {"q": np.zeros((n, 2), np.uint32),
             "td": jtoy._u64col([0, 1, 1, 2]),     # key 1 twice …
             "ts": jtoy._u64col([0, 5, 6, 7])}     # … with two values
    return ir.CircuitDef(
        k=5, advice_names=["a", "b"], instance_names=[], fixed=fixed,
        lookups=[ir.Lookup("bad", ["a", "b"], ["td", "ts"])])


def test_validate_raises_as_jax():
    with pytest.raises(AssertionError) as jerr:
        _unfunctional(jir).validate()
    with pytest.raises(AssertionError, match="not a function") as terr:
        _unfunctional(tir).validate()
    assert str(terr.value) == str(jerr.value)
    ok = _unfunctional(tir)
    ok.fixed["ts"] = jtoy._u64col([0, 5, 5, 7])
    ok.validate()
    bad = _rich(tir, texpr)[0]
    bad.instance_len = {"pub": bad.usable_rows + 1}
    with pytest.raises(AssertionError):
        bad.validate()


# -- failure lists on the toy and rich circuits ------------------------------

def _toy_cases():
    """(name, witness) in the reference's numpy layout, as the cases of
    tests/test_circuit_ir.py."""
    good = jtoy.good_witness()
    gate = jtoy.good_witness()
    gate["b"][3] = u64.from_int(999)
    unselected = jtoy.good_witness()
    unselected["b"][20] = u64.from_int(12345)
    lookup = jtoy.good_witness()
    lookup["a"][9] = u64.from_int(16)
    lookup["b"][9] = u64.from_int(256)
    copy = jtoy.good_witness()
    copy["b"][2] = u64.from_int(1 + int(u64.to_ints(copy["b"][1])))
    copy["a"][2] = u64.from_int(0)
    return [("good", good), ("gate", gate), ("unselected", unselected),
            ("lookup", lookup), ("copy", copy)]


def _toy_port_circuit():
    V = texpr.V
    sel = np.zeros((jtoy.N, 2), np.uint32)
    sel[:8, 0] = 1
    circ = tir.CircuitDef(
        k=jtoy.K, advice_names=["a", "b"], instance_names=[],
        fixed={"q": sel, "t": jtoy._u64col(range(16))},
        gates=[tir.Gate("square", V("q") * (V("a") * V("a") - V("b")))],
        lookups=[tir.Lookup("a_range", ["a"], ["t"])],
        copies=[tir.CopyGroup("b", np.array([1]), "b", np.array([2]))])
    circ.validate()
    return circ


def test_toy_failures_equal_jax():
    tcirc, jcirc = _toy_port_circuit(), jtoy.toy_circuit()
    kinds = {}
    for name, wit in _toy_cases():
        ref = jmock.check(jcirc, wit, {})
        port = mock.check(tcirc, wit, {}, device="cpu")
        assert_same_failures(port, ref)
        # the same witness as (n, 2) int64 tensors, as the port's witness
        tens = {c: torch.from_numpy(v.astype(np.int64))
                for c, v in wit.items()}
        assert_same_failures(mock.check(tcirc, tens, {}, device="cpu"), ref)
        kinds[name] = [f.kind for f in port]
    assert kinds["good"] == [] and "gate" not in kinds["unselected"]
    assert "gate" in kinds["gate"] and "lookup" in kinds["lookup"]
    assert "copy" in kinds["copy"]


def test_shape_failures_equal_jax():
    tcirc, jcirc = _toy_port_circuit(), jtoy.toy_circuit()
    wit = jtoy.good_witness()
    short = {"a": wit["a"][:-1], "b": wit["b"]}
    missing = {"b": wit["b"]}
    for case in (short, missing):
        assert_same_failures(mock.check(tcirc, case, {}, device="cpu"),
                             jmock.check(jcirc, case, {}))
    assert [f.kind for f in mock.check(tcirc, missing, {},
                                       device="cpu")] == ["shape"]


@pytest.mark.parametrize("satisfied", [False, True])
def test_rich_failures_equal_jax(satisfied):
    tcirc, adv, inst = _rich(tir, texpr, satisfied)
    jcirc, _, _ = _rich(jir, jexpr, satisfied)
    port = mock.check(tcirc, adv, inst, device="cpu")
    assert_same_failures(port, jmock.check(jcirc, adv, inst))
    assert _port_list(port) == ([] if satisfied
                                else [("copy", "b<->b", [1])])


def test_check_or_raise_message_equals_jax():
    tcirc, jcirc = _toy_port_circuit(), jtoy.toy_circuit()
    wit = dict(_toy_cases())["copy"]
    with pytest.raises(AssertionError) as jerr:
        jmock.check_or_raise(jcirc, wit, {})
    with pytest.raises(AssertionError) as terr:
        mock.check_or_raise(tcirc, wit, {}, device="cpu")
    assert str(terr.value) == str(jerr.value)
    mock.check_or_raise(tcirc, jtoy.good_witness(), {}, device="cpu")


# -- the BLAKE2f circuit at k = 17 --------------------------------------------

def blake2f_witness():
    """The port's Blake2fCircuit(k=17, n_inst=1, rounds=1) and its
    EIP-152 witness on the CPU."""
    from zkodst_tpu_torch import api

    built = tbc.Blake2fCircuit(k=17, n_inst=1, rounds=1, device="cpu")
    adv, inst = built.witness(*api.eip152_inputs(1))
    return built, adv, inst


def flip_cell(adv, col):
    """A copy of `adv` with bit 0 of the middle nonzero cell of `col`
    flipped (the rule of tests/test_blake2f_circuit.py); returns (row,
    witness)."""
    rows = torch.nonzero(adv[col][:, 0]).flatten()
    row = int(rows[len(rows) // 2])
    bad = {c: a.clone() for c, a in adv.items()}
    bad[col][row, 0] ^= 1
    return row, bad


def check_blake2f_cell(col):
    built, adv, inst = blake2f_witness()
    row, bad = flip_cell(adv, col)
    want_row, want = BLAKE2F_CELLS[col]
    assert row == want_row
    assert _port_list(mock.check(built.circ, bad, inst, device="cpu")) \
        == [(k, nm, rows) for k, nm, rows in want]


@pytest.fixture(scope="module")
def blake2f():
    return blake2f_witness()


def test_blake2f_witness_satisfies_circuit(blake2f):
    built, adv, inst = blake2f
    assert mock.check(built.circ, adv, inst, device="cpu") == []


def test_blake2f_wrong_public_output_fails_copy(blake2f):
    built, adv, inst = blake2f
    pub = inst["pub"].clone()
    pub[tbc.ROW_OUT, 0] ^= 1
    fails = mock.check(built.circ, adv, {"pub": pub}, device="cpu")
    assert _port_list(fails) == BLAKE2F_PUB
    assert str(fails[0]) == "copy 'pub<->w' violated at rows [27] (1 rows)"


@pytest.mark.heavy
def test_blake2f_pins_are_jax_lists():
    """BLAKE2F_CELLS and BLAKE2F_PUB are the JAX package's mock.check on
    the JAX witness (the witnesses are equal: test_torch_circuit.py)."""
    from zkodst_tpu.circuit import blake2f as jbc
    from zkodst_tpu.ops import blake2 as jblake2
    from zkodst_tpu.ops import u64 as ju64

    built = jbc.Blake2fCircuit(k=17, n_inst=1, rounds=1)
    v = jblake2.EIP152_VECTOR
    adv, inst = built.witness(ju64.from_ints(v["h"])[None],
                              ju64.from_ints(v["m"])[None],
                              ju64.from_ints(v["t"])[None],
                              np.array([v["f"]], bool))
    adv = {k: np.asarray(a) for k, a in adv.items()}
    inst = {k: np.asarray(a) for k, a in inst.items()}
    assert jmock.check(built.circ, adv, inst) == []
    for col, (want_row, want) in BLAKE2F_CELLS.items():
        rows = np.nonzero(adv[col][:, 0])[0]
        row = int(rows[len(rows) // 2])
        assert row == want_row
        bad = {k: a.copy() for k, a in adv.items()}
        bad[col][row, 0] ^= 1
        assert _port_list(jmock.check(built.circ, bad, inst)) == want
    pub = {"pub": inst["pub"].copy()}
    pub["pub"][jbc.ROW_OUT, 0] ^= 1
    assert _port_list(jmock.check(built.circ, adv, pub)) == BLAKE2F_PUB
