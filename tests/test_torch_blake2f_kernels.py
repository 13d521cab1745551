"""Kernels 13 and 14 (the BLAKE2f witness, into the circuit's columns or
as a stream, and the batched compression) on the host:
``cuda/csrc/blake2f.cuh``, which the card's kernels include, built with
g++ and held cell for cell to the plain versions
(``circuit/blake2f._numeric_stream`` and the scatter,
``ops/blake2.blake2f``), to the JAX package and to the Python-int oracle;
the circuit's placement table against the layout's scatter; and the
wrappers on CPU tensors, which run the plain versions and count no launch.
The host build runs the card's chain code on a quad held in one object
(``QuadLanes``) where the card trades words by shuffles; the kernels'
thread split on the card is held to the same plain versions by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkodst_tpu.circuit import blake2f as jbc
from zkodst_tpu.ops import blake2 as jblake2
from zkodst_tpu_torch import kernels
from zkodst_tpu_torch.circuit import blake2f as tbc
from zkodst_tpu_torch.circuit.spread import spread_table
from zkodst_tpu_torch.kernels import blake2 as kblake2
from zkodst_tpu_torch.ops import blake2, u64

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zkodst_tpu_torch", "cuda", "csrc")

SHIM = r"""
#include "blake2f.cuh"
extern "C" {
long long cells(long long rounds) { return zkb::n_cells(rounds); }
// each instance through the host's form of the advice kernel
void place(const int64_t* h, const int64_t* m, const int64_t* t,
           const int64_t* f, const int32_t* slots, const int32_t* more,
           long long n_const, const int32_t* cdst, const int64_t* cval,
           int64_t* out, long long inst_rows, int64_t* pub, int64_t* hout,
           long long B, long long rounds) {
  for (long long b = 0; b < B; ++b)
    zkb::place_one(zkb::load_words(h + 16 * b, m + 32 * b, t + 4 * b, f[b]),
                   (int)rounds, slots, more, (int)n_const, cdst, cval, out,
                   b * inst_rows, pub ? pub + 2 * zkb::kPubRows * b : nullptr,
                   hout ? hout + 16 * b : nullptr);
}
void compress(const int64_t* h, const int64_t* m, const int64_t* t,
              const uint8_t* f, int64_t* hout, long long n,
              long long rounds) {
  for (long long i = 0; i < n; ++i)
    zkb::compress_one(h + 16 * i, m + 32 * i, t + 4 * i, f[i] != 0,
                      (uint64_t)rounds, hout + 16 * i);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the header")
    d = tmp_path_factory.mktemp("blake2f")
    src, so = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-I", CSRC, "-o", str(so), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib.cells.argtypes, lib.cells.restype = [LL], LL
    lib.place.argtypes = [P, P, P, P, P, P, LL, P, P, P, LL, P, P, LL, LL]
    lib.compress.argtypes = [P, P, P, P, P, LL, LL]
    return lib


def _words(rng, shape):
    """Random u64 words as int64 (lo, hi) pairs."""
    return rng.integers(0, 1 << 32, shape + (2,), dtype=np.int64)


def _inputs(seed, B, f):
    rng = np.random.default_rng(seed)
    return (_words(rng, (B, 8)), _words(rng, (B, 16)), _words(rng, (B, 2)),
            np.asarray(f, np.int64))


def _ptr(x):
    return None if x is None else x.ctypes.data


def _host_place(lib, h, m, t, f, rounds, slots, out, inst_rows, more=None,
                cdst=None, cval=None, pub=None, hout=None):
    h, m, t, f = (np.ascontiguousarray(x, np.int64) for x in (h, m, t, f))
    n_const = 0 if cdst is None else len(cdst)
    lib.place(h.ctypes.data, m.ctypes.data, t.ctypes.data, f.ctypes.data,
              _ptr(slots), _ptr(more), n_const, _ptr(cdst), _ptr(cval),
              out.ctypes.data, inst_rows, _ptr(pub), _ptr(hout), h.shape[0],
              rounds)


def _host_witness(lib, h, m, t, f, rounds):
    """The stream form: the identity placement, as the card runs it."""
    B, cells = h.shape[0], lib.cells(rounds)
    slots = np.full((cells, 4), -1, np.int32)
    slots[:, 0] = np.arange(cells)
    stream = np.zeros((B, cells, 2), np.int64)
    hout = np.zeros((B, 8, 2), np.int64)
    _host_place(lib, h, m, t, f, rounds, slots, stream, cells, hout=hout)
    return stream, hout


def _host_advice(lib, h, m, t, f, rounds, plan):
    """The advice form through the circuit's placement table, into zeroed
    columns (the memset's part on the card)."""
    cols = np.zeros((len(plan.columns) + 1, plan.n, 2), np.int64)
    const_val = np.ascontiguousarray(plan.const_val.numpy())
    _host_place(lib, h, m, t, f, rounds, plan.slots.numpy(), cols, plan.rows,
                more=plan.more.numpy(), cdst=plan.const_dst.numpy(),
                cval=const_val, pub=cols[-1])
    return cols


def _host_compress(lib, h, m, t, f, rounds):
    n = h.shape[0]
    hout = np.zeros((n, 8, 2), np.int64)
    h, m, t = (np.ascontiguousarray(x, np.int64) for x in (h, m, t))
    f = np.ascontiguousarray(f, np.uint8)
    lib.compress(h.ctypes.data, m.ctypes.data, t.ctypes.data, f.ctypes.data,
                 hout.ctypes.data, n, rounds)
    return hout


def _plain_stream(h, m, t, f, rounds):
    lo, hi, out = tbc._numeric_stream(
        *(torch.from_numpy(x) for x in (h, m, t, f)), rounds,
        torch.from_numpy(spread_table()))
    return torch.stack([lo, hi], dim=-1).numpy(), out.numpy()


# -- (a) the host build's witness stream against _numeric_stream -------------

@pytest.mark.parametrize("f", [0, 1], ids=["f0", "f1"])
@pytest.mark.parametrize("rounds", [0, 1, 2, 12])
def test_witness_stream_equals_plain(lib, rounds, f):
    """Every cell of three random instances (f the same in all three, as
    the parameter says) and h', at rounds 0, 1, 2 and 12."""
    h, m, t, fl = _inputs(100 + rounds, 3, [f] * 3)
    got, hout = _host_witness(lib, h, m, t, fl, rounds)
    want, wout = _plain_stream(h, m, t, fl, rounds)
    assert got.shape == want.shape == (3, kblake2.n_cells(rounds), 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hout, wout)


def test_witness_stream_mixed_flags_and_cell_counts(lib):
    """f = 0, 1, 0 in one batch; the stream's length is the layout's
    cell count (12,983 at 12 rounds) at every round count."""
    h, m, t, f = _inputs(7, 3, [0, 1, 0])
    got, hout = _host_witness(lib, h, m, t, f, 3)
    want, wout = _plain_stream(h, m, t, f, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hout, wout)
    for rounds in (0, 1, 12):
        lay = tbc._Layout()
        tbc._schedule(lay, rounds)
        assert lib.cells(rounds) == kblake2.n_cells(rounds) == lay.nidx
    assert kblake2.n_cells(12) == 12983


# -- (b) against the JAX package's stream -------------------------------------

@pytest.mark.parametrize("rounds", [0, 1])
def test_witness_stream_equals_jax(lib, rounds):
    h, m, t, f = _inputs(200 + rounds, 3, [1, 0, 1])
    got, hout = _host_witness(lib, h, m, t, f, rounds)
    stream, outs = jbc._numeric_stream(
        jnp.asarray(h.astype(np.uint32)), jnp.asarray(m.astype(np.uint32)),
        jnp.asarray(t.astype(np.uint32)), jnp.asarray(f.astype(bool)),
        rounds)
    np.testing.assert_array_equal(got, np.asarray(stream).astype(np.int64))
    np.testing.assert_array_equal(hout, np.asarray(outs).astype(np.int64))


# -- (b2) the advice form: the chain, the placing sink, the table ------------

_PLANS = {}


def _plan(rounds, n_inst=2):
    """The placement of a circuit at k = 17 (the smallest the spread table
    allows) as ``Blake2fCircuit`` builds it."""
    if rounds not in _PLANS:
        lay = tbc._Layout()
        tbc._schedule(lay, rounds)
        _PLANS[rounds] = (lay, tbc._placement(lay, 1 << 17, "cpu"))
    return _PLANS[rounds]


@pytest.mark.parametrize("rounds", [0, 1, 12])
def test_advice_equals_plain(lib, rounds):
    """The host build's chain inputs and placing sink, group by group as
    the card's blocks run them, against ``_numeric_stream`` plus the
    scatter: every advice column and the instance column of two instances,
    f mixed (rounds 12: the message words' placements past four)."""
    _, plan = _plan(rounds)
    h, m, t, f = _inputs(400 + rounds, 2, [1, 0])
    got = _host_advice(lib, h, m, t, f, rounds, plan)
    want = kblake2.blake2f_advice_plain(
        *(torch.from_numpy(x) for x in (h, m, t, f)), rounds, plan)
    assert got.shape == tuple(want.shape) == (15, 1 << 17, 2)
    np.testing.assert_array_equal(got, want.numpy())
    assert np.count_nonzero(got[:, 2 * plan.rows:]) == 0


def _table_dsts(plan, idx):
    """Cell idx's placements, read from the kernel's table."""
    slots, more = plan.slots.numpy(), plan.more.numpy()
    dsts = [int(d) for d in slots[idx, :3] if d >= 0]
    last = int(slots[idx, 3])
    if last >= 0:
        dsts.append(last)
    elif last <= -2:
        at = -2 - last
        while more[at] >= 0:
            dsts.append(int(more[at]))
            at += 1
    return dsts


def test_placement_table_reproduces_the_witness():
    """The kernel's table (four entries a cell, the lists past four, the
    constant cells), read in numpy, puts every stream cell of two
    instances where the layout's own scatter puts it — the witness as it
    was computed before the table: each placement (col, row, idx), each
    constant — and ``Blake2fCircuit.witness`` gives those columns and the
    instance block, at 12 rounds."""
    rounds, n, B = 12, 1 << 17, 2
    lay, plan = _plan(rounds)
    h, m, t, f = _inputs(500, B, [0, 1])
    stream, out = _plain_stream(h, m, t, f, rounds)
    want = {col: np.zeros((n, 2), np.int64) for col in tbc.ADVICE}
    for b in range(B):
        for col, row, idx in lay.place:
            want[col][b * lay.r + row] = stream[b, idx]
        for col, row, val in lay.consts:
            want[col][b * lay.r + row] = u64.from_ints([val])[0]
    flat = np.zeros((len(tbc.ADVICE) * n, 2), np.int64)
    for idx in range(plan.cells):
        for d in _table_dsts(plan, idx):
            for b in range(B):
                flat[d + b * plan.rows] = stream[b, idx]
    assert max(len(_table_dsts(plan, i)) for i in range(plan.cells)) == 12
    for b in range(B):
        flat[plan.const_dst.numpy() + b * plan.rows] = plan.const_val.numpy()
    cols = flat.reshape(len(tbc.ADVICE), n, 2)
    for j, col in enumerate(tbc.ADVICE):
        np.testing.assert_array_equal(cols[j], want[col], err_msg=col)
    circ = tbc.Blake2fCircuit(k=17, n_inst=B, rounds=rounds, device="cpu")
    adv, inst = circ.witness(h.astype(np.uint32), m.astype(np.uint32),
                             t.astype(np.uint32), f.astype(bool))
    assert list(adv) == tbc.ADVICE
    for col in tbc.ADVICE:
        np.testing.assert_array_equal(adv[col].numpy(), want[col],
                                      err_msg=col)
    pub = np.zeros((n, 2), np.int64)
    for b in range(B):
        block = np.concatenate([t[b], [[f[b], 0]], h[b], m[b], out[b]])
        pub[tbc.R_PUB * b:tbc.R_PUB * (b + 1)] = block
    np.testing.assert_array_equal(inst["pub"].numpy(), pub)


# -- (c) the host build's compression -----------------------------------------

def _digest(words) -> str:
    return b"".join(int(x).to_bytes(8, "little")
                    for x in u64.to_ints(words)).hex()


@pytest.mark.parametrize("n", [4, 5, 6, 7])
def test_compress_eip152_vectors(lib, n):
    """Appendix vectors 4–7: rounds 0, 12 (f true), 12 (f false), 1."""
    v = next(x for x in blake2.EIP152_VECTORS if x["n"] == n)
    rounds, h, m, t, f = blake2.eip152_decode(v["input"])
    out = _host_compress(lib, u64.from_ints(h)[None], u64.from_ints(m)[None],
                         u64.from_ints(t)[None], [f], rounds)
    assert _digest(out[0]) == v["expected"]
    assert [int(x) for x in u64.to_ints(out[0])] == \
        blake2.blake2f_py(h, m, t, f, rounds)


@pytest.mark.parametrize("rounds", [0, 1, 9, 10, 11, 12, 20, 23])
def test_compress_random_batch(lib, rounds):
    """64 random compressions, f random, against the plain version, the
    oracle and the JAX package; rounds across the kernel's blocks of
    ten."""
    rng = np.random.default_rng(300 + rounds)
    h, m, t = _words(rng, (64, 8)), _words(rng, (64, 16)), _words(rng, (64, 2))
    f = rng.integers(0, 2, 64).astype(bool)
    got = _host_compress(lib, h, m, t, f, rounds)
    plain = blake2.blake2f(*(torch.from_numpy(x) for x in (h, m, t, f)),
                           rounds)
    np.testing.assert_array_equal(got, plain.numpy())
    want = np.asarray(jblake2.blake2f(h.astype(np.uint32), m.astype(np.uint32),
                                      t.astype(np.uint32), f, rounds))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    hi, mi, ti = (u64.to_ints(x) for x in (h, m, t))
    for i in range(0, 64, 9):
        assert [int(x) for x in u64.to_ints(got[i])] == blake2.blake2f_py(
            list(hi[i]), list(mi[i]), tuple(ti[i]), bool(f[i]), rounds)


# -- (d) the wrappers on CPU tensors ------------------------------------------

def test_wrappers_run_the_plain_versions_on_the_cpu(lib):
    h, m, t, f = _inputs(9, 2, [1, 0])
    kernels.reset_counts()
    stream, out = kblake2.blake2f_witness(
        *(torch.from_numpy(x) for x in (h, m, t, f)), 2)
    want, wout = _plain_stream(h, m, t, f, 2)
    np.testing.assert_array_equal(stream.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), wout)
    _, plan = _plan(1)
    cols = kblake2.blake2f_advice(
        *(torch.from_numpy(x) for x in (h, m, t, f)), 1, plan)
    np.testing.assert_array_equal(cols.numpy(),
                                  _host_advice(lib, h, m, t, f, 1, plan))
    hh, mm, tt = (torch.from_numpy(x) for x in (h, m, t))
    ff = torch.from_numpy(f.astype(bool))
    got = kblake2.blake2f_compress(hh, mm, tt, ff, 12)
    assert torch.equal(got, blake2.blake2f(hh, mm, tt, ff, 12))
    np.testing.assert_array_equal(
        got.numpy(), _host_compress(lib, h, m, t, f, 12))
    assert kernels.blake2f_counts() == {"blake2f_advice": 0,
                                        "blake2f_witness": 0,
                                        "blake2f_compress": 0}
    assert sum(kernels.counts().values()) == 0


def test_circuit_witness_goes_through_the_wrapper(monkeypatch):
    """Blake2fCircuit.witness takes its columns from kernel 13's advice
    wrapper, once, with the circuit's placement."""
    seen = []
    real = kblake2.blake2f_advice

    def spy(*args):
        seen.append(args[-2:])
        return real(*args)

    monkeypatch.setattr(kblake2, "blake2f_advice", spy)
    circ = tbc.Blake2fCircuit(k=17, n_inst=1, rounds=1, device="cpu")
    h, m, t, f = _inputs(11, 1, [1])
    adv, inst = circ.witness(h.astype(np.uint32), m.astype(np.uint32),
                             t.astype(np.uint32), f.astype(bool))
    assert seen == [(1, circ.plan)]
    _, wout = _plain_stream(h, m, t, f, 1)
    np.testing.assert_array_equal(
        inst["pub"][tbc.ROW_OUT:tbc.ROW_OUT + 8].numpy(), wout[0])


def test_wrappers_reject_bad_input():
    h, m, t, f = (torch.from_numpy(x) for x in _inputs(1, 2, [0, 1]))
    with pytest.raises(ValueError, match="blake2f_witness"):
        kblake2.blake2f_witness(h[:, :7], m, t, f, 1)
    with pytest.raises(ValueError, match="blake2f_witness"):
        kblake2.blake2f_witness(h.to(torch.int32), m, t, f, 1)
    with pytest.raises(ValueError, match="rounds"):
        kblake2.blake2f_witness(h, m, t, f, -1)
    _, plan = _plan(1)
    with pytest.raises(ValueError, match="blake2f_advice"):
        kblake2.blake2f_advice(h, m, t, f, 2, plan)     # 1-round placement
    with pytest.raises(ValueError, match="blake2f_advice"):
        kblake2.blake2f_advice(h, m[:, :15], t, f, 1, plan)
    with pytest.raises(ValueError, match="blake2f_compress"):
        kblake2.blake2f_compress(h, m[:, :15], t, f)
    with pytest.raises(ValueError, match="rounds"):
        kblake2.blake2f_compress(h, m, t, f, 1 << 32)
