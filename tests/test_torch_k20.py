"""The k = 20 deployment on the CPU: the BLAKE2f circuit's capacity at
2^20 rows (302 compressions, 303 refused) against the benchmark's plain
reference (``zkbench/reference/circuit.py``), its fixed columns cell for
cell, the benchmark's ``kzg-k20`` configuration and ``full-random-302``
traffic against that capacity, and the lookup tables' keys, which a
prove reads from the key's cache instead of uploading them each time
(at k = 20 each is a copy above ``timing.UPLOAD_MAX``)."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkbench import traffic
from zkbench.reference import circuit as refcircuit
from zkodst_tpu_torch import kernels
from zkodst_tpu_torch.circuit import blake2f as bc
from zkodst_tpu_torch.circuit.ir import BLINDING_ROWS, Lookup
from zkodst_tpu_torch.proof import prover
from zkodst_tpu_torch.utils import timing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "zkbench")
K, CAPACITY = 20, 302


def _load(*parts):
    with open(os.path.join(BENCH, *parts)) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def k20():
    return bc.Blake2fCircuit(k=K, n_inst=CAPACITY, rounds=12, device="cpu")


def test_k20_holds_302_compressions(k20):
    n = 1 << K
    assert k20.rows_per_inst == 3461
    assert (n - BLINDING_ROWS - 1) // k20.rows_per_inst == CAPACITY
    assert k20.circ.n == n
    assert k20.circ.instance_len == {"pub": bc.R_PUB * CAPACITY}
    assert refcircuit.build(K, CAPACITY, 12).usable == k20.circ.usable_rows


def test_k20_refuses_303_compressions():
    with pytest.raises(ValueError, match="at most 302 at k = 20"):
        bc.Blake2fCircuit(k=K, n_inst=CAPACITY + 1, rounds=12, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        refcircuit.build(K, CAPACITY + 1, 12)


def test_k20_fixed_columns_equal_the_reference(k20):
    ref = refcircuit.build(K, CAPACITY, 12)
    assert set(ref.fixed) == set(k20.circ.fixed)
    for name, col in k20.circ.fixed.items():
        words = col[:, 0].astype(np.uint64) | (col[:, 1].astype(np.uint64)
                                              << np.uint64(32))
        assert np.array_equal(words, ref.fixed[name]), name


def test_k20_copies_equal_the_reference(k20):
    ref = refcircuit.build(K, CAPACITY, 12)
    ours = sorted((g.col_a, int(ra), g.col_b, int(rb))
                  for g in k20.circ.copies
                  for ra, rb in zip(g.rows_a, g.rows_b))
    theirs = sorted((ca, ra, cb, rb) for (ca, ra), (cb, rb) in ref.copies)
    assert ours == theirs


def test_kzg_k20_config_and_traffic_fill_the_circuit():
    cfg = _load("configs", "kzg-k20.json")
    k17 = _load("configs", "kzg-k17.json")
    assert cfg["k"] == K
    assert {k: v for k, v in cfg.items() if k not in ("name", "source",
                                                       "k", "assumed")} \
        == {k: v for k, v in k17.items() if k not in ("name", "source",
                                                       "k", "assumed")}
    mix = traffic.load(BENCH, "full-random-302")
    full = traffic.load(BENCH, "full-random")
    assert mix["instances_per_proof"] == CAPACITY
    assert mix["words"] == full["words"]
    assert (mix["loop"], mix["clients"], mix["warmup_proves"]) == \
        ("closed", 1, 2)
    b = traffic.batch(mix, (1 << 33) + 5, traffic.WINDOW, 3)
    assert b.h.shape == (CAPACITY, 8) and b.m.shape == (CAPACITY, 16)
    assert b.t.shape == (CAPACITY, 2) and not b.t[:, 1].any()
    manifest = _load("..", "BENCHMARK.json")
    cell = next(w for w in manifest["workloads"]
                if w["name"] == "kzg-k20.full-random-302")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("kzg-k20", "full-random-302", 1)


def _pk(fixed, lookups, device="cpu"):
    """A stand-in proving key: what :func:`prover.table_keys` reads."""
    circ = SimpleNamespace(fixed=fixed, lookups=lookups)
    return SimpleNamespace(vk=SimpleNamespace(circ=circ), prover_cache={},
                           roots=torch.zeros((1, 8), dtype=torch.int32,
                                             device=device))


def test_table_keys_above_upload_max_are_uploaded_once_per_key():
    """At k = 20 a table column is 16 MiB: one synchronous copy (a host
    wait) when the key's cache is filled, none at later proves; the key is
    the low word of the table's first column, as the sort read it."""
    n = 1 << K
    rng = np.random.default_rng(20)
    tab = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    other = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64) \
        .astype(np.uint32)
    assert tab.astype(np.int64).nbytes > timing.UPLOAD_MAX
    pk = _pk({"td": tab, "ts": other},
             [Lookup("la", ["a", "b"], ["td", "ts"]),
              Lookup("lb", ["c", "d"], ["td", "ts"])])
    kernels.reset_counts()
    keys = prover.table_keys(pk)
    assert set(keys) == {"td"}
    assert timing.COUNTERS["host_waits"] == 1
    assert timing.COUNTERS["uploads"] == 0
    got = keys["td"].to(torch.int64) & 0xFFFFFFFF
    assert np.array_equal(got.numpy(), tab[:, 0].astype(np.int64))
    assert prover.table_keys(pk) is keys
    assert timing.COUNTERS["host_waits"] == 1
    kernels.reset_counts()


def test_table_keys_sort_as_the_per_prove_upload_did():
    """The lookup sort's permutations from the cached key equal those from
    the column uploaded at the prove, as before."""
    n = 1 << 10
    rng = np.random.default_rng(21)
    tab = np.zeros((n, 2), np.uint32)
    tab[:, 0] = rng.integers(0, 64, n)
    tab[:, 1] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    inp = torch.from_numpy(tab[rng.integers(0, n, n)].astype(np.int64))
    pk = _pk({"t": tab}, [Lookup("l", ["a"], ["t"])])
    u = n - BLINDING_ROWS - 1
    want = prover._lookup_perm_indices(
        inp[:, 0], prover._u64_tensor(tab, "cpu")[:, 0], u)
    got = prover._lookup_perm_indices(inp[:, 0],
                                      prover.table_keys(pk)["t"], u)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
