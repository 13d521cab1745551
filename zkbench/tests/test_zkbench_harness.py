"""The harness without the card: the import check, the end-to-end metrics
on synthetic latencies, the refusal to run without a card, the traffic's
draws, a dry run of a whole cell through a stand-in for the program (one
client in this process, or two in processes of their own), and the faults
that must turn `correct` false or end a run of clients."""

import hashlib
import json
import multiprocessing
import multiprocessing.resource_tracker
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from zkbench import clients, harness, trace, traffic
from zkbench.tests import fakes

REPO = fakes.REPO
BENCH = os.path.join(REPO, "zkbench")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    base = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zkodst_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "zkodst_tpu.ops.fake", object())
    assert "zkodst_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_the_benchmark_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import zkbench.harness, zkbench.system, zkbench.trace\n"
            "import zkbench.reference.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'zkodst_tpu'}))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import zkbench.reference.check, zkbench.reference.verify\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'zkodst_tpu', 'zkodst_tpu_torch', "
            "'torch'}))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_throughput_and_p90_see_one_stall():
    lat = [0.20 + 0.001 * (i % 17) for i in range(100)]
    base_tp = harness.throughput(37 * len(lat), sum(lat))
    base_p90 = harness.p90(lat)
    stalled = list(lat)
    stalled[10] = 2.0                 # one prove stalls for 2 s
    assert harness.throughput(37 * len(stalled), sum(stalled)) < base_tp
    assert harness.p90(stalled) > base_p90
    assert harness.p90(sorted(lat)) == pytest.approx(base_p90)


def test_run_without_a_card_fails_with_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "kzg-k17.full-random", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_run_in_a_bare_checkout_fails(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "zkbench/run.py", "--workload",
         "kzg-k17.full-random", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


def _eip152_words(half_other: bool = False):
    """Const words of 37 EIP-152 compressions (the golden proof's batch),
    or with the second half's h changed (a batch the golden proof does
    not prove)."""
    h = np.array([fakes.EIP152["h"]] * 37, np.uint64)
    if half_other:
        h[18:, 0] ^= np.uint64(1)
    return {"h": {"dist": "const", "value": [[int(x) for x in r]
                                             for r in h]},
            "m": {"dist": "const", "value": fakes.EIP152["m"]},
            "t0": {"dist": "const", "value": 3},
            "t1": {"dist": "const", "value": 0},
            "f": {"dist": "const", "value": 1}}


# the sha-256 of one-client draws (batches and blinding seeds) as the
# generator made them before it took more than one client
ONE_CLIENT_DRAWS = \
    "60b40c3ee45b6d6a23e281d47040ae5ae11c95896b590da687e3c507a9661d9e"
DRAW_SEEDS = (0, 1, 2147483731, (1 << 33) + 5, 6442450941)


def _draws_digest(**client) -> str:
    h = hashlib.sha256()
    for name in ("full-random", "single"):
        spec = traffic.load(BENCH, name)
        for seed in DRAW_SEEDS:
            for stream in (traffic.WARMUP, traffic.WINDOW):
                for i in range(0, 40, 3):
                    b = traffic.batch(spec, seed, stream, i, **client)
                    for a in (b.h, b.m, b.t, b.f):
                        h.update(a.tobytes())
                    h.update(harness.blind_seed(seed, stream, i, **client)
                             .to_bytes(8, "little"))
    return h.hexdigest()


@pytest.mark.parametrize("client", [{}, {"client": 0}])
def test_one_client_draws_what_it_drew_before(client):
    assert _draws_digest(**client) == ONE_CLIENT_DRAWS


def test_a_second_client_draws_other_batches_and_blinds():
    spec = traffic.load(BENCH, "full-2clients")
    assert spec["clients"] == 2
    for seed in DRAW_SEEDS:
        for stream in (traffic.WARMUP, traffic.WINDOW):
            for i in range(0, 40, 3):
                b0, b1 = (traffic.batch(spec, seed, stream, i, c)
                          for c in (0, 1))
                assert b0.h.shape == b1.h.shape == (37, 8)
                assert not np.array_equal(b0.h, b1.h)
                assert not np.array_equal(b0.m, b1.m)
                assert harness.blind_seed(seed, stream, i, 1) != \
                    harness.blind_seed(seed, stream, i)


def test_an_open_loop_is_refused(tmp_path):
    (tmp_path / "traffic").mkdir()
    with open(os.path.join(BENCH, "traffic", "full-random.json")) as fh:
        mix = json.load(fh)
    for name, change in (("open", {"loop": "open"}),
                         ("none", {"clients": 0})):
        (tmp_path / "traffic" / f"{name}.json").write_text(
            json.dumps({**mix, **change}))
        with pytest.raises(ValueError, match=r"open loop|clients"):
            traffic.load(str(tmp_path), name)


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    """A copy of the benchmark's files with four test-only mixes."""
    root = tmp_path_factory.mktemp("bench")
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), root / d)
    with open(os.path.join(BENCH, "traffic", "full-random.json")) as fh:
        mix = json.load(fh)
    for name, words in (("eip152-golden", _eip152_words()),
                        ("eip152-half", _eip152_words(True))):
        (root / "traffic" / f"{name}.json").write_text(
            json.dumps({**mix, "name": name, "words": words}))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    for t in ("eip152-golden", "eip152-half"):
        manifest["workloads"].append({"name": f"kzg-k17.{t}",
                                      "config": "kzg-k17", "traffic": t,
                                      "chips": 1, "why": "test only"})
        for m in manifest["per_layer"]:
            m["workloads"].append(f"kzg-k17.{t}")
    (root / "traffic" / "eip152-2clients.json").write_text(json.dumps(
        {**mix, "name": "eip152-2clients", "clients": 2,
         "words": _eip152_words()}))
    manifest["workloads"].append({"name": "kzg-k17.eip152-2clients",
                                  "config": "kzg-k17",
                                  "traffic": "eip152-2clients", "chips": 1,
                                  "why": "test only"})
    for m in manifest["per_layer"]:
        m["workloads"].append("kzg-k17.eip152-2clients")
    return str(root), manifest


def _run(bench_root, traffic, fault=None, trace=False, seed=2147483731):
    root, manifest = bench_root
    cell = harness.cell_of(manifest, f"kzg-k17.{traffic}", root)
    return harness.run_cell(cell, seed, 0.2, trace,
                            fakes.FakeSystem(fault), "cpu")


def test_dry_run_of_a_whole_cell(bench_root):
    out = _run(bench_root, "eip152-golden")
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 2 and out["sampled"] == min(
        8, out["attempted"])
    assert set(out["metrics"]) == {"prove_throughput", "prove_p90_s",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["checks"] == {"prove_errors": 0, "proofs_rejected": 0,
                             "pub_cells_differ": 0, "key_points_differ": 0}
    line = harness.checks_line(out["checks"])
    assert all(v["limit"] == 0 for v in line.values())


def test_dry_run_traced_reports_every_per_layer_metric(bench_root):
    out = _run(bench_root, "eip152-golden", trace=True, seed=7)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        names = {m["name"] for m in json.load(fh)["per_layer"]}
    assert set(out["metrics"]) == names
    assert out["metrics"]["device_idle_pct"]["value"] == pytest.approx(75.0)
    assert out["correct"] is True


@pytest.mark.parametrize("fault,traffic,number", [
    ("flip_proof", "eip152-golden", "proofs_rejected"),   # answer altered
    ("flip_pub", "eip152-golden", "pub_cells_differ"),    # witness altered
    (None, "full-random", "proofs_rejected"),             # state unchanged
    (None, "eip152-half", "proofs_rejected"),             # half the batch
])
def test_faults_turn_correct_false(bench_root, fault, traffic, number):
    out = _run(bench_root, traffic, fault)
    assert out["correct"] is False
    assert out["checks"][number] > 0


def _run_clients(bench_root, faults=(None, None), trace=False, seconds=0.5,
                 seed=2147483731):
    root, manifest = bench_root
    cell = harness.cell_of(manifest, "kzg-k17.eip152-2clients", root)
    factories = [clients.Factory("zkbench.tests.fakes", "FakeSystem",
                                 {"fault": f}) for f in faults]
    return clients.run_clients(cell, seed, seconds, trace, factories, "cpu",
                               os.path.join(root, "cache", "build.lock"))


def test_dry_run_of_two_clients(bench_root):
    """Two stand-ins in spawned processes: the pooled window's throughput
    and p90, both clients' proofs judged, the peaks summed."""
    out = _run_clients(bench_root)
    run = out["run"]
    assert out["correct"] is True and out["failed"] == 0
    assert len(run.clients) == 2
    assert all(c["proves"] >= 2 and c["judged"] >= 1 for c in run.clients)
    assert out["attempted"] == len(run.latencies) == sum(
        c["proves"] for c in run.clients)
    assert out["sampled"] == sum(c["judged"] for c in run.clients) == 8
    window = max(c["last"] for c in run.clients) - \
        min(c["first"] for c in run.clients)
    assert run.window_s == window
    assert run.instances == 37 * out["attempted"]
    assert out["metrics"]["prove_throughput"]["value"] == pytest.approx(
        37 * out["attempted"] / window)
    assert out["metrics"]["prove_p90_s"]["value"] == harness.p90(
        run.latencies)
    assert set(out["metrics"]) == {"prove_throughput", "prove_p90_s",
                                   "setup_s"}
    assert out["memory_peak_bytes"] == 2 * fakes.MEMORY_PEAK
    assert out["checks"] == {"prove_errors": 0, "proofs_rejected": 0,
                             "pub_cells_differ": 0, "key_points_differ": 0,
                             "clients_unjudged": 0}
    assert all(v["limit"] == 0 for v in harness.checks_line(
        out["checks"]).values())
    assert out["leaked"] == []
    assert not multiprocessing.active_children()
    tracker = multiprocessing.resource_tracker._resource_tracker
    assert not hasattr(tracker, "_stop") or tracker._pid is None


def test_dry_run_of_two_clients_traced(bench_root, monkeypatch):
    """Every per-layer metric reads the clients' pooled spans and
    counters; the traced window is the clients' common one, and the
    device's idle share counts both clients' intervals."""
    monkeypatch.setattr(clients, "TRACE_SECONDS", 0.3)
    out = _run_clients(bench_root, trace=True, seed=11)
    run, tr = out["run"], out["run"].trace
    assert out["correct"] is True
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        names = {m["name"] for m in json.load(fh)["per_layer"]}
    assert set(out["metrics"]) == names
    assert 0 < out["metrics"]["device_idle_pct"]["value"] < 75.0
    assert 0 < tr["window_s"] <= 0.3 and tr["lost"] == {}
    assert tr["proves"] >= 2
    assert sum(v for _, v in tr["device_ops"]) == pytest.approx(tr["busy_s"])
    assert tr["device_ops"][0][0] == "k"
    assert all(g[0].startswith("client 0: ") and " | client 1: " in g[0]
               for g in tr["idle_gaps"])
    m = {k: v["value"] for k, v in out["metrics"].items()}
    # two clients' counters summed: a prove's own counts, over both
    assert m["host_waits_per_prove"] == fakes.PROVE_COUNTERS["host_waits"]
    assert m["uploads_per_prove"] == fakes.PROVE_COUNTERS["uploads"]
    assert m["host_wait_ms"] == pytest.approx(
        1e3 * fakes.PROVE_COUNTERS["host_wait_s"])
    assert m["launches_per_prove"] == 3
    assert m["ntt_ms"] == pytest.approx(1e3 * fakes.NTT_DEVICE_S)
    assert m["msm_roofline_pct"] == pytest.approx(25.0)
    # every window prove of both clients carries its .ntt span
    assert len(run.ntt_proves) == out["attempted"]
    assert run.counters["proves"] == out["attempted"] + tr["proves"] \
        + 2 * harness.MSM_PROVES
    assert set(run.setup_phases) >= {"setup.params", "setup.keygen"}


def test_merge_splits_overlapping_kernels_and_counts_both_clients():
    """Two clients' kernels that the traces show overlapping share the
    overlap; the union is the card's busy time; a gap is labelled by both
    clients' spans."""
    a = {"open": 0.0, "until": 10.0, "lost": {}, "proves": 2,
         "counted": {"mulmod": 4}, "spans": [("prove.x", 0.0, 10.0)],
         "device": [(1.0, 4.0, "k1"), (6.0, 7.0, "k1")]}
    b = {"open": 0.5, "until": 9.0, "lost": {}, "proves": 1,
         "counted": {"mulmod": 2, "addmod": 1},
         "spans": [("prove.y", 0.0, 5.0)],
         "device": [(2.0, 5.0, "k2"), (8.5, 9.5, "k2")]}
    m = trace.merge([a, b])
    assert m["window_s"] == 8.5                       # 0.5 to 9.0
    assert m["busy_s"] == pytest.approx(4.0 + 1.0 + 0.5)
    ops = dict(m["device_ops"])
    assert ops["k1"] == pytest.approx(1.0 + 1.0 + 1.0)   # 1–2, half 2–4, 6–7
    assert ops["k2"] == pytest.approx(1.0 + 1.0 + 0.5)   # half 2–4, 4–5, 8.5–9
    assert sum(ops.values()) == pytest.approx(m["busy_s"])
    assert m["counted"] == {"mulmod": 6, "addmod": 1} and m["proves"] == 3
    gaps = dict(m["idle_gaps"])
    assert gaps["client 0: prove.x | client 1: host (no span)"] == \
        pytest.approx(1.0 + 1.5)                      # 5–6, 7–8.5
    assert gaps["client 0: prove.x | client 1: prove.y"] == \
        pytest.approx(0.5)                            # 0.5–1


@pytest.mark.parametrize("fault,number", [
    ("flip_proof", "proofs_rejected"),        # an answer altered
    ("flip_pub", "pub_cells_differ"),         # a witness altered
    ("other_key", "key_points_differ"),       # the second client's key
])
def test_a_fault_in_the_second_client_alone_turns_correct_false(
        bench_root, fault, number):
    out = _run_clients(bench_root, faults=(None, fault), seed=5)
    assert out["correct"] is False
    assert out["checks"][number] > 0
    assert out["run"].clients[1]["judged"] >= 1


@pytest.mark.parametrize("fault,said", [
    ("setup_raises", "raised"),
    ("exit_in_window", "ended with exit code"),
    ("hang_in_setup", "within"),
])
def test_a_failed_client_ends_the_run_with_no_result(bench_root, monkeypatch,
                                                     fault, said):
    monkeypatch.setattr(clients, "SETUP_TIMEOUT_S", 20.0)
    t0 = time.monotonic()
    with pytest.raises(clients.ClientFailed, match=said):
        _run_clients(bench_root, faults=(None, fault))
    assert time.monotonic() - t0 < 60
    assert not multiprocessing.active_children()
