"""The harness without the card: the import check, the end-to-end metrics
on synthetic latencies, the refusal to run without a card, a dry run of a
whole cell through a stand-in for the program, and the faults that must
turn `correct` false."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from zkbench import harness
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


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    """A copy of the benchmark's files with three test-only mixes."""
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
