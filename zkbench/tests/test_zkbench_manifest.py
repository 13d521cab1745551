"""BENCHMARK.json against the rules of its format, and the harness
finding a configuration, a traffic mix and a per-layer metric by name
alone."""

import json
import os
import re
import shutil

import pytest

from zkbench import harness, traffic

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "zkbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["zkbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    for word in manifest["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_a_full_check(manifest):
    """24 cells: 2 + 14·24 runs of run_seconds + 60 s, 2·90 s of compile a
    cell and 1200 s spare within 43,200 s."""
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200
    assert total <= 43200, total


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"] == f"zkbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(REPO, c["file"]))
        for key in c["reduced"]:
            assert NAME.match(key)
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in manifest["workloads"]} == \
        {c["name"] for c in manifest["configs"]}


def test_bounds(manifest):
    by = {m["name"]: m for m in manifest["end_to_end"]}
    assert by["setup_s"]["bound"] == 0.25
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_moves_names_an_end_to_end_metric_of_the_same_cells(manifest):
    cells = [w["name"] for w in manifest["workloads"]]

    def where(m):
        return set(m.get("workloads", cells))

    e2e = {m["name"]: where(m) for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e, m
        assert where(m) <= e2e[m["moves"]], m
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{m['name']}.py"))
    for c in cells:
        here = [n for n, w in e2e.items() if c in w]
        assert "setup_s" in here and len(here) >= 2
        assert any(c in where(m) for m in manifest["per_layer"])


def test_rooflines_are_percent(manifest):
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_added_files_are_found_by_name(manifest, tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each added as
    a new file beside the others plus an entry in a copy of the manifest,
    are found with no edit to a file that is there."""
    root = tmp_path / "zkbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), root / d)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "kzg-k17.json").read_text())
    cfg["name"] = "kzg-k17-seed7"
    cfg["srs_seed"] = 7
    (root / "configs" / "kzg-k17-seed7.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "full-random.json").read_text())
    mix["instances_per_proof"] = 9
    (root / "traffic" / "nine.json").write_text(json.dumps(mix))
    (root / "metrics" / "proves_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx['run'].latencies)\n")
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "kzg-k17-seed7", "source": "x",
                         "file": "zkbench/configs/kzg-k17-seed7.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "kzg-k17-seed7.nine",
                           "config": "kzg-k17-seed7", "traffic": "nine",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "proves_in_window", "unit": "proves",
                           "better": "higher", "source": "host_clock",
                           "layer": "window", "moves": "prove_throughput",
                           "workloads": ["kzg-k17-seed7.nine"]})
    cell = harness.cell_of(m, "kzg-k17-seed7.nine", str(root))
    assert cell.config["srs_seed"] == 7
    assert cell.traffic["instances_per_proof"] == 9
    assert "proves_in_window" in [x["name"] for x in cell.per_layer]
    run = harness.Run(latencies=[0.1, 0.2])
    assert harness.load_reader(str(root), "proves_in_window")(
        {"run": run, "cell": cell}) == 2
    b = traffic.batch(cell.traffic, 3, traffic.WINDOW, 0)
    assert b.h.shape == (9, 8) and b.t.shape == (9, 2)
    # the cells already there still read as they did
    other = harness.cell_of(m, "kzg-k17.full-random", str(root))
    assert "proves_in_window" not in [x["name"] for x in other.per_layer]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_every_cell_resolves(manifest):
    for w in manifest["workloads"]:
        cell = harness.cell_of(manifest, w["name"], BENCH)
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(harness.load_reader(BENCH, m["name"]))
