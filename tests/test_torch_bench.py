"""The port's ``bench`` command (``zkodst_tpu_torch/bench.py``) on the CPU:
the witness stage against the JAX package's ``blake2f``, the golden and
mock checks of line 3 (the golden check against the root ``bench.py``'s),
and the staged-line contract of ``main`` with the prove stage's setup
replaced by a stand-in pipeline (a real prove at k = 17 runs only on the
card; its keygen takes hours on the CPU)."""

import importlib.util
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from zkodst_tpu.ops import blake2 as jblake2
from zkodst_tpu.ops import u64 as ju64
from zkodst_tpu_torch import __main__ as tmain
from zkodst_tpu_torch import api, bench
from zkodst_tpu_torch.circuit import blake2f as tbc
from zkodst_tpu_torch.ops import blake2, u64

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "golden",
                       "flagship_proof_v1.json")) as _fh:
    GOLDEN = json.load(_fh)
GOLDEN_PROOF = bytes.fromhex(GOLDEN["proof_hex"])
CPU = torch.device("cpu")


def _reference_bench():
    """The repository's root ``bench.py``, loaded by path as the JAX
    package's CLI loads it."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flipped(proof: bytes, at: int) -> bytes:
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


# -- line 1: the witness stage ------------------------------------------------

def test_witness_stage_equals_jax():
    line, out = bench.bench_witness(CPU, batch=64, iters=2, oracle_calls=2)
    v = jblake2.EIP152_VECTOR
    want = np.asarray(jblake2.blake2f(
        np.broadcast_to(ju64.from_ints(v["h"]), (64, 8, 2)),
        np.broadcast_to(ju64.from_ints(v["m"]), (64, 16, 2)),
        np.broadcast_to(ju64.from_ints(v["t"]), (64, 2, 2)),
        np.ones((64,), np.bool_), 12))
    assert out.shape == (64, 8, 2) and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), want.astype(np.int64))
    for row in out:
        got = b"".join(int(x).to_bytes(8, "little") for x in u64.to_ints(row))
        assert got.hex() == blake2.EIP152_VECTOR["expected"]
    assert line["metric"] == "blake2f_witness_throughput"
    assert line["unit"] == "compressions/s" and line["value"] > 0
    # no TPU figure: the oracle's multiple, and no card rate off the card
    assert "vs_baseline" not in line
    assert set(line["diag"]) == {"vs_python_oracle_x", "int32_util_pct",
                                 "device"}
    assert line["diag"]["vs_python_oracle_x"] > 0
    assert line["diag"]["int32_util_pct"] is None
    assert line["diag"]["device"] == "cpu"


# -- line 3's checks ----------------------------------------------------------

def test_flagship_golden_check_as_reference():
    ref = _reference_bench()
    for check in (bench._check_flagship_golden, ref._check_flagship_golden):
        assert check(GOLDEN_PROOF, 37) == "match"
        assert check(GOLDEN_PROOF, 5) == "skipped (n_inst=5)"
        with pytest.raises(AssertionError, match="diverged"):
            check(_flipped(GOLDEN_PROOF, 100), 37)


def test_golden_checks_without_fixture(monkeypatch, tmp_path):
    pipe = SimpleNamespace(n_inst=37)
    inputs = api.eip152_inputs(1)
    # the halo2ce fixture is not in the repository
    assert bench._check_halo2ce_golden(pipe, *inputs) == "no fixture"
    assert bench._check_halo2ce_golden(SimpleNamespace(n_inst=5),
                                       *inputs) == "skipped (n_inst=5)"
    monkeypatch.setattr(bench, "GOLDEN_DIR", str(tmp_path))
    assert bench._check_flagship_golden(GOLDEN_PROOF, 37) == "no fixture"


class _CircuitPipe:
    """What ``_flagship_circuit_check`` reads of a pipeline: the built
    circuit and its witness."""

    def __init__(self):
        self.built = tbc.Blake2fCircuit(k=17, n_inst=1, rounds=1,
                                        device="cpu")

    def witness(self, h, m, t, f):
        return self.built.witness(h, m, t, f)


def test_flagship_circuit_check_passes_and_catches_flip():
    # raises unless the honest witness passes and the flipped cell fails
    assert bench._flagship_circuit_check(
        _CircuitPipe(), *api.eip152_inputs(1)) >= 0


@pytest.mark.parametrize("verdicts,match", [
    ([["gate"], ["gate"]], "honest witness"),
    ([[], []], "MISSED a corrupted"),
])
def test_flagship_circuit_check_fails_loudly(monkeypatch, verdicts, match):
    seen = []

    def check(circ, adv, inst, dev):
        seen.append(adv)
        return verdicts[len(seen) - 1]

    monkeypatch.setattr(bench.mock, "check", check)
    pipe = SimpleNamespace(
        built=SimpleNamespace(circ=SimpleNamespace(advice_names=["a"]),
                              device=CPU),
        witness=lambda *x: ({"a": torch.tensor([[0, 0], [5, 0], [7, 0]])},
                            {}))
    with pytest.raises(AssertionError, match=match):
        bench._flagship_circuit_check(pipe, None, None, None, None)
    if len(seen) == 2:              # the middle nonzero cell, bit 0
        assert seen[1]["a"].tolist() == [[0, 0], [5, 0], [6, 0]]
        assert seen[0]["a"].tolist() == [[0, 0], [5, 0], [7, 0]]


def test_dp_scale_target_and_deadline(monkeypatch):
    pipe = _FakePipe(n_inst=37)
    far = time.monotonic() + 3600
    got = bench._dp_scale(pipe, 0.4, 5, 2.0, far)
    assert pipe.seeds == list(range(100, 123))          # 28 proofs − 5
    assert got["proofs"] == 28 and got["instances_total"] == 1036
    assert got["instances_per_s"] == 1036 / got["wall_s"]
    assert bench._dp_scale(pipe, 0.4, 5, 2.0, time.monotonic() + 10) == \
        {"skipped": "deadline (23 proves needed)"}
    monkeypatch.setenv("ZKODST_BENCH_SCALE_INSTANCES", "0")
    assert bench._dp_scale(pipe, 0.4, 5, 2.0, far) is None


# -- the staged lines of main -------------------------------------------------

class _FakePipe:
    """A pipeline whose seed-2 proof is the golden one (another seed's is
    not), that verifies everything and records its seeds and phases."""

    def __init__(self, n_inst=37, golden_seed=2):
        self.n_inst, self.golden_seed, self.seeds = n_inst, golden_seed, []
        self.metrics = SimpleNamespace(phases=[])

    def prove(self, h, m, t, f, seed=0, transcript_mode="v1"):
        self.seeds.append(seed)
        self.metrics.phases += [SimpleNamespace(label="prove.witness",
                                                seconds=0.1 + seed),
                                SimpleNamespace(label="prove", seconds=1.0)]
        proof = GOLDEN_PROOF if seed == self.golden_seed else b"\0" * 4480
        return proof, {}

    def verify(self, inst, proof, transcript_mode="v1"):
        return True


LINE1 = {"metric": "blake2f_witness_throughput", "value": 1.0,
         "unit": "compressions/s", "diag": {}}


@pytest.fixture
def staged(monkeypatch, capsys):
    """Run bench.main with the witness stage, the mock check and the setup
    stubbed: run(**_FakePipe kwargs) -> (exit code, the JSON lines)."""
    for var in ("ZKODST_BENCH_DEADLINE", "ZKODST_BENCH_INSTANCES",
                "ZKODST_BENCH_REPEATS", "ZKODST_BENCH_SCALE_INSTANCES",
                "ZKODST_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("ZKODST_BENCH", "prove")
    monkeypatch.setattr(bench, "bench_witness",
                        lambda dev: (dict(LINE1), None))
    monkeypatch.setattr(bench, "_flagship_circuit_check",
                        lambda *a: 0.25)
    made = []

    def setup(**kw):
        made.append(kw)
        return _FakePipe(n_inst=kw["n_inst"], **fake)

    fake = {}
    monkeypatch.setattr(bench.api, "setup_blake2f", setup)

    def run(**kw):
        fake.update(kw)
        rc = bench.main("cpu", "some/cache")
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()]
        assert made[-1]["cache_dir"] == "some/cache"
        return rc, lines
    return run


def test_main_prints_staged_lines(staged):
    rc, lines = staged()
    assert rc == 0 and len(lines) == 3
    assert lines[0] == LINE1
    two, three = lines[1], lines[2]
    assert two["metric"] == three["metric"] == "blake2f_prove_throughput"
    assert two["unit"] == "instances/s"
    d = three["diag"]
    assert d["timed_proves_s"] == two["diag"]["timed_proves_s"]
    assert len(d["timed_proves_s"]) == 5
    assert two["value"] == 37 / min(d["timed_proves_s"])
    assert d["median_prove_s"] == sorted(d["timed_proves_s"])[2]
    # the last timed prove's (seed 6) phases
    assert d["last_prove_phases_s"] == {"witness": 6.1}
    assert d["srs_cache_hit"] is False and d["instances_per_proof"] == 37
    assert d["flagship_golden"] == "match" and d["mock_check_s"] == 0.25
    assert d["halo2ce_golden"] == "no fixture"
    assert d["dp_scale"]["instances_total"] == 1036
    assert d["dp_scale"]["proofs"] == 28
    assert set(d["launches"]) == set(bench.kernels.WRAPPERS)
    for line in lines[1:]:
        assert "vs_baseline" not in line and "vpu_util_pct" not in json.dumps(
            line)
    assert set(two["diag"]) == {
        "instances_per_proof", "setup_s", "warmup_prove_s",
        "timed_proves_s", "median_prove_s", "verify_s", "srs_cache_hit",
        "last_prove_phases_s", "device"}


def test_stage3_failure_prints_and_exits_1(staged):
    rc, lines = staged(golden_seed=3)        # the seed-2 proof is wrong
    assert rc == 1 and len(lines) == 3
    assert lines[0] == LINE1
    fail = lines[2]["diag"]["stage3_failure"]
    assert fail.startswith("AssertionError: flagship proof diverged")
    assert "dp_scale" not in lines[2]["diag"]


def test_prove_failure_on_card_is_not_swallowed(monkeypatch, capsys):
    monkeypatch.delenv("ZKODST_BENCH", raising=False)     # auto
    monkeypatch.setattr(bench, "resolve", lambda d: torch.device("cuda"))
    monkeypatch.setattr(bench, "bench_witness",
                        lambda dev: (dict(LINE1), None))

    def setup(**kw):
        raise RuntimeError("setup failed on the card")

    monkeypatch.setattr(bench.api, "setup_blake2f", setup)
    with pytest.raises(RuntimeError, match="setup failed on the card"):
        bench.main()
    assert [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()] == [LINE1]


def test_cpu_runs_the_witness_stage_only(monkeypatch, capsys):
    monkeypatch.delenv("ZKODST_BENCH", raising=False)     # auto
    monkeypatch.setattr(bench, "bench_witness",
                        lambda dev: (dict(LINE1), None))
    monkeypatch.setattr(bench.api, "setup_blake2f", None)
    assert bench.main("cpu") == 0
    assert [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()] == [LINE1]


# -- the command line ---------------------------------------------------------

def test_cli_bench_witness_prints_one_line(monkeypatch, capsys):
    monkeypatch.setenv("ZKODST_BENCH", "witness")
    assert tmain.main(["bench", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "blake2f_witness_throughput"
    assert line["value"] > 0 and line["diag"]["device"] == "cpu"
    assert line["diag"]["int32_util_pct"] is None


def test_cli_bench_takes_device_and_cache_dir_only():
    with pytest.raises(SystemExit):
        tmain.main(["bench", "--device", "cpu", "--k", "5"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["bench"])
