"""The port's command line, run configuration and metrics against the
JAX package's (following ``tests/test_cli.py``): ``vectors`` prints what
the reference prints, ``RunConfig`` reads ``DEGREE`` and rejects what the
reference rejects (IPA with a mesh), ``prove --mesh`` outside
``torch.distributed.run`` names the launch, the entry points default to
the card, and ``Metrics`` and
``profiler_trace`` behave as the reference's."""

import json
import os

import pytest
import torch

from zkodst_tpu import __main__ as jmain
from zkodst_tpu import config as jconfig
from zkodst_tpu.utils import timing as jtiming
from zkodst_tpu_torch import __main__ as tmain
from zkodst_tpu_torch.config import RunConfig
from zkodst_tpu_torch.utils import timing

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)


def test_vectors_command_prints_as_jax(capsys):
    assert tmain.main(["vectors", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jmain.main(["vectors"]) == 0
    assert got == capsys.readouterr().out
    assert "vector 5: ok" in got and "vector 3: ok (rejected)" in got
    for n in (4, 5, 6, 7):
        assert f"vector {n}: ok\n" in got


def test_runconfig_defaults_as_jax(monkeypatch):
    monkeypatch.setenv("DEGREE", "12")
    monkeypatch.setenv("ZKODST_BENCH_INSTANCES", "5")
    cfg, ref = RunConfig(), jconfig.RunConfig()
    assert (cfg.k, cfg.n_inst) == (ref.k, ref.n_inst) == (12, 5)
    for name in ("rounds", "commitment", "curve", "cache_dir", "seed",
                 "mesh_shape", "mesh_axes", "echo"):
        assert getattr(cfg, name) == getattr(ref, name), name
    assert cfg.device == "cuda"
    monkeypatch.delenv("DEGREE")
    assert RunConfig().k == 17


def test_runconfig_errors():
    assert RunConfig(commitment="ipa").commitment == "ipa"
    assert RunConfig(commitment="kzg").commitment == "kzg"
    with pytest.raises(ValueError, match="commitment"):
        RunConfig(commitment="fri")
    with pytest.raises(NotImplementedError, match="BN254|bn254|Pasta"):
        RunConfig(curve="pasta")
    with pytest.raises(NotImplementedError, match="IPA"):
        RunConfig(commitment="ipa", mesh_shape=(2,))
    with pytest.raises(RuntimeError, match="torch.distributed.run "
                       "--nproc-per-node 8 .* --mesh 2x4"):
        tmain.main(["prove", "--mesh", "2x4", "--device", "cpu"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    from zkodst_tpu_torch.circuit import mock

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(["vectors"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mock.check(None, {}, {})


def test_metrics_as_jax(capsys):
    got, ref = timing.Metrics(), jtiming.Metrics()
    for m in (got, ref):
        with m.phase("a"):
            pass
        with m.phase("a"):
            pass
        m.record("proof_bytes", 928)
    out = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in out] == \
        ["Start: [a", "End:   [a"] * 4
    assert got.seconds("a") == got.phases[-1].seconds
    assert got.seconds("b") is None and ref.seconds("b") is None
    a, b = json.loads(got.to_json()), json.loads(ref.to_json())
    assert a.keys() == b.keys() and a["proof_bytes"] == 928
    assert list(a["phases"]) == list(b["phases"]) == ["a"]
    quiet = timing.Metrics(echo=False)
    with quiet.phase("b"):
        pass
    assert capsys.readouterr().out == ""


def test_profiler_trace(tmp_path):
    with timing.profiler_trace(None):
        pass
    d = str(tmp_path / "trace")
    with timing.profiler_trace(d):
        torch.ones(8).sum()
    with open(os.path.join(d, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)
