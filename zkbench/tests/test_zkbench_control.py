"""The control, on the card: the program made to prove 11 rounds where the
configuration states 12 (the EIP-152 guarantee it breaks), at the cell's
own size, through the whole run. Its `correct` has to come out false,
and the same run as the configuration states it true.

Run on a machine with the card, from the repository's root:
``python -m pytest zkbench/tests/test_zkbench_control.py``."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark runs only on the "
                    "card)")


def _run(workload, seed, control=None):
    cmd = [sys.executable, "zkbench/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", "3", "--trace", "0"]
    if control:
        cmd += ["--control", control]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["kzg-k17.full-random",
                                      "ipa-k17.full-random",
                                      "kzg-k17.single"])
def test_control_fails_and_the_program_passes(card, workload):
    bad = _run(workload, 2147483801, "rounds=11")
    assert bad["correct"] is False
    assert bad["checks"]["proofs_rejected"]["value"] > 0
    good = _run(workload, 2147483802)
    assert good["correct"] is True
