"""Typed run configuration with environment defaults, as
``zkodst_tpu/config.py``, plus the device to run on.

The circuit degree defaults to the ``DEGREE`` environment variable (else
17) and the instance count to ``ZKODST_BENCH_INSTANCES`` (else 37);
``commitment`` is "kzg" or "ipa" (both over BN254: the whole pipeline on
Pasta is not the reference's either). The multi-GPU prover is not ported
yet (ROADMAP §1 item 9), so a mesh shape raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclass
class RunConfig:
    """Everything a prover run needs, in one place."""

    k: int = field(default_factory=lambda: _env_int("DEGREE", 17))
    n_inst: int = field(
        default_factory=lambda: _env_int("ZKODST_BENCH_INSTANCES", 37))
    rounds: int = 12
    commitment: str = "kzg"          # KZG/BN254 + SHPLONK, or "ipa"
    curve: str = "bn254"
    cache_dir: Optional[str] = ".zkodst_cache"
    seed: Optional[int] = None       # None: blinds from OS entropy
    mesh_shape: Optional[Tuple[int, ...]] = None
    echo: bool = True                # phase-timer prints
    device: str = "cuda"

    def __post_init__(self):
        if self.commitment not in ("kzg", "ipa"):
            raise ValueError(
                f"unknown commitment scheme {self.commitment!r}: the two "
                "backends are 'kzg' (KZG/BN254 + SHPLONK) and 'ipa' "
                "(transparent IPA)")
        if self.curve != "bn254":
            raise NotImplementedError(
                "the pipeline runs on BN254 (Pasta runs at the commitment "
                "level: proof/ipa.py with curve_name='pasta')")
        if self.mesh_shape is not None:
            raise NotImplementedError(
                "the multi-GPU prover is not ported yet (ROADMAP §1 item "
                "9): run without a mesh shape")
