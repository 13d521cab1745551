"""Typed run configuration with environment defaults, as
``zkodst_tpu/config.py``, plus the device to run on.

The circuit degree defaults to the ``DEGREE`` environment variable (else
17) and the instance count to ``ZKODST_BENCH_INSTANCES`` (else 37);
``commitment`` is "kzg" or "ipa" (both over BN254: the whole pipeline on
Pasta is not the reference's either). ``mesh_shape`` runs the multi-GPU
prover over the job's ranks (:meth:`RunConfig.make_mesh`; KZG only, as
the reference's).
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
    mesh_shape: Optional[Tuple[int, ...]] = None   # e.g. (8,) or (2, 4)
    mesh_axes: Tuple[str, ...] = ("chip",)
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
        if self.commitment == "ipa" and self.mesh_shape is not None:
            raise NotImplementedError(
                "the IPA backend is single-device: use KZG for mesh runs")
        if self.mesh_shape is not None and len(self.mesh_shape) != len(
                self.mesh_axes):
            self.mesh_axes = tuple(
                f"ax{i}" for i in range(len(self.mesh_shape)))

    def make_mesh(self):
        """(the :class:`.parallel.bootstrap.Mesh` over the job's ranks, its
        axis), or (None, None) without a mesh shape. The process group
        must be up (``parallel.bootstrap.init_distributed``)."""
        if self.mesh_shape is None:
            return None, None
        from .parallel.bootstrap import make_mesh

        mesh = make_mesh(tuple(self.mesh_shape), tuple(self.mesh_axes))
        axis = (self.mesh_axes[0] if len(self.mesh_axes) == 1
                else tuple(self.mesh_axes))
        return mesh, axis
