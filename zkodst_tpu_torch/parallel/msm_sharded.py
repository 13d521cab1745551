"""Sharded MSM: the points split over the mesh, one Pippenger per rank.

Counterpart of ``zkodst_tpu/parallel/msm_sharded.py`` (:1-124): each
rank runs the port's batched Pippenger (``ops.msm.msm_many``, kernels
8–12) on its block of the points and scalars, the B partial points are
all-gathered (D·B points), and every rank adds them by the reference's
pairwise-halving tree (kernel 8), an odd count padded with the identity.
Point addition is not a sum the collectives can reduce, but D is small.
The reference's ``small=`` flag is a workaround for XLA's compile time and
has no counterpart.
"""

from __future__ import annotations

import torch

from ..ops import curve, msm
from .bootstrap import AxisName, Mesh


def _tree_add(parts: torch.Tensor) -> torch.Tensor:
    """(D, …, 3, 8) projective points -> their sum (…, 3, 8): pairwise
    halving, an odd level padded with the identity."""
    while parts.shape[0] > 1:
        if parts.shape[0] % 2:
            parts = torch.cat([parts, curve.identity(
                parts.shape[1:-2], parts.device)[None]])
        parts = curve.add(parts[0::2], parts[1::2])
    return parts[0]


def msm_many_sharded(points: torch.Tensor, scalars: torch.Tensor,
                     mesh: Mesh, axis: AxisName = "x",
                     c: int = 8) -> torch.Tensor:
    """B MSMs over the same points, the point axis sharded over `axis`.

    points (N, 3, 8) projective and scalars (B, N, 8) normal-form limbs,
    both replicated; D must divide N. Returns (B, 3, 8), replicated."""
    part = msm.msm_many(mesh.shard(points, axis),
                        mesh.shard(scalars, axis, dim=1), c)
    return _tree_add(mesh.all_gather(part, axis))


def msm_sharded(points: torch.Tensor, scalars: torch.Tensor, mesh: Mesh,
                axis: AxisName = "x", c: int = 8) -> torch.Tensor:
    """Σ_i scalars[i]·points[i] with the i axis sharded over `axis`:
    (N, 3, 8), (N, 8) normal form -> (3, 8), replicated."""
    return msm_many_sharded(points, scalars[None], mesh, axis, c)[0]


def msm_many_sharded_mont(points: torch.Tensor, mont_batch: torch.Tensor,
                          mesh: Mesh, axis: AxisName = "x",
                          c: int = 8) -> torch.Tensor:
    """:func:`msm_many_sharded` with Fr Montgomery scalars, each rank
    converting only its block."""
    part = msm.msm_many_mont(mesh.shard(points, axis),
                             mesh.shard(mont_batch, axis, dim=1), c)
    return _tree_add(mesh.all_gather(part, axis))
