"""Sharded grand-product scans: prefix products with cross-shard carries.

Counterpart of ``zkodst_tpu/parallel/scan_sharded.py`` (:22-48) for the
mesh path of ``create_proof``: each rank scans its block of rows with
``Field.cumprod_incl`` (kernels 4, 5 and 1), the D block totals are
all-gathered, and each rank folds in the exclusive product of the blocks
before its own (kernel 1). Field products are exact and associative, so
the result equals the single-device scan limb for limb.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.field import Field
from .bootstrap import AxisName, Mesh


def carry_fold(F: Field, total: torch.Tensor, carry: torch.Tensor,
               mesh: Mesh, axis: AxisName
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The carry into this rank's block and the product over all blocks.

    total: (8,) this block's product; carry: (8,) the value entering block
    0. Returns (carry · ∏ of the totals of the blocks before this one,
    carry · ∏ of every block's total), both (8,) Montgomery."""
    tots = mesh.all_gather(total, axis)                  # (D, 8)
    into = carry
    for d in range(mesh.index(axis)):
        into = F.mul(into, tots[d])
    out = carry
    for d in range(tots.shape[0]):
        out = F.mul(out, tots[d])
    return into, out


def cumprod_incl_sharded(F: Field, x: torch.Tensor, mesh: Mesh,
                         axis: AxisName
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix product along axis 0 of a replicated (n, 8)
    column, the rows sharded over `axis`. Returns (the prefix products
    (n, 8) and their total (8,)), replicated on every rank."""
    incl = F.cumprod_incl(mesh.shard(x, axis))
    one = F.const(F.ONE, x.device)
    into, total = carry_fold(F, incl[-1], one, mesh, axis)
    out = F.mul(incl, into)
    return mesh.all_gather(out, axis).reshape(x.shape), total
