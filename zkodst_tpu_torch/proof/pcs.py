"""Commitments of evaluation-form columns (KZG).

The KZG half of ``zkodst_tpu/proof/pcs.py`` ``commit_evals_many``
(:44-68): the Lagrange-basis MSM of :func:`.srs.commit_lagrange_many`. The
IPA backend is not ported.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import srs

# Columns per MSM: 4 full-width columns at n = 2^17 are 80 window rows of
# 2^17 gathered points (~1 GB each for the gather and the chain scan), so
# a batch of keygen's 19 fixed or 16 σ columns stays a few GB at its peak.
COMMIT_BATCH = 4


def commit_evals_many(params: srs.ParamsKZG, evals_batch: torch.Tensor,
                      c: int, body_bits: Optional[int] = None,
                      tail_rows: int = 0) -> List:
    """Commit B evaluation-form polynomials (B, n, 8) -> B affine points,
    COMMIT_BATCH columns per MSM."""
    out = []
    for i in range(0, evals_batch.shape[0], COMMIT_BATCH):
        out += srs.commit_lagrange_many(params,
                                        evals_batch[i: i + COMMIT_BATCH], c,
                                        body_bits=body_bits,
                                        tail_rows=tail_rows)
    return out
