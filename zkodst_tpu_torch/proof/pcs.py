"""Commitment-scheme dispatch: KZG/SHPLONK or IPA behind one interface.

Counterpart of ``zkodst_tpu/proof/pcs.py`` (:40-114), the seam that lets
the same prover and verifier run over either scheme (KZG's commitments
also sharded over a mesh; IPA raises under one, as the reference's):

* KZG commits evaluation-form polynomials against the Lagrange SRS basis
  (:func:`.srs.commit_lagrange_many`, with the u64 advice's 64-bit body
  split) and coefficient-form ones against the monomial basis.
* IPA params carry only the monomial generators, so a column is
  committed from its coefficient form by a full-width MSM over
  ``params.g`` (⟨c, G⟩, the same group element a Lagrange generator set
  would give to its evaluation form); the coefficients leave no small
  scalars to split off. The prover and keygen hold every column in both
  forms, so :func:`commit_columns` takes both and reads the scheme's. IPA
  commits with Pedersen blind 0: hiding comes from the blinded tail rows
  of every column.
* The multiopen: SHPLONK's two witness points and a pairing for KZG;
  :func:`.ipa.open_claims_compressed`, the same reduction finished by one
  log-size opening, for IPA.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from . import ipa, shplonk, srs
from .domain import Domain

Params = Union[srs.ParamsKZG, ipa.ParamsIPA]
Columns = Union[torch.Tensor, Sequence[torch.Tensor]]

# Columns per full-width MSM, either scheme: a batch of keygen's 19 fixed
# or 16 σ columns stays a few GB at its peak.
COMMIT_BATCH = ipa.COMMIT_BATCH


def _stacked(cols: Columns) -> torch.Tensor:
    return cols if isinstance(cols, torch.Tensor) else torch.stack(cols)


def is_ipa(params: Params) -> bool:
    return isinstance(params, ipa.ParamsIPA)


def device(params: Params) -> torch.device:
    """The device the params' points live on."""
    return params.device if is_ipa(params) else params.g1_lagrange.device


def single_device(params: Params, mesh) -> None:
    """Raise for IPA params under a mesh: the IPA backend runs on one
    device, as the reference's (``pcs.py:54,75``)."""
    if mesh is not None and is_ipa(params):
        raise NotImplementedError(
            "the IPA backend is single-device: use KZG for a mesh")


def commit_columns(params: Params, evals: Columns, coeffs: Columns, c: int,
                   body_bits: Optional[int] = None,
                   tail_rows: int = 0, mesh=None, mesh_axis="x") -> List:
    """Commit B columns held in both forms -> B affine points (the
    reference's ``commit_evals_many``). `evals` and `coeffs` are each a
    (B, n, 8) tensor or B (n, 8) tensors; only the form the scheme commits
    is read. KZG commits the evaluation forms against the Lagrange basis:
    with body_bits/tail_rows (the small-scalar split) the whole batch in
    one MSM (a 64-bit body is a quarter of a full-width column's windows),
    otherwise COMMIT_BATCH columns per MSM. With `mesh`, each MSM's points
    are sharded over `mesh_axis`, full width (the reference drops the
    split there). IPA commits the coefficient forms against ``params.g``
    (the same group element; the callers have made them for the quotient
    already, so no iNTT runs here)."""
    single_device(params, mesh)
    if is_ipa(params):
        return ipa.commit_many(params, _stacked(coeffs), c)
    evals = _stacked(evals)
    if body_bits is not None and mesh is None:
        return srs.commit_lagrange_many(params, evals, c,
                                        body_bits=body_bits,
                                        tail_rows=tail_rows)
    out = []
    for i in range(0, evals.shape[0], COMMIT_BATCH):
        out += srs.commit_lagrange_many(params, evals[i: i + COMMIT_BATCH], c,
                                        mesh=mesh, mesh_axis=mesh_axis)
    return out


def commit_coeff_many(params: Params, coeffs_batch: torch.Tensor,
                      c: int, mesh=None, mesh_axis="x") -> List:
    """Commit B coefficient-form polynomials (B, m, 8) -> B affine points,
    COMMIT_BATCH columns per MSM (sharded over `mesh_axis` with a
    mesh)."""
    single_device(params, mesh)
    if is_ipa(params):
        return ipa.commit_many(params, coeffs_batch, c)
    out = []
    for i in range(0, coeffs_batch.shape[0], COMMIT_BATCH):
        out += srs.commit_coeff_many(params,
                                     coeffs_batch[i: i + COMMIT_BATCH], c,
                                     mesh=mesh, mesh_axis=mesh_axis)
    return out


def open_all(params: Params, dom: Domain, claims: List[shplonk.Claim], tw,
             rng=None) -> None:
    """The prover's multiopen of claims carrying ``evals_dev``: SHPLONK's
    W and W′ (KZG), or W and one IPA opening whose blinds come from `rng`
    (IPA)."""
    if is_ipa(params):
        ipa.open_claims_compressed(params, dom, claims, tw, rng=rng)
    else:
        shplonk.open_claims(params, dom, claims, tw)


def verify_all(params: Params, dom: Domain, claims: List[shplonk.Claim],
               tr, native: bool = True) -> bool:
    """The verifier's multiopen check of claims carrying ``commitment``
    (`native` picks the KZG pairing's implementation; the IPA check runs
    its MSM on the params' device and its tail in Python ints)."""
    if is_ipa(params):
        return ipa.verify_claims_compressed(params, dom, claims, tr)
    return shplonk.verify_claims(params, dom, claims, tr, native)
