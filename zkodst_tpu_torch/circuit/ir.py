"""Circuit IR: columns-as-tensors PLONKish circuit description.

Counterpart of ``zkodst_tpu/circuit/ir.py``: a circuit is static data —
fixed columns, gate expressions, lookups and vectorized copy groups. Cell
values are u64 words as (lo, hi) pairs; :func:`u64_cols_to_field` is the
one conversion point from witness space to Fr Montgomery limbs.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.field import FR, Field, to_i32
from .expr import Expr

# Rows at the tail of the domain reserved for blinding factors (usable =
# n - BLINDING_ROWS - 1, the -1 being the l_last row).
BLINDING_ROWS = 8


@dataclass(frozen=True)
class Gate:
    """One polynomial identity that must vanish on every row."""

    name: str
    poly: Expr


@dataclass(frozen=True)
class Lookup:
    """(input columns) ⊆ (table columns) on every usable row."""

    name: str
    input_cols: Sequence[str]
    table_cols: Sequence[str]


@dataclass(frozen=True)
class CopyGroup:
    """columns[col_a][rows_a] must equal columns[col_b][rows_b]."""

    col_a: str
    rows_a: np.ndarray
    col_b: str
    rows_b: np.ndarray


@dataclass
class CircuitDef:
    k: int
    advice_names: List[str]
    instance_names: List[str]
    fixed: Dict[str, np.ndarray]          # name -> (n, 2) uint32 u64 values
    gates: List[Gate] = dfield(default_factory=list)
    lookups: List[Lookup] = dfield(default_factory=list)
    copies: List[CopyGroup] = dfield(default_factory=list)
    field: Field = FR
    instance_len: Dict[str, int] = dfield(default_factory=dict)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def usable_rows(self) -> int:
        return self.n - BLINDING_ROWS - 1

    def column_kind(self, name: str) -> str:
        if name in self.fixed:
            return "fixed"
        if name in self.advice_names:
            return "advice"
        if name in self.instance_names:
            return "instance"
        raise KeyError(name)

    def max_gate_degree(self) -> int:
        return max((g.poly.degree() for g in self.gates), default=0)

    def validate(self) -> None:
        n = self.n
        names = (set(self.fixed) | set(self.advice_names)
                 | set(self.instance_names))
        assert len(names) == (len(self.fixed) + len(self.advice_names)
                              + len(self.instance_names)), "duplicate column"
        for f in self.fixed.values():
            assert f.shape == (n, 2) and f.dtype == np.uint32
        for g in self.gates:
            for col, _ in g.poly.vars():
                assert col in names, f"gate {g.name}: unknown column {col}"
        for lk in self.lookups:
            assert len(lk.input_cols) == len(lk.table_cols)
            for c in lk.input_cols:
                assert c in names, f"lookup {lk.name}: unknown column {c}"
            for c in lk.table_cols:
                assert c in self.fixed, \
                    f"lookup {lk.name}: table col {c} must be fixed"
            self._validate_lookup_functional(lk)
        for name, ln in self.instance_len.items():
            assert name in self.instance_names, name
            assert 0 <= ln <= self.usable_rows
        for cp in self.copies:
            assert cp.rows_a.shape == cp.rows_b.shape
            for col, rows in ((cp.col_a, cp.rows_a), (cp.col_b, cp.rows_b)):
                assert col in names
                assert rows.size == 0 or (
                    0 <= rows.min() and rows.max() < self.usable_rows), \
                    f"copy touches non-usable rows in {col}"

    def _validate_lookup_functional(self, lk: "Lookup") -> None:
        """The prover's lookup permutations sort by the first (key) table
        column only (``proof/prover.py`` ``_lookup_perm_indices``), so
        every other table column must be a function of the key column
        (equal keys ⇒ equal rows), as a spread table is; a table with an
        independent second column would make honest proofs fail, so it is
        rejected here. Inputs need no check of their own: a valid
        witness's input rows come from the table."""
        if len(lk.table_cols) < 2:
            return
        key = self.fixed[lk.table_cols[0]]
        kview = key.view(np.uint64).ravel()
        order = np.argsort(kview, kind="stable")
        ks = kview[order]
        same_key = ks[1:] == ks[:-1]
        for c in lk.table_cols[1:]:
            vs = self.fixed[c].view(np.uint64).ravel()[order]
            bad = same_key & (vs[1:] != vs[:-1])
            assert not bad.any(), (
                f"lookup {lk.name}: table column {c!r} is not a function of "
                f"the key column {lk.table_cols[0]!r} (e.g. key "
                f"{int(ks[np.argmax(bad) + 1])} maps to two values) — the "
                "sort-by-key permutation build requires it")


def u64_cols_to_field(F: Field, cols: torch.Tensor) -> torch.Tensor:
    """(..., n, 2) u64 pairs (int64-held) -> (..., n, 8) Montgomery limbs.

    The raw value lo + hi·2^32 is already two 32-bit limbs; one batched
    Montgomery multiply by R² puts it in Montgomery form."""
    raw = torch.zeros(cols.shape[:-1] + (8,), dtype=torch.int32,
                      device=cols.device)
    raw[..., :2] = to_i32(cols)
    r2 = F.const(F.R2, cols.device).expand_as(raw)
    return F.mul(raw, r2)
