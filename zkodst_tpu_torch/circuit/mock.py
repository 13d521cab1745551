"""Constraint checker with no cryptography: the MockProver equivalent.

Counterpart of ``zkodst_tpu/circuit/mock.py``. Every gate is evaluated on
the device over whole columns, as the reference does under ``jit`` (the
columns the gates read become field elements in one batched product, and
each node of the gate trees is one field operation: kernels 1–3 on the
card); the gates' nonzero masks cross to the host once. Lookups and copies
are host-side numpy checks on the raw u64 cells, as in the reference. The
failures come in the reference's order (shapes, gates, lookups, copies),
with the same rows and the same text.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..ops import u64
from ..utils.device import resolve
from ..utils.timing import upload
from .expr import eval_expr
from .ir import CircuitDef, u64_cols_to_field


@dataclass
class Failure:
    kind: str       # "gate" | "lookup" | "copy" | "shape"
    name: str
    rows: np.ndarray

    def __str__(self):
        head = ", ".join(str(r) for r in self.rows[:8])
        more = "…" if len(self.rows) > 8 else ""
        return f"{self.kind} '{self.name}' violated at rows [{head}{more}]" \
               f" ({len(self.rows)} rows)"


def _gate_masks(circ: CircuitDef, cols: Dict[str, object],
                device: torch.device) -> np.ndarray:
    """(gates, n) bool: where each gate is nonzero. `cols` holds each
    column as (n, 2) u64 pairs, a tensor or numpy."""
    F = circ.field
    names = sorted({c for g in circ.gates for c, _ in g.poly.vars()})
    if not names:
        return np.zeros((len(circ.gates), circ.n), bool)

    def pairs(col):
        if isinstance(col, torch.Tensor):
            return col.to(device=device, dtype=torch.int64)
        return upload(torch.from_numpy(u64.to_u32(col).astype(np.int64)),
                      device)

    fcols = dict(zip(names, u64_cols_to_field(
        F, torch.stack([pairs(cols[nm]) for nm in names]))))

    def getcol(name, rot):
        c = fcols[name]
        return torch.roll(c, -rot, 0) if rot else c

    cache: dict = {}
    masks = [(eval_expr(g.poly, F, getcol, device, cache) != 0).any(-1)
             for g in circ.gates]
    return torch.stack(masks).cpu().numpy()


def check(circ: CircuitDef, advice: Dict[str, object],
          instance: Dict[str, object], device=None) -> List[Failure]:
    """The constraint failures of a witness (an empty list: the circuit is
    satisfied). advice / instance: (n, 2) u64 pairs per column, tensors or
    uint32 numpy. The gates run on `device` (CUDA unless the caller names
    another)."""
    dev = resolve(device)
    n = circ.n
    failures: List[Failure] = []

    given = {**circ.fixed, **advice, **instance}
    cols_u64: Dict[str, np.ndarray] = {}
    for name, arr in given.items():
        arr = u64.to_u32(arr)
        if arr.shape != (n, 2):
            failures.append(Failure("shape", name, np.array([])))
            continue
        cols_u64[name] = arr
    missing = ((set(circ.advice_names) | set(circ.instance_names))
               - set(cols_u64))
    for name in sorted(missing):
        failures.append(Failure("shape", name, np.array([])))
    if failures:
        return failures

    # --- gates (on the device, all rows; selectors vanish on unused rows)
    bad = _gate_masks(circ, given, dev)
    for g, mask in zip(circ.gates, bad):
        rows = np.nonzero(mask)[0]
        if rows.size:
            failures.append(Failure("gate", g.name, rows))

    # --- lookups (multiset membership: rows packed to void keys, np.isin)
    usable = circ.usable_rows

    def _rowkeys(cols):
        packed = np.ascontiguousarray(
            np.stack(cols, axis=1))                 # (rows, c, 2) uint32
        return packed.reshape(packed.shape[0], -1).view(
            [("", np.uint32)] * (2 * len(cols))).ravel()

    for lk in circ.lookups:
        tkeys = _rowkeys([cols_u64[c] for c in lk.table_cols])
        ikeys = _rowkeys([cols_u64[c][:usable] for c in lk.input_cols])
        rows = np.nonzero(~np.isin(ikeys, tkeys))[0]
        if rows.size:
            failures.append(Failure("lookup", lk.name, rows))

    # --- copies (exact u64 equality)
    for cp in circ.copies:
        a = cols_u64[cp.col_a][cp.rows_a]
        b = cols_u64[cp.col_b][cp.rows_b]
        neq = np.any(a != b, axis=-1)
        rows = cp.rows_a[np.nonzero(neq)[0]]
        if rows.size:
            failures.append(Failure(
                "copy", f"{cp.col_a}<->{cp.col_b}", rows))

    return failures


def check_or_raise(circ, advice, instance, device=None) -> None:
    fails = check(circ, advice, instance, device)
    if fails:
        raise AssertionError(
            "mock check failed:\n  " + "\n  ".join(str(f) for f in fails))
