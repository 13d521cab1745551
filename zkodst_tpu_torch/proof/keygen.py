"""Key generation: the verifying and proving keys of a circuit.

Counterpart of ``zkodst_tpu/proof/keygen.py`` (:36-63, :82-145, :148-165,
:168-291) without its disk cache: the fixed columns in evaluation and
coefficient form, the copy-constraint permutation σ as per-column
(column, row) index maps and as the polynomials δ^col'·ω^row', and the
commitments to both, which the verifying key binds into the transcript.
:func:`from_numpy` turns a proving key cached by the reference
(``pk_<fingerprint>.npz``) into this module's :class:`ProvingKey`.

The extended-domain selector tables (``ext_selectors``) come with the
quotient.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..circuit.ir import CircuitDef, u64_cols_to_field
from ..ops.field import FR
from ..ops.pyfield import FR as PFR
from . import pcs, srs
from .domain import DELTA, Domain

# permutation columns per grand-product chunk (constraint degree 2 + chunk
# stays within the 4n extended domain)
PERM_CHUNK = 2


@dataclass
class VerifyingKey:
    k: int
    fixed_commitments: Dict[str, tuple]
    sigma_commitments: List[tuple]
    perm_cols: List[str]
    circ: CircuitDef

    @property
    def perm_chunks(self) -> List[List[str]]:
        return [self.perm_cols[i: i + PERM_CHUNK]
                for i in range(0, len(self.perm_cols), PERM_CHUNK)]

    def hash_into(self, transcript) -> None:
        """Bind the vk into the transcript (v1): k, then every fixed
        commitment in name order, then σ in ``perm_cols`` order."""
        transcript.common_scalar(self.k)
        for name in sorted(self.fixed_commitments):
            transcript.common_point(self.fixed_commitments[name])
        for c in self.sigma_commitments:
            transcript.common_point(c)


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_evals: Dict[str, torch.Tensor]       # (n, 8) Montgomery
    fixed_coeffs: Dict[str, torch.Tensor]
    sigma_maps: List[Tuple[np.ndarray, np.ndarray]]   # (colidx, rowidx)
    sigma_evals: List[torch.Tensor]
    sigma_coeffs: List[torch.Tensor]
    roots: torch.Tensor                        # ω^j table (n, 8)
    # per permutation chunk: (σ stack, δ^col·ω^row stack), made at first use
    chunk_tables: Optional[list] = None


def _roots_dev(dom: Domain, device) -> torch.Tensor:
    """ω^j for j < n as (n, 8) Montgomery limbs: one NTT of X."""
    e1 = torch.zeros((dom.n, 8), dtype=torch.int32, device=device)
    e1[1] = FR.const(FR.ONE, device)
    return dom.ntt(e1)


def perm_columns(circ: CircuitDef) -> List[str]:
    """advice, then instance, then ``cst`` where the circuit has it."""
    return (list(circ.advice_names) + list(circ.instance_names)
            + (["cst"] if "cst" in circ.fixed else []))


def _build_sigma(circ: CircuitDef, perm_cols: List[str]):
    """Union-find over copy positions -> per-column (col', row') index maps
    (a copy of the reference's host code: cycles are sorted positions)."""
    n = circ.n
    cidx = {c: i for i, c in enumerate(perm_cols)}
    parent: Dict[int, int] = {}

    def find(a: int) -> int:
        root = a
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(a, a) != a:
            parent[a], a = root, parent[a]
        return root

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    def enc(col: str, row: int) -> int:
        return cidx[col] * n + row

    members: Dict[int, bool] = {}
    for cp in circ.copies:
        assert cp.col_a in cidx and cp.col_b in cidx, \
            f"copy touches non-permutation column {cp.col_a}/{cp.col_b}"
        for ra, rb in zip(cp.rows_a.tolist(), cp.rows_b.tolist()):
            a, b = enc(cp.col_a, int(ra)), enc(cp.col_b, int(rb))
            members[a] = members[b] = True
            union(a, b)

    cycles: Dict[int, List[int]] = {}
    for pos in members:
        cycles.setdefault(find(pos), []).append(pos)

    colmap = [np.full(n, i, np.int32) for i in range(len(perm_cols))]
    rowmap = [np.arange(n, dtype=np.int32) for _ in perm_cols]
    for cyc in cycles.values():
        cyc.sort()
        for i, pos in enumerate(cyc):
            nxt = cyc[(i + 1) % len(cyc)]
            colmap[pos // n][pos % n] = nxt // n
            rowmap[pos // n][pos % n] = nxt % n
    return list(zip(colmap, rowmap))


def circuit_fingerprint(circ: CircuitDef) -> str:
    """The reference's proving-key cache key (``_circuit_fingerprint``):
    the same bytes hashed, so the same hex digest for the same circuit."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((circ.k, list(circ.advice_names),
                   list(circ.instance_names),
                   [(g.name, repr(g.poly)) for g in circ.gates],
                   [(lk.name, tuple(lk.input_cols), tuple(lk.table_cols))
                    for lk in circ.lookups])).encode())
    for name in sorted(circ.fixed):
        h.update(name.encode())
        h.update(np.ascontiguousarray(circ.fixed[name]).tobytes())
    for cp in circ.copies:
        h.update(cp.col_a.encode())
        h.update(cp.col_b.encode())
        h.update(np.ascontiguousarray(cp.rows_a).tobytes())
        h.update(np.ascontiguousarray(cp.rows_b).tobytes())
    return h.hexdigest()


def _key(params: srs.ParamsKZG, circ: CircuitDef, sigma_maps) -> ProvingKey:
    """Everything but the commitments (left empty): the fixed and σ
    columns in both forms and the roots table, with one batched iNTT for
    all fixed columns and one for all σ. σ maps are built when None."""
    assert params.k == circ.k
    dom = Domain(circ.k)
    dev = params.g1_lagrange.device
    roots = _roots_dev(dom, dev)
    perm_cols = perm_columns(circ)
    for d in range(1, len(perm_cols) + 1):
        assert pow(DELTA, d, PFR.p) != 1, "DELTA order too small"
    names = sorted(circ.fixed)
    fixed = u64_cols_to_field(FR, torch.from_numpy(np.stack(
        [circ.fixed[nm] for nm in names]).astype(np.int64)).to(dev))
    if sigma_maps is None:
        sigma_maps = _build_sigma(circ, perm_cols)
    delta_pows = FR.from_ints([pow(DELTA, i, PFR.p)
                               for i in range(len(perm_cols))], dev)
    cols, rows = (torch.from_numpy(np.stack([m[i] for m in sigma_maps])
                                   .astype(np.int64)).to(dev)
                  for i in (0, 1))
    sigma = FR.mul(delta_pows[cols], roots[rows])
    vk = VerifyingKey(k=circ.k, fixed_commitments={}, sigma_commitments=[],
                      perm_cols=perm_cols, circ=circ)
    return ProvingKey(
        vk=vk, fixed_evals=dict(zip(names, fixed)),
        fixed_coeffs=dict(zip(names, dom.intt(fixed))),
        sigma_maps=sigma_maps, sigma_evals=list(sigma),
        sigma_coeffs=list(dom.intt(sigma)), roots=roots)


def keygen(params: srs.ParamsKZG, circ: CircuitDef,
           msm_window: int = 13) -> ProvingKey:
    """The proving key of `circ` on the SRS's device: its polynomials and
    their commitments (full-width MSMs through kernels 8–12)."""
    pk = _key(params, circ, None)
    names = sorted(pk.fixed_evals)
    pk.vk.fixed_commitments = dict(zip(names, pcs.commit_evals_many(
        params, torch.stack([pk.fixed_evals[nm] for nm in names]),
        msm_window)))
    pk.vk.sigma_commitments = pcs.commit_evals_many(
        params, torch.stack(pk.sigma_evals), msm_window)
    return pk


def from_numpy(npz, params: srs.ParamsKZG, circ: CircuitDef) -> ProvingKey:
    """The proving key from the reference's cached arrays (a loaded
    ``pk_<fingerprint>.npz``): σ maps (``sig_col``, ``sig_row``) and the
    commitments (``*_comm_u32`` affine limbs, ``*_comm_flag`` 0 for the
    identity) are read; the polynomials are made on the SRS's device. The
    ``sel_*`` tables are left for the quotient."""
    nperm = len(perm_columns(circ))
    pk = _key(params, circ, [(npz["sig_col"][i], npz["sig_row"][i])
                             for i in range(nperm)])

    def dec(pt_u32, flag):
        if not int(flag):
            return None
        return (srs._u32_to_ints(pt_u32[0]), srs._u32_to_ints(pt_u32[1]))

    pk.vk.fixed_commitments = {nm: dec(pt, fl) for nm, pt, fl in zip(
        sorted(circ.fixed), npz["fixed_comm_u32"], npz["fixed_comm_flag"])}
    pk.vk.sigma_commitments = [dec(pt, fl) for pt, fl in zip(
        npz["sigma_comm_u32"], npz["sigma_comm_flag"])]
    return pk
