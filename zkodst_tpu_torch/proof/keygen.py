"""Key generation: the verifying and proving keys of a circuit.

Counterpart of ``zkodst_tpu/proof/keygen.py``: the fixed columns in
evaluation and coefficient form, the copy-constraint permutation σ as
per-column (column, row) index maps and as the polynomials δ^col'·ω^row',
and the commitments to both, which the verifying key binds into the
transcript, and the Lagrange selector tables on the quotient's extended
coset (``ext_selectors``, made on the device). With a ``cache_dir``,
:func:`keygen` keeps the slow parts (σ maps, commitments, selectors) in
``pk_<fingerprint>.npz`` in the reference's format, so either package
reads the other's file; :func:`from_numpy` turns such a file into this
module's :class:`ProvingKey`. The params may be either commitment
scheme's (:mod:`.pcs`); an IPA key's file is ``pk_ipa_<fingerprint>.npz``.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..circuit.ir import CircuitDef, u64_cols_to_field
from ..ops.field import FR, from_limbs16, to_limbs16
from ..ops.pyfield import FR as PFR
from ..utils.timing import upload
from . import pcs, srs
from .domain import DELTA, Domain
from .pcs import Params

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
        """Bind the vk into the transcript. v1: k, then every fixed
        commitment in name order, then σ in ``perm_cols`` order. halo2ce:
        the one scalar :meth:`transcript_repr`."""
        if transcript.mode == "halo2ce":
            transcript.common_scalar(self.transcript_repr())
            return
        transcript.common_scalar(self.k)
        for name in sorted(self.fixed_commitments):
            transcript.common_point(self.fixed_commitments[name])
        for c in self.sigma_commitments:
            transcript.common_point(c)

    def transcript_repr(self) -> int:
        """One scalar binding the whole vk: blake2b-512 (personalization
        ``b"Halo2-Verify-Key"``) over k, each fixed commitment's name and
        halo2ce point bytes, then σ's, reduced mod r."""
        from .transcript import compress_g1_halo2ce

        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        h.update(self.k.to_bytes(4, "little"))
        for name in sorted(self.fixed_commitments):
            h.update(name.encode())
            h.update(compress_g1_halo2ce(self.fixed_commitments[name]))
        for c in self.sigma_commitments:
            h.update(compress_g1_halo2ce(c))
        return int.from_bytes(h.digest(), "little") % PFR.p


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_evals: Dict[str, torch.Tensor]       # (n, 8) Montgomery
    fixed_coeffs: Dict[str, torch.Tensor]
    sigma_maps: List[Tuple[np.ndarray, np.ndarray]]   # (colidx, rowidx)
    sigma_evals: List[torch.Tensor]
    sigma_coeffs: List[torch.Tensor]
    roots: torch.Tensor                        # ω^j table (n, 8)
    # l0 / llast / lblind / zh_inv on the extended coset, (4n, 8) each
    ext_selectors: Optional[Dict[str, torch.Tensor]] = None
    # tables the prover derives from the key alone, made at first use and
    # kept with the key; only proof/prover.py reads or writes it
    prover_cache: dict = field(default_factory=dict)


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


def _key(params: Params, circ: CircuitDef, sigma_maps) -> ProvingKey:
    """Everything but the commitments (left empty): the fixed and σ
    columns in both forms and the roots table, with one batched iNTT for
    all fixed columns and one for all σ. σ maps are built when None."""
    assert params.k == circ.k
    dom = Domain(circ.k)
    dev = pcs.device(params)
    roots = _roots_dev(dom, dev)
    perm_cols = perm_columns(circ)
    for d in range(1, len(perm_cols) + 1):
        assert pow(DELTA, d, PFR.p) != 1, "DELTA order too small"
    names = sorted(circ.fixed)
    fixed = u64_cols_to_field(FR, upload(torch.from_numpy(np.stack(
        [circ.fixed[nm] for nm in names]).astype(np.int64)), dev))
    if sigma_maps is None:
        sigma_maps = _build_sigma(circ, perm_cols)
    delta_pows = FR.from_ints([pow(DELTA, i, PFR.p)
                               for i in range(len(perm_cols))], dev)
    cols, rows = (upload(torch.from_numpy(np.stack([m[i] for m in sigma_maps])
                                          .astype(np.int64)), dev)
                  for i in (0, 1))
    sigma = FR.mul(delta_pows[cols], roots[rows])
    vk = VerifyingKey(k=circ.k, fixed_commitments={}, sigma_commitments=[],
                      perm_cols=perm_cols, circ=circ)
    return ProvingKey(
        vk=vk, fixed_evals=dict(zip(names, fixed)),
        fixed_coeffs=dict(zip(names, dom.intt(fixed))),
        sigma_maps=sigma_maps, sigma_evals=list(sigma),
        sigma_coeffs=list(dom.intt(sigma)), roots=roots)


_SELECTORS = ("l0", "llast", "lblind", "zh_inv")


def keygen(params: Params, circ: CircuitDef, msm_window: int = 13,
           cache_dir: Optional[str] = None) -> ProvingKey:
    """The proving key of `circ` on the params' device: its polynomials,
    their commitments (full-width MSMs through kernels 8–12, under the
    params' scheme) and the extended-coset selectors.

    With `cache_dir`, the key is read from ``pk_<fingerprint>.npz`` there
    (``pk_ipa_<fingerprint>.npz`` for IPA params: the commitments differ)
    (the polynomials are made again on the device), or made and written
    there when there is no such file; a file that cannot be read (one
    that lacks an array of the format among them) is made again and
    overwritten."""
    if cache_dir is None:
        return _keygen(params, circ, msm_window)
    os.makedirs(cache_dir, exist_ok=True)
    tag = "ipa_" if pcs.is_ipa(params) else ""
    path = os.path.join(cache_dir,
                        f"pk_{tag}{circuit_fingerprint(circ)}.npz")
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as npz:
                return from_numpy(npz, params, circ)
        except (KeyError, ValueError, OSError) as ex:
            print(f"# stale pk cache {path} ({type(ex).__name__}: {ex}): "
                  "regenerating", flush=True)
    pk = _keygen(params, circ, msm_window)
    _save(pk, path)
    return pk


def _save(pk: ProvingKey, path: str) -> None:
    """Write the key's cached arrays in the reference's format (points as
    (2, 8) uint32 affine limbs with a flag, 0 for the identity; selectors
    as (4n, 16) 16-bit limbs), through a temporary file that replaces
    `path` whole, so a concurrent reader sees the old file or the new.
    The archive is not compressed (``np.load`` reads either kind): field
    values hardly compress, and compressing the flagship key took most of
    the time of the setup that writes it."""
    vk = pk.vk
    names = sorted(vk.fixed_commitments)

    def enc(pt):
        return srs._ints_to_u32(pt if pt is not None else (0, 0))

    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(
        tmp,
        fixed_comm_u32=np.stack([enc(vk.fixed_commitments[nm])
                                 for nm in names]),
        fixed_comm_flag=np.asarray(
            [vk.fixed_commitments[nm] is not None for nm in names],
            np.uint8),
        sigma_comm_u32=np.stack([enc(p) for p in vk.sigma_commitments]),
        sigma_comm_flag=np.asarray(
            [p is not None for p in vk.sigma_commitments], np.uint8),
        sig_col=np.stack([m[0] for m in pk.sigma_maps]),
        sig_row=np.stack([m[1] for m in pk.sigma_maps]),
        **{f"sel_{k}": to_limbs16(pk.ext_selectors[k]) for k in _SELECTORS})
    os.replace(tmp, path)


def _keygen(params: Params, circ: CircuitDef,
            msm_window: int) -> ProvingKey:
    pk = _key(params, circ, None)
    pk.ext_selectors = Domain(circ.k).selectors_extended(pcs.device(params))
    names = sorted(pk.fixed_evals)
    pk.vk.fixed_commitments = dict(zip(names, pcs.commit_columns(
        params, [pk.fixed_evals[nm] for nm in names],
        [pk.fixed_coeffs[nm] for nm in names], msm_window)))
    pk.vk.sigma_commitments = pcs.commit_columns(
        params, pk.sigma_evals, pk.sigma_coeffs, msm_window)
    return pk


def from_numpy(npz, params: Params, circ: CircuitDef) -> ProvingKey:
    """The proving key from the reference's cached arrays (a loaded
    ``pk_<fingerprint>.npz``): σ maps (``sig_col``, ``sig_row``), the
    commitments (``*_comm_u32`` affine limbs, ``*_comm_flag`` 0 for the
    identity) and the extended-coset selectors (``sel_*``, 16-bit limbs)
    are read; the polynomials are made on the SRS's device."""
    nperm = len(perm_columns(circ))
    cols, rows = npz["sig_col"], npz["sig_row"]      # each read once
    pk = _key(params, circ, [(cols[i], rows[i]) for i in range(nperm)])

    def dec(pt_u32, flag):
        if not int(flag):
            return None
        return (srs._u32_to_ints(pt_u32[0]), srs._u32_to_ints(pt_u32[1]))

    pk.vk.fixed_commitments = {nm: dec(pt, fl) for nm, pt, fl in zip(
        sorted(circ.fixed), npz["fixed_comm_u32"], npz["fixed_comm_flag"])}
    pk.vk.sigma_commitments = [dec(pt, fl) for pt, fl in zip(
        npz["sigma_comm_u32"], npz["sigma_comm_flag"])]
    pk.ext_selectors = {
        k: from_limbs16(npz[f"sel_{k}"], pcs.device(params))
        for k in _SELECTORS}
    return pk
