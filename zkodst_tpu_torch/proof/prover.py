"""The prover, through the grand-product commitments.

Counterpart of ``zkodst_tpu/proof/prover.py`` ``create_proof``
(:563-748) up to the challenge y: the verifying key and the instances
enter the transcript, then the advice commitments, θ, the lookup
permutations and the A′/S′ commitments, β and γ, the permutation and
lookup grand products Z and their commitments, y. The quotient, the
evaluations and the multiopen come in later slices; they consume the
coefficient forms that :class:`Prover` keeps (``pre_coeffs``).

Blinds come from one ``random.Random(("zkodst-blind", seed))`` drawn in
the reference's order — advice (one tail per column), lookups (A′ then S′
per lookup), permutation Z (one per chunk), lookup Z (one per lookup) — so
the bytes equal the reference proof's prefix.
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import secrets
from typing import Dict, List, Optional

import numpy as np
import torch

from ..circuit.ir import BLINDING_ROWS, CircuitDef, u64_cols_to_field
from ..ops.field import FR
from . import pcs, srs
from .domain import DELTA, Domain
from .keygen import ProvingKey
from .transcript import Blake2bWrite

# Pippenger window width of every commit in the proof (the reference's)
MSM_C = 13


def _phase(metrics, label: str):
    return (metrics.phase(label) if metrics is not None
            else contextlib.nullcontext())


def _u64_tensor(col, device) -> torch.Tensor:
    """An (n, 2) u64 column (tensor or uint32 numpy) as int64 on `device`."""
    if isinstance(col, torch.Tensor):
        return col.to(device)
    return torch.from_numpy(np.asarray(col).astype(np.int64)).to(device)


def _blinds(rng: random.Random, cols: int, device) -> torch.Tensor:
    """(cols, BLINDING_ROWS, 8) fresh Fr values, drawn column by column."""
    return FR.from_ints([[rng.randrange(FR.p) for _ in range(BLINDING_ROWS)]
                         for _ in range(cols)], device)


# ---------------------------------------------------------------------------
# phase 1: advice
# ---------------------------------------------------------------------------

def _prep_advice(adv_u64_stack: torch.Tensor, blinds: torch.Tensor,
                 n: int) -> torch.Tensor:
    """(A, n, 2) u64 advice columns -> (A, n, 8) field columns with the
    BLINDING_ROWS tail rows set to the blinds."""
    ev = u64_cols_to_field(FR, adv_u64_stack)
    ev[:, n - BLINDING_ROWS:] = blinds
    return ev


def advice_phase(params: srs.ParamsKZG, circ: CircuitDef,
                 advice_u64: Dict[str, torch.Tensor], rng: random.Random,
                 tw: Blake2bWrite, metrics=None) -> torch.Tensor:
    """Blind and commit every advice column (phase ``prove.advice_commit``);
    writes one point per column and returns the (A, n, 8) blinded columns.

    Advice cells are u64 values, so the body MSM runs only the 64-bit
    windows and the full-width blinding tail is a separate small MSM."""
    dev = params.g1_lagrange.device
    with _phase(metrics, "prove.advice_commit"):
        blinds = _blinds(rng, len(circ.advice_names), dev)
        evals = _prep_advice(
            torch.stack([advice_u64[name] for name in circ.advice_names]),
            blinds, circ.n)
        for pt in srs.commit_lagrange_many(params, evals, MSM_C,
                                           body_bits=64,
                                           tail_rows=BLINDING_ROWS):
            tw.write_point(pt)
    return evals


def commit_advice(params: srs.ParamsKZG, circ: CircuitDef,
                  advice_u64: Dict[str, torch.Tensor], seed: int,
                  metrics=None) -> bytes:
    """The advice-commitment bytes alone (one compressed point per column,
    in advice order), with the blinds of `seed` — the proof's first
    32·|advice| bytes."""
    tw = Blake2bWrite()
    advice_phase(params, circ, advice_u64,
                 random.Random(("zkodst-blind", seed).__repr__()), tw,
                 metrics)
    return tw.finalize()


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------

def _lookup_perm_indices(in_d: torch.Tensor, tb_d: torch.Tensor, u: int):
    """Sorted-input / rearranged-table row indices for one lookup
    (``prover.py:148-179``).

    in_d, tb_d: (n,) key columns (the low 32-bit word of the first input
    and table columns). Rows ≥ u carry the sentinel 0xFFFFFFFF, which no
    lookup value reaches, so they stay in place. Sorts are stable on int64
    keys; ``searchsorted`` is left-sided; the reference's dropping scatters
    (index n) are masked scatters here. Returns (perm_in, perm_tb), int64."""
    n = in_d.shape[0]
    dev = in_d.device
    ids = torch.arange(n, device=dev)
    usable = ids < u
    sent = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    ki = torch.where(usable, in_d.to(torch.int64) & 0xFFFFFFFF, sent)
    kt = torch.where(usable, tb_d.to(torch.int64) & 0xFFFFFFFF, sent)
    perm_in = torch.sort(ki, stable=True).indices
    perm_tb0 = torch.sort(kt, stable=True).indices
    sk, tk = ki[perm_in], kt[perm_tb0]
    first = usable & ((ids == 0) | (sk != torch.roll(sk, 1)))
    t_first = usable & ((ids == 0) | (tk != torch.roll(tk, 1)))
    pos_in_a = torch.searchsorted(sk, tk)
    in_a = sk[torch.clamp(pos_in_a, max=n - 1)] == tk
    consumed = t_first & in_a
    # leftovers (unconsumed usable table rows) fill non-first positions
    left = ~consumed & usable
    lrank = torch.cumsum(left.to(torch.int64), 0) - 1
    fill = ~first & usable
    nfrank = torch.cumsum(fill.to(torch.int64), 0) - 1
    dest = torch.zeros(n, dtype=torch.int64, device=dev)
    dest[nfrank[fill]] = ids[fill]
    pos_in_t = torch.searchsorted(tk, sk)
    sperm = torch.where(first, perm_tb0[torch.clamp(pos_in_t, max=n - 1)],
                        torch.zeros_like(ids))
    # dest[lrank] with lrank = -1 reads dest[n-1]; only rows kept by `left`
    sperm[dest[lrank][left]] = perm_tb0[left]
    sperm = torch.where(usable, sperm, ids)
    return perm_in, sperm


def _compress(cols: List[torch.Tensor], theta_k: torch.Tensor):
    """cols[0] + θ·cols[1] + θ²·cols[2] + …, θ^k kept in Montgomery form."""
    acc = cols[0]
    tpow = None
    for c in cols[1:]:
        tpow = theta_k if tpow is None else FR.mul(tpow, theta_k)
        acc = FR.add(acc, FR.mul(c, tpow))
    return acc


def lookup_columns(circ: CircuitDef, evals: Dict[str, torch.Tensor],
                   theta: int, perms: dict, blinds: torch.Tensor):
    """The lookup phase body (``prover.py:235-270``): per lookup, the
    θ-compressed input and table columns and their permuted forms A′ and
    S′ with blinded tails. Returns four (L, n, 8) stacks: compressed input,
    compressed table, A′, S′."""
    n = circ.n
    theta_k = FR.from_ints(theta, blinds.device)
    acmps, scmps, aps, sps = [], [], [], []
    for i, lk in enumerate(circ.lookups):
        a_cmp = _compress([evals[c] for c in lk.input_cols], theta_k)
        s_cmp = _compress([evals[c] for c in lk.table_cols], theta_k)
        perm_in, perm_tb = perms[lk.name]
        ap, sp = a_cmp[perm_in], s_cmp[perm_tb]
        ap[n - BLINDING_ROWS:] = blinds[2 * i]
        sp[n - BLINDING_ROWS:] = blinds[2 * i + 1]
        acmps.append(a_cmp)
        scmps.append(s_cmp)
        aps.append(ap)
        sps.append(sp)
    return (torch.stack(acmps), torch.stack(scmps), torch.stack(aps),
            torch.stack(sps))


# ---------------------------------------------------------------------------
# grand products
# ---------------------------------------------------------------------------

def _one(device) -> torch.Tensor:
    return FR.const(FR.ONE, device)


def _grand_product(ratio: torch.Tensor, carry: torch.Tensor):
    """Z with Z[0] = carry, Z[i] = carry·∏_{j<i} ratio[j], and the carry
    out carry·∏ ratio. ratio (n, 8); carry (8,) Montgomery."""
    incl = FR.cumprod_incl(ratio)
    z = torch.empty_like(ratio)
    z[0] = carry
    z[1:] = FR.mul(incl[:-1], carry)
    return z, FR.mul(incl[-1], carry)


def _ratio(num: torch.Tensor, den: torch.Tensor, u: int) -> torch.Tensor:
    """num / den on the usable rows, 1 on rows ≥ u."""
    ratio = FR.mul(num, FR.inv_batch(den))
    ratio[u:] = _one(ratio.device)
    return ratio


def perm_z_pass(cols, sigmas, idents, bk, gk, carry, u: int):
    """One permutation chunk's grand product (``prover.py:201-218``):
    ∏_i (c_i + β·id_i + γ) / (c_i + β·σ_i + γ) over the chunk's columns.

    cols/sigmas/idents: (m, n, 8); bk, gk, carry: (8,). Returns (Z, the
    carry into the next chunk)."""
    num_f = FR.add(cols, FR.add(FR.mul(idents, bk), gk))
    den_f = FR.add(cols, FR.add(FR.mul(sigmas, bk), gk))
    num, den = num_f[0], den_f[0]
    for i in range(1, cols.shape[0]):
        num, den = FR.mul(num, num_f[i]), FR.mul(den, den_f[i])
    return _grand_product(_ratio(num, den, u), carry)


def lookup_z_pass(a_cmp, s_cmp, ap, sp, bk, gk, u: int):
    """One lookup's grand product (``prover.py:221-232``):
    (a + β)(s + γ) / (a′ + β)(s′ + γ), starting at 1."""
    num = FR.mul(FR.add(a_cmp, bk), FR.add(s_cmp, gk))
    den = FR.mul(FR.add(ap, bk), FR.add(sp, gk))
    return _grand_product(_ratio(num, den, u), _one(a_cmp.device))[0]


def chunk_tables(pk: ProvingKey):
    """Per permutation chunk, its σ columns and identity columns
    δ^col·ω^row: challenge-independent, made once per key."""
    if pk.chunk_tables is None:
        vk = pk.vk
        col_of = {c: i for i, c in enumerate(vk.perm_cols)}
        dev = pk.roots.device
        pk.chunk_tables = []
        for chunk in vk.perm_chunks:
            gis = [col_of[c] for c in chunk]
            sig = torch.stack([pk.sigma_evals[gi] for gi in gis])
            dk = FR.from_ints([pow(DELTA, gi, FR.p) for gi in gis], dev)
            ident = FR.mul(pk.roots[None], dk[:, None, :])
            pk.chunk_tables.append((sig, ident))
    return pk.chunk_tables


# ---------------------------------------------------------------------------
# the transcript's public inputs
# ---------------------------------------------------------------------------

def absorb_instances(tw: Blake2bWrite, circ: CircuitDef,
                     instance_u64: Dict[str, torch.Tensor]) -> None:
    """v1 (``prover.py:391-394``): one blake2b-512 digest (no
    personalization) over every instance column's (n, 2) uint32 bytes in
    ``instance_names`` order, absorbed as one scalar. A circuit without
    instance columns absorbs the digest of the empty input."""
    hsh = hashlib.blake2b(digest_size=64)
    for name in circ.instance_names:
        col = instance_u64[name]
        if isinstance(col, torch.Tensor):
            col = col.cpu().numpy()
        hsh.update(np.asarray(col).astype(np.uint32).tobytes())
    tw.common_scalar(int.from_bytes(hsh.digest(), "little") % FR.p)


# ---------------------------------------------------------------------------
# create_proof
# ---------------------------------------------------------------------------

class Prover:
    """One proof in progress: the transcript, the blind stream, every
    committed column in evaluation form (``evals``) and the coefficient
    forms made early for the quotient (``pre_coeffs``). The phase methods
    run in order; :func:`create_proof` drives them."""

    def __init__(self, params: srs.ParamsKZG, pk: ProvingKey,
                 advice_u64: Dict[str, torch.Tensor],
                 instance_u64: Dict[str, torch.Tensor],
                 seed: Optional[int] = None, metrics=None):
        self.params, self.pk, self.metrics = params, pk, metrics
        self.circ = pk.vk.circ
        self.dom = Domain(self.circ.k)
        self.dev = params.g1_lagrange.device
        self.advice_u64 = advice_u64
        self.rng = random.Random(secrets.token_bytes(32) if seed is None
                                 else ("zkodst-blind", seed).__repr__())
        self.tw = Blake2bWrite()
        self.evals: Dict[str, torch.Tensor] = {}
        self.pre_coeffs: Dict[str, torch.Tensor] = {}
        self.challenges: Dict[str, int] = {}
        pk.vk.hash_into(self.tw)
        absorb_instances(self.tw, self.circ, instance_u64)
        for name in self.circ.instance_names:
            self.evals[name] = u64_cols_to_field(
                FR, _u64_tensor(instance_u64[name], self.dev))
        for name, fe in pk.fixed_evals.items():
            self.evals[name] = fe

    def _pre_intt(self, names: List[str]) -> None:
        """Coefficient forms of final columns, for the quotient: one
        batched iNTT per phase, as the reference enqueues them."""
        if names:
            coeffs = self.dom.intt(torch.stack([self.evals[nm]
                                                for nm in names]))
            self.pre_coeffs.update(zip(names, coeffs))

    def advice(self) -> None:
        circ = self.circ
        # the lookup row permutations depend only on the witness
        u = circ.usable_rows
        self.lk_perms = {
            lk.name: _lookup_perm_indices(
                self.advice_u64[lk.input_cols[0]][:, 0],
                _u64_tensor(circ.fixed[lk.table_cols[0]], self.dev)[:, 0], u)
            for lk in circ.lookups}
        adv = advice_phase(self.params, circ, self.advice_u64, self.rng,
                           self.tw, self.metrics)
        self.evals.update(zip(circ.advice_names, adv))
        self._pre_intt(list(circ.advice_names) + list(circ.instance_names))
        self.challenges["theta"] = self.tw.squeeze_challenge()

    def lookups(self) -> None:
        circ = self.circ
        with _phase(self.metrics, "prove.lookup_permute"):
            self.lk_data = None
            if circ.lookups:
                blinds = _blinds(self.rng, 2 * len(circ.lookups), self.dev)
                self.lk_data = lookup_columns(circ, self.evals,
                                              self.challenges["theta"],
                                              self.lk_perms, blinds)
                _, _, aps, sps = self.lk_data
                names = []
                for i, lk in enumerate(circ.lookups):
                    self.evals[f"{lk.name}.a_perm"] = aps[i]
                    self.evals[f"{lk.name}.s_perm"] = sps[i]
                    names += [f"{lk.name}.a_perm", f"{lk.name}.s_perm"]
                self._pre_intt(names)
                for pt in pcs.commit_evals_many(
                        self.params, torch.stack([self.evals[nm]
                                                  for nm in names]), MSM_C):
                    self.tw.write_point(pt)
        self.challenges["beta"] = self.tw.squeeze_challenge()
        self.challenges["gamma"] = self.tw.squeeze_challenge()

    def grand_products(self) -> None:
        """Permutation Z per chunk (each chunk's last product carries into
        the next), then lookup Z, then their commitments (phase
        ``prove.grand_products_commit``; the reference leaves the Z passes
        outside the phase, where its device work runs asynchronously into
        it, so here the phase holds them)."""
        circ, vk, u = self.circ, self.pk.vk, self.circ.usable_rows
        bk = FR.from_ints(self.challenges["beta"], self.dev)
        gk = FR.from_ints(self.challenges["gamma"], self.dev)
        names = []
        with _phase(self.metrics, "prove.grand_products_commit"):
            carry = _one(self.dev)
            for j, (chunk, (sig, ident)) in enumerate(
                    zip(vk.perm_chunks, chunk_tables(self.pk))):
                cols = torch.stack([self.evals[c] for c in chunk])
                z, carry = perm_z_pass(cols, sig, ident, bk, gk, carry, u)
                z[circ.n - BLINDING_ROWS:] = _blinds(self.rng, 1, self.dev)[0]
                self.evals[f"perm.z{j}"] = z
                names.append(f"perm.z{j}")
            for i, lk in enumerate(circ.lookups):
                a_cmp, s_cmp, aps, sps = (t[i] for t in self.lk_data)
                z = lookup_z_pass(a_cmp, s_cmp, aps, sps, bk, gk, u)
                z[circ.n - BLINDING_ROWS:] = _blinds(self.rng, 1, self.dev)[0]
                self.evals[f"{lk.name}.z"] = z
                names.append(f"{lk.name}.z")
            self._pre_intt(names)
            for pt in pcs.commit_evals_many(
                    self.params, torch.stack([self.evals[nm]
                                              for nm in names]), MSM_C):
                self.tw.write_point(pt)
        self.challenges["y"] = self.tw.squeeze_challenge()


def create_proof(params: srs.ParamsKZG, pk: ProvingKey,
                 advice_u64: Dict[str, torch.Tensor],
                 instance_u64: Dict[str, torch.Tensor],
                 seed: Optional[int] = None, metrics=None) -> bytes:
    """The proof's bytes through the grand-product commitments: the advice
    points, the A′/S′ points, the permutation then lookup Z points. It
    stops after squeezing y, where the quotient begins.

    advice_u64 / instance_u64: (n, 2) u64 pairs per column (tensors on the
    SRS's device; instance columns may also be numpy). seed: None draws the
    blinds from OS entropy; an int makes them deterministic (tests and
    golden fixtures only)."""
    pr = Prover(params, pk, advice_u64, instance_u64, seed, metrics)
    pr.advice()
    pr.lookups()
    pr.grand_products()
    return pr.tw.finalize()
