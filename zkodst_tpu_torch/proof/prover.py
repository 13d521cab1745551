"""The prover: ``create_proof``, the whole PLONKish IOP on the device.

Counterpart of ``zkodst_tpu/proof/prover.py`` ``create_proof``
(:563-852): the verifying key and the instances enter the transcript,
then the advice commitments, θ, the lookup permutations and the A′/S′
commitments, β and γ, the permutation and lookup grand products Z and
their commitments, y; the quotient h on the extended coset (the
constraint system of :mod:`.constraints` over coset-extended columns) and
its four commitments, x; the evaluations at x·ω^r in ``query_schedule``
order; the multiopen: SHPLONK's W and W′ (KZG), or W and one log-size
opening (IPA). Every commitment and the multiopen go through
:mod:`.pcs`, so ``params`` may be either scheme's.

Blinds come from one ``random.Random(("zkodst-blind", seed))`` drawn in
the reference's order — advice (one tail per column), lookups (A′ then S′
per lookup), permutation Z (one per chunk), lookup Z (one per lookup),
then the IPA multiopen's r_h and its l/m pairs — so the bytes equal the
reference proof's. SHPLONK over KZG draws none.

With a ``mesh`` (``parallel/bootstrap.py``), every rank runs this same
proof on replicated columns (SPMD, where the reference drives its devices
from one process): every commitment shards its points over ``mesh_axis``,
every domain transform runs as the 4-step NTT, and the grand products scan
each rank's rows with a carry across ranks (``prover.py:276-339``); each
such step returns its result replicated, so the proof's bytes are the
single-device ones. The lookup permutations, the constraint evaluation
and the multiopen stay replicated, as in the reference. Without a seed,
rank 0 draws the blind stream's entropy and broadcasts it.
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import secrets
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..circuit.ir import BLINDING_ROWS, CircuitDef, u64_cols_to_field
from ..ops import u64
from ..ops.field import FR
from ..ops.ntt import powers_table
from ..ops.pyfield import FR as PFR
from ..parallel.scan_sharded import carry_fold
from ..utils.timing import host_wait, span, upload
from . import constraints, pcs, shplonk
from .domain import DELTA, EXT_FACTOR, Domain
from .keygen import ProvingKey
from .transcript import Blake2bWrite

# Pippenger window width of every commit in the proof (the reference's)
MSM_C = 13
# columns per coset extension of the quotient (the reference's group)
EXT_GROUP = 15


def _phase(metrics, label: str):
    return (metrics.phase(label) if metrics is not None
            else contextlib.nullcontext())


def _u64_tensor(col, device) -> torch.Tensor:
    """An (n, 2) u64 column (tensor or uint32 numpy) as int64 on `device`."""
    if isinstance(col, torch.Tensor):
        return col.to(device)
    return upload(torch.from_numpy(np.asarray(col).astype(np.int64)), device)


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


def advice_phase(params: pcs.Params, circ: CircuitDef,
                 advice_u64: Dict[str, torch.Tensor], rng: random.Random,
                 tw: Blake2bWrite, metrics=None, mesh=None, mesh_axis="x"):
    """Blind and commit every advice column (phase ``prove.advice_commit``);
    writes one point per column and returns the (A, n, 8) blinded columns
    and, under IPA, their coefficient forms (None under KZG).

    Advice cells are u64 values, so under KZG the body MSM runs only the
    64-bit windows and the full-width blinding tail is a separate small
    MSM (the coefficient forms are made after the phase, with the instance
    columns'); under a mesh the sharded MSM runs full width, as the
    reference's; IPA commits the coefficient forms, full-width scalars."""
    dev = pcs.device(params)
    with _phase(metrics, "prove.advice_commit"):
        with span("prep"):
            blinds = _blinds(rng, len(circ.advice_names), dev)
            evals = _prep_advice(
                torch.stack([advice_u64[name]
                             for name in circ.advice_names]), blinds, circ.n)
            coeffs = (Domain(circ.k).intt(evals) if pcs.is_ipa(params)
                      else None)
        for pt in pcs.commit_columns(params, evals, coeffs, MSM_C,
                                     body_bits=64, tail_rows=BLINDING_ROWS,
                                     mesh=mesh, mesh_axis=mesh_axis):
            tw.write_point(pt)
    return evals, coeffs


def commit_advice(params: pcs.Params, circ: CircuitDef,
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
    with host_wait(2):                      # two boolean masks
        dest[nfrank[fill]] = ids[fill]
    pos_in_t = torch.searchsorted(tk, sk)
    sperm = torch.where(first, perm_tb0[torch.clamp(pos_in_t, max=n - 1)],
                        torch.zeros_like(ids))
    # dest[lrank] with lrank = -1 reads dest[n-1]; only rows kept by `left`
    with host_wait(2):
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


def _grand_product(ratio: torch.Tensor, carry: torch.Tensor, mesh=None,
                   mesh_axis="x"):
    """Z with Z[0] = carry, Z[i] = carry·∏_{j<i} ratio[j], and the carry
    out carry·∏ ratio. ratio (n, 8); carry (8,) Montgomery. With `mesh`,
    ratio is this rank's block of rows: its scan takes the carry of the
    blocks before it (``prover.py:293-305``) and Z is gathered whole."""
    incl = FR.cumprod_incl(ratio)
    if mesh is None:
        out = FR.mul(incl[-1], carry)
    else:
        carry, out = carry_fold(FR, incl[-1], carry, mesh, mesh_axis)
    z = torch.empty_like(ratio)
    z[0] = carry
    z[1:] = FR.mul(incl[:-1], carry)
    if mesh is not None:
        z = mesh.all_gather(z, mesh_axis).reshape(-1, 8)
    return z, out


def _ratio(num: torch.Tensor, den: torch.Tensor, u: int) -> torch.Tensor:
    """num / den on the usable rows, 1 on rows ≥ u."""
    ratio = FR.mul(num, FR.inv_batch(den))
    ratio[u:] = _one(ratio.device)
    return ratio


def _rows(u: int, cols, mesh, mesh_axis):
    """(u, the (…, n, 8) columns) as one grand product reads them: whole,
    or under a mesh this rank's block of rows, with u counted from the
    block's first row."""
    if mesh is None:
        return u, cols
    n = cols[0].shape[-2]
    lo = mesh.index(mesh_axis) * (n // mesh.size(mesh_axis))
    return max(u - lo, 0), [mesh.shard(c, mesh_axis, dim=c.dim() - 2)
                            for c in cols]


def perm_z_pass(cols, sigmas, idents, bk, gk, carry, u: int, mesh=None,
                mesh_axis="x"):
    """One permutation chunk's grand product (``prover.py:201-218``):
    ∏_i (c_i + β·id_i + γ) / (c_i + β·σ_i + γ) over the chunk's columns.

    cols/sigmas/idents: (m, n, 8); bk, gk, carry: (8,). Returns (Z, the
    carry into the next chunk). With `mesh`, the ratios of each rank's
    rows and their scan (``_z_passes_sharded``, :276-339)."""
    u, (cols, sigmas, idents) = _rows(u, (cols, sigmas, idents), mesh,
                                      mesh_axis)
    num_f = FR.add(cols, FR.add(FR.mul(idents, bk), gk))
    den_f = FR.add(cols, FR.add(FR.mul(sigmas, bk), gk))
    num, den = num_f[0], den_f[0]
    for i in range(1, cols.shape[0]):
        num, den = FR.mul(num, num_f[i]), FR.mul(den, den_f[i])
    return _grand_product(_ratio(num, den, u), carry, mesh, mesh_axis)


def lookup_z_pass(a_cmp, s_cmp, ap, sp, bk, gk, u: int, mesh=None,
                  mesh_axis="x"):
    """One lookup's grand product (``prover.py:221-232``):
    (a + β)(s + γ) / (a′ + β)(s′ + γ), starting at 1 (each rank's rows
    with `mesh`)."""
    u, (a_cmp, s_cmp, ap, sp) = _rows(u, (a_cmp, s_cmp, ap, sp), mesh,
                                      mesh_axis)
    num = FR.mul(FR.add(a_cmp, bk), FR.add(s_cmp, gk))
    den = FR.mul(FR.add(ap, bk), FR.add(sp, gk))
    return _grand_product(_ratio(num, den, u), _one(a_cmp.device), mesh,
                          mesh_axis)[0]


def chunk_tables(pk: ProvingKey):
    """Per permutation chunk, its σ columns and identity columns
    δ^col·ω^row: challenge-independent, made once per key."""
    cache = pk.prover_cache
    if "chunk_tables" not in cache:
        vk = pk.vk
        col_of = {c: i for i, c in enumerate(vk.perm_cols)}
        dev = pk.roots.device
        tables = []
        for chunk in vk.perm_chunks:
            gis = [col_of[c] for c in chunk]
            sig = torch.stack([pk.sigma_evals[gi] for gi in gis])
            dk = FR.from_ints([pow(DELTA, gi, FR.p) for gi in gis], dev)
            ident = FR.mul(pk.roots[None], dk[:, None, :])
            tables.append((sig, ident))
        cache["chunk_tables"] = tables
    return cache["chunk_tables"]


# ---------------------------------------------------------------------------
# the transcript's public inputs
# ---------------------------------------------------------------------------

def absorb_instances(tw: Blake2bWrite, circ: CircuitDef,
                     instance_u64: Dict[str, object]) -> None:
    """Bind the public inputs into the transcript; the prover and the
    verifier run the same sequence.

    v1 (``prover.py:391-394``): one blake2b-512 digest (no
    personalization) over every instance column's (n, 2) uint32 bytes in
    ``instance_names`` order, absorbed as one scalar. A circuit without
    instance columns absorbs the digest of the empty input.

    halo2ce: every value of each column's declared ``instance_len``
    prefix, column by column, as a common scalar. Only that prefix is
    bound by the transcript while the verifier evaluates every nonzero
    row, so a column with a nonzero row past it is rejected (ValueError),
    as is a circuit that declares no length for a column."""
    cols = {name: u64.to_u32(instance_u64[name])
            for name in circ.instance_names}
    if tw.mode == "halo2ce":
        for name, col in cols.items():
            ln = circ.instance_len.get(name)
            if ln is None:
                raise ValueError(
                    f"halo2ce mode needs CircuitDef.instance_len[{name!r}] "
                    "(the public-input vector length)")
            if col[ln:].any():
                raise ValueError(
                    f"halo2ce mode: instance column {name!r} has nonzero "
                    f"rows past its declared instance_len={ln} prefix; "
                    "those rows would be unbound by the transcript")
            for v in u64.to_ints(col[:ln]):
                tw.common_scalar(int(v))
        return
    hsh = hashlib.blake2b(digest_size=64)
    for col in cols.values():
        hsh.update(col.tobytes())
    tw.common_scalar(int.from_bytes(hsh.digest(), "little") % FR.p)


# ---------------------------------------------------------------------------
# evaluations
# ---------------------------------------------------------------------------

def eval_many(coeffs_list: List[torch.Tensor], points: List[int]):
    """Evaluate every polynomial at every point -> [M][P] host ints
    (``prover.py:56-130``): per point, its power table (the reference's
    ``powers_dev``, here :func:`..ops.ntt.powers_table`), one product with
    the (M, n) coefficient stack and a sum along n (``field_sum``, here
    :meth:`..ops.field.Field.sum`)."""
    with span("grid"):
        stack = torch.stack(coeffs_list)
        n, dev = stack.shape[1], stack.device
        grid = torch.stack([
            FR.sum(FR.mul(stack, powers_table(FR, x, n, dev)), dim=1)
            for x in points], dim=1)
    with span("read"):
        vals = FR.to_ints(grid)
        return [[int(v) for v in row] for row in vals]


def query_schedule(vk) -> List[Tuple[str, Tuple[int, ...]]]:
    """[(polynomial name, rotations)] in canonical order."""
    circ: CircuitDef = vk.circ
    u = circ.usable_rows
    rots: Dict[str, set] = {}
    for g in circ.gates:
        for col, r in g.poly.vars():
            rots.setdefault(col, set()).add(r)
    out = []
    for name in circ.advice_names:
        out.append((name, tuple(sorted(rots.get(name, set()) | {0}))))
    for name in sorted(circ.fixed):
        out.append((name, tuple(sorted(rots.get(name, set()) | {0}))))
    for i in range(len(vk.perm_cols)):
        out.append((f"perm.sigma{i}", (0,)))
    for lk in circ.lookups:
        out.append((f"{lk.name}.a_perm", (-1, 0)))
        out.append((f"{lk.name}.s_perm", (0,)))
        out.append((f"{lk.name}.z", (0, 1)))
    nz = len(vk.perm_chunks)
    for j in range(nz):
        rr = (0, 1) if j == nz - 1 else (0, 1, u)
        out.append((f"perm.z{j}", rr))
    for i in range(EXT_FACTOR):
        out.append((f"h{i}", (0,)))
    return out


def rotation_point(dom: Domain, x: int, rot: int) -> int:
    return x * pow(dom.omega, rot, PFR.p) % PFR.p


# ---------------------------------------------------------------------------
# the quotient's constraint contexts
# ---------------------------------------------------------------------------

class _RecCtx:
    """Dry-run context: records which columns the constraint system reads
    (host ints, no device work)."""

    def __init__(self):
        self.names = set()
        self.l0 = self.llast = self.active = 1
        self.theta = self.beta = self.gamma = self.y = 1

    def const(self, v):
        return 1

    def get(self, name, rot):
        self.names.add(name)
        return 1

    def identity(self, gi):
        return 1

    def add(self, a, b):
        return 0

    def sub(self, a, b):
        return 0

    def mul(self, a, b):
        return 0


class _ExtCtx:
    """The constraint system over extended-coset columns (4n, 8), eager:
    every add, sub and mul is one launch of kernel 2, 3 or 1. Constants
    and challenges stay (8,) tensors that the kernels read once as
    broadcast operands; a rotation by r rows of H is a roll by r·4 rows
    of the coset, made once per (column, rotation)."""

    def __init__(self, exts: Dict[str, torch.Tensor],
                 sels: Dict[str, torch.Tensor], chal: Dict[str, int],
                 xext: torch.Tensor):
        self.exts = exts
        self.dev = xext.device
        self._rolled: Dict[Tuple[str, int], torch.Tensor] = {}
        self.l0 = sels["l0"]
        self.llast = sels["llast"]
        self.active = FR.sub(FR.sub(self.const(1), self.llast),
                             sels["lblind"])
        for name in ("theta", "beta", "gamma", "y"):
            setattr(self, name, self.const(chal[name]))
        self.xext = xext

    def const(self, v: int) -> torch.Tensor:
        return FR.from_ints(v, self.dev)

    def get(self, name: str, rot: int) -> torch.Tensor:
        key = (name, rot)
        if key not in self._rolled:
            ext = self.exts[name]
            self._rolled[key] = (torch.roll(ext, -rot * EXT_FACTOR, dims=0)
                                 if rot else ext)
        return self._rolled[key]

    def identity(self, gi: int) -> torch.Tensor:
        return FR.mul(self.const(pow(DELTA, gi, PFR.p)), self.xext)

    def add(self, a, b):
        return FR.add(a, b)

    def sub(self, a, b):
        return FR.sub(a, b)

    def mul(self, a, b):
        return FR.mul(a, b)


def quotient_eval(vk, exts, sels, chal, xext) -> torch.Tensor:
    """h on the extended coset: the y-folded constraint numerator times
    1/Z_H (``prover.py:509-518``)."""
    ctx = _ExtCtx(exts, sels, chal, xext)
    numer = constraints.fold_y(ctx, constraints.enumerate_constraints(vk,
                                                                      ctx))
    return FR.mul(numer, sels["zh_inv"])


# ---------------------------------------------------------------------------
# create_proof
# ---------------------------------------------------------------------------

def _entropy(mesh, device) -> bytes:
    """32 bytes of OS entropy for the blind stream; under a mesh rank 0's,
    broadcast, so that every rank writes the same transcript."""
    ent = secrets.token_bytes(32)
    if mesh is None:
        return ent
    got = mesh.broadcast(upload(torch.tensor(list(ent), dtype=torch.uint8),
                                device))
    return bytes(got.cpu().tolist())


class Prover:
    """One proof in progress: the transcript, the blind stream, every
    committed column in evaluation form (``evals``), the coefficient form
    of each column the proof makes (``coeffs``, computed as each phase
    produces its columns) and the opening claims. The phase methods run in
    order; :func:`create_proof` drives them. With a `mesh`, every rank
    makes the same Prover and calls the same phases in the same order."""

    def __init__(self, params: pcs.Params, pk: ProvingKey,
                 advice_u64: Dict[str, torch.Tensor],
                 instance_u64: Dict[str, torch.Tensor],
                 seed: Optional[int] = None, metrics=None,
                 transcript_mode: str = "v1", mesh=None, mesh_axis="x"):
        with span("init"):
            pcs.single_device(params, mesh)
            self.params, self.pk, self.metrics = params, pk, metrics
            self.mesh, self.mesh_axis = mesh, mesh_axis
            self.circ = pk.vk.circ
            self.dom = Domain(self.circ.k)
            self.dev = pcs.device(params)
            self.advice_u64 = advice_u64
            self.rng = random.Random(_entropy(mesh, self.dev) if seed is None
                                     else ("zkodst-blind", seed).__repr__())
            self.tw = Blake2bWrite(transcript_mode)
            self.evals: Dict[str, torch.Tensor] = {}
            self.coeffs: Dict[str, torch.Tensor] = {}
            self.challenges: Dict[str, int] = {}
            pk.vk.hash_into(self.tw)
            absorb_instances(self.tw, self.circ, instance_u64)
            for name in self.circ.instance_names:
                self.evals[name] = u64_cols_to_field(
                    FR, _u64_tensor(instance_u64[name], self.dev))
            for name, fe in pk.fixed_evals.items():
                self.evals[name] = fe
            for i, se in enumerate(pk.sigma_evals):
                self.evals[f"perm.sigma{i}"] = se

    def _pre_intt(self, names: List[str]) -> None:
        """Coefficient forms of final columns, for the quotient and the IPA
        commitments: one batched iNTT per phase, as the reference enqueues
        them, of the columns whose form is not made yet."""
        names = [nm for nm in names if nm not in self.coeffs]
        if names:
            coeffs = self.dom.intt(
                torch.stack([self.evals[nm] for nm in names]),
                mesh=self.mesh, mesh_axis=self.mesh_axis)
            self.coeffs.update(zip(names, coeffs))

    def _commit(self, names: List[str]) -> List:
        """The named columns' commitments, from the form the scheme
        commits."""
        return pcs.commit_columns(self.params,
                                  torch.stack([self.evals[nm]
                                               for nm in names]),
                                  [self.coeffs[nm] for nm in names], MSM_C,
                                  mesh=self.mesh,
                                  mesh_axis=self.mesh_axis)

    def _all_coeffs(self) -> Dict[str, torch.Tensor]:
        """The proof's coefficient forms and the key's (fixed and σ)."""
        out = dict(self.coeffs)
        out.update(self.pk.fixed_coeffs)
        out.update((f"perm.sigma{i}", sc)
                   for i, sc in enumerate(self.pk.sigma_coeffs))
        return out

    def advice(self) -> None:
        circ = self.circ
        # the lookup row permutations depend only on the witness
        u = circ.usable_rows
        with span("lookup_sort"):
            self.lk_perms = {
                lk.name: _lookup_perm_indices(
                    self.advice_u64[lk.input_cols[0]][:, 0],
                    _u64_tensor(circ.fixed[lk.table_cols[0]],
                                self.dev)[:, 0], u)
                for lk in circ.lookups}
        adv, adv_coeffs = advice_phase(self.params, circ, self.advice_u64,
                                       self.rng, self.tw, self.metrics,
                                       self.mesh, self.mesh_axis)
        self.evals.update(zip(circ.advice_names, adv))
        if adv_coeffs is not None:
            self.coeffs.update(zip(circ.advice_names, adv_coeffs))
        with span("intt"):
            self._pre_intt(list(circ.advice_names)
                           + list(circ.instance_names))
        self.challenges["theta"] = self.tw.squeeze_challenge()

    def lookups(self) -> None:
        circ = self.circ
        with _phase(self.metrics, "prove.lookup_permute"):
            self.lk_data = None
            if circ.lookups:
                with span("columns"):
                    blinds = _blinds(self.rng, 2 * len(circ.lookups),
                                     self.dev)
                    self.lk_data = lookup_columns(circ, self.evals,
                                                  self.challenges["theta"],
                                                  self.lk_perms, blinds)
                    _, _, aps, sps = self.lk_data
                    names = []
                    for i, lk in enumerate(circ.lookups):
                        self.evals[f"{lk.name}.a_perm"] = aps[i]
                        self.evals[f"{lk.name}.s_perm"] = sps[i]
                        names += [f"{lk.name}.a_perm", f"{lk.name}.s_perm"]
                with span("intt"):
                    self._pre_intt(names)
                for pt in self._commit(names):
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
        names = []
        with _phase(self.metrics, "prove.grand_products_commit"):
            with span("perm_z"):
                bk = FR.from_ints(self.challenges["beta"], self.dev)
                gk = FR.from_ints(self.challenges["gamma"], self.dev)
                carry = _one(self.dev)
                for j, (chunk, (sig, ident)) in enumerate(
                        zip(vk.perm_chunks, chunk_tables(self.pk))):
                    cols = torch.stack([self.evals[c] for c in chunk])
                    z, carry = perm_z_pass(cols, sig, ident, bk, gk, carry,
                                           u, self.mesh, self.mesh_axis)
                    z[circ.n - BLINDING_ROWS:] = _blinds(self.rng, 1,
                                                         self.dev)[0]
                    self.evals[f"perm.z{j}"] = z
                    names.append(f"perm.z{j}")
            with span("lookup_z"):
                for i, lk in enumerate(circ.lookups):
                    a_cmp, s_cmp, aps, sps = (t[i] for t in self.lk_data)
                    z = lookup_z_pass(a_cmp, s_cmp, aps, sps, bk, gk, u,
                                      self.mesh, self.mesh_axis)
                    z[circ.n - BLINDING_ROWS:] = _blinds(self.rng, 1,
                                                         self.dev)[0]
                    self.evals[f"{lk.name}.z"] = z
                    names.append(f"{lk.name}.z")
            with span("intt"):
                self._pre_intt(names)
            for pt in self._commit(names):
                self.tw.write_point(pt)
        self.challenges["y"] = self.tw.squeeze_challenge()

    def _extend(self, coeffs: Dict[str, torch.Tensor],
                names: List[str]) -> Dict[str, torch.Tensor]:
        """Coset extensions of `names`, EXT_GROUP columns per transform."""
        out = {}
        for i in range(0, len(names), EXT_GROUP):
            grp = names[i: i + EXT_GROUP]
            ext = self.dom.coeff_to_extended(
                torch.stack([coeffs[nm] for nm in grp]), self.mesh,
                self.mesh_axis)
            out.update(zip(grp, ext))
        return out

    def _quotient_exts(self):
        """The coset extensions the constraint system reads, and the
        extended X; the key's share made once per key and mesh."""
        pk, dom, n = self.pk, self.dom, self.dom.n
        coeffs = self._all_coeffs()
        cache = pk.prover_cache
        if "quotient_names" not in cache:
            rec = _RecCtx()
            constraints.enumerate_constraints(pk.vk, rec)
            names = sorted(rec.names)
            e1 = torch.zeros((n, 8), dtype=torch.int32, device=self.dev)
            e1[1] = _one(self.dev)
            static = set(pk.fixed_coeffs) | {
                f"perm.sigma{i}" for i in range(len(pk.sigma_coeffs))}
            cache["quotient_names"] = names
            cache["static_names"] = [nm for nm in names if nm in static]
            cache["xext"] = dom.coeff_to_extended(e1)
            cache["static_exts"] = {}
        by_mesh = cache["static_exts"]
        axis = self.mesh_axis
        key = None if self.mesh is None else (
            self.mesh, axis if isinstance(axis, str) else tuple(axis))
        if key not in by_mesh:
            by_mesh[key] = self._extend(coeffs, cache["static_names"])
        names, static_exts = cache["quotient_names"], by_mesh[key]
        exts = dict(static_exts)
        exts.update(self._extend(
            coeffs, [nm for nm in names if nm not in static_exts]))
        return exts, cache["xext"]

    def quotient(self) -> None:
        """h = numerator / Z_H on the extended coset, its coefficients cut
        into EXT_FACTOR polynomials of n and committed (phase
        ``prove.quotient``, ``prover.py:751-828``). The fixed and σ
        extensions depend on the key alone and are kept with it, one set
        per mesh (``prover.py:781-799``): under a mesh they are made by
        the sharded transforms at its first proof on every rank alike,
        whatever proofs the key served before, so that the ranks'
        collectives stay in one order."""
        pk, dom, n = self.pk, self.dom, self.dom.n
        with _phase(self.metrics, "prove.quotient"):
            with span("extend"):
                exts, xext = self._quotient_exts()
            with span("constraints"):
                chal = {k: self.challenges[k]
                        for k in ("theta", "beta", "gamma", "y")}
                h_ext = quotient_eval(pk.vk, exts, pk.ext_selectors, chal,
                                      xext)
                del exts                 # the extended columns: free them
                self.lk_data = None
            with span("h"):
                h_coeff = dom.extended_to_coeff(
                    h_ext, self.mesh, self.mesh_axis).reshape(EXT_FACTOR, n,
                                                              8)
                del h_ext
                h_evals = dom.ntt(h_coeff, self.mesh, self.mesh_axis)
                for i in range(EXT_FACTOR):
                    self.coeffs[f"h{i}"] = h_coeff[i]
                    self.evals[f"h{i}"] = h_evals[i]
            for pt in pcs.commit_coeff_many(self.params, h_coeff, MSM_C,
                                            self.mesh, self.mesh_axis):
                self.tw.write_point(pt)
        self.challenges["x"] = self.tw.squeeze_challenge()

    def evaluations(self) -> None:
        """Every queried polynomial at x·ω^r, written in ``query_schedule``
        order (phase ``prove.evaluations``); one claim per polynomial."""
        dom, x = self.dom, self.challenges["x"]
        with span("claims"):
            sched = query_schedule(self.pk.vk)
            all_rots = sorted({r for _, rots in sched for r in rots})
            rot_pos = {r: i for i, r in enumerate(all_rots)}
            coeffs = self._all_coeffs()
        with _phase(self.metrics, "prove.evaluations"):
            grid = eval_many([coeffs[name] for name, _ in sched],
                             [rotation_point(dom, x, r) for r in all_rots])
        with span("claims"):
            self.claims = []
            for i, (name, rots) in enumerate(sched):
                evs = [grid[i][rot_pos[r]] for r in rots]
                for e in evs:
                    self.tw.write_scalar(e)
                self.claims.append(shplonk.Claim(
                    tuple(rotation_point(dom, x, r) for r in rots),
                    tuple(evs), evals_dev=self.evals[name]))

    def multiopen(self) -> None:
        """SHPLONK's W and W′, or IPA's W and opening (phase
        ``prove.multiopen``)."""
        with _phase(self.metrics, "prove.multiopen"):
            pcs.open_all(self.params, self.dom, self.claims, self.tw,
                         rng=self.rng)


def create_proof(params: pcs.Params, pk: ProvingKey,
                 advice_u64: Dict[str, torch.Tensor],
                 instance_u64: Dict[str, torch.Tensor],
                 seed: Optional[int] = None, metrics=None,
                 transcript_mode: str = "v1", mesh=None,
                 mesh_axis="x") -> bytes:
    """The proof's bytes: the advice points, the A′/S′ points, the
    permutation then lookup Z points, the four h points, the evaluations
    and the multiopen (SHPLONK's W and W′ over KZG params; W, the 2k L/R
    points and two scalars over IPA params).

    advice_u64 / instance_u64: (n, 2) u64 pairs per column (tensors on the
    SRS's device; instance columns may also be numpy). seed: None draws the
    blinds from OS entropy; an int makes them deterministic (tests and
    golden fixtures only). transcript_mode: "v1" or "halo2ce"
    (:mod:`.transcript`); the verifier must use the same. mesh: a
    :class:`..parallel.bootstrap.Mesh` — every rank calls create_proof
    with the same arguments and gets the same bytes, the single-device
    ones (KZG only: IPA params raise NotImplementedError)."""
    pr = Prover(params, pk, advice_u64, instance_u64, seed, metrics,
                transcript_mode, mesh, mesh_axis)
    pr.advice()
    pr.lookups()
    pr.grand_products()
    pr.quotient()
    pr.evaluations()
    pr.multiopen()
    return pr.tw.finalize()
