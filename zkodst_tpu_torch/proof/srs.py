"""KZG structured reference string and commitments.

Counterpart of ``zkodst_tpu/proof/srs.py``: a testing SRS from a seeded τ
with the monomial basis [τ^i]G and the Lagrange basis [L_i(τ)]G, made on
the device by a fixed-base windowed ladder, and batched commitments of
evaluation-form polynomials (Lagrange basis) and of coefficient-form
polynomials (monomial basis) through the Pippenger MSM, on one device or
with the points sharded over a mesh (:161-193, :240-257).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import curve, msm, pycurve
from ..ops.field import from_limbs16, to_limbs16
from ..ops.pyfield import FR
from ..parallel.msm_sharded import msm_many_sharded_mont
from ..utils.device import resolve
from ..utils.timing import upload
from .domain import Domain

# fixed-base ladder: W windows of C bits cover 256-bit scalars
C, W = 4, 64

# Largest MSM run at once; longer inputs are chunked and the partial sums
# added (the flagship's 2^17 rows are one chunk).
MSM_CHUNK = 1 << 17


@dataclass
class ParamsKZG:
    k: int
    g1: torch.Tensor             # (n, 3, 8) monomial-basis points [τ^i]G
    g1_lagrange: torch.Tensor    # (n, 3, 8) Lagrange-basis points [L_i(τ)]G
    g2: Tuple                    # G2 generator (affine Fq2 ints)
    s_g2: Tuple                  # [τ]G2

    @property
    def n(self) -> int:
        return 1 << self.k


def _batch_inv(vals, p):
    pref = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % p
    inv = pow(pref[-1], -1, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * inv % p
        inv = inv * vals[i] % p
    return out


def _window_table(device) -> torch.Tensor:
    """(W, 2^C, 3, 8) points table[w][d] = d·2^(C·w)·G, built on the host."""
    rows = []
    pw = pycurve.G1_GEN
    for _ in range(W):
        row = [None]
        for _ in range(1, 1 << C):
            row.append(pycurve.G1.add(row[-1], pw))
        rows.append(curve.from_affine_ints(row))
        for _ in range(C):
            pw = pycurve.G1.add(pw, pw)
    return upload(torch.stack(rows), device)


def _nibbles(scalars: List[int], device) -> torch.Tensor:
    """Scalars (< 2^256) -> (W, n) int64 base-2^C digits, LSB window 0."""
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    b = np.frombuffer(raw, np.uint8).reshape(len(scalars), 32)
    d = np.stack([b & 0xF, b >> 4], axis=-1).reshape(len(scalars), W)
    return upload(torch.from_numpy(d.T.astype(np.int64)), device)


def _fixed_base(tbl: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """acc_i = Σ_w tbl[w][digits[w, i]]: one gather and one complete add
    over all n lanes per window (kernel 8 on the card)."""
    n = digits.shape[1]
    acc = curve.identity((n,), tbl.device)
    for w in range(W):
        acc = curve.add(acc, tbl[w][digits[w]])
    return acc


def setup(k: int, seed: int = 0, device=None) -> ParamsKZG:
    """Deterministic testing SRS: the reference's `setup(k, seed)` points."""
    dev = resolve(device)
    p = FR.p
    n = 1 << k
    rng = random.Random(("zkodst-srs", seed, k).__repr__())
    tau = rng.randrange(1, p)

    # scalar tables (host): τ^i, and L_i(τ) = ω^i (τ^n − 1) / (n (τ − ω^i))
    w = Domain(k).omega
    taupow = [1] * n
    for i in range(1, n):
        taupow[i] = taupow[i - 1] * tau % p
    zh = (pow(tau, n, p) - 1) % p
    wpow = [1] * n
    for i in range(1, n):
        wpow[i] = wpow[i - 1] * w % p
    dinv = _batch_inv([n * (tau - wpow[i]) % p for i in range(n)], p)
    lag = [wpow[i] * zh % p * dinv[i] % p for i in range(n)]

    tbl = _window_table(dev)
    g1 = _fixed_base(tbl, _nibbles(taupow, dev))
    g1_lagrange = _fixed_base(tbl, _nibbles(lag, dev))
    s_g2 = pycurve.G2.mul(pycurve.G2_GEN, tau)
    return ParamsKZG(k=k, g1=g1, g1_lagrange=g1_lagrange,
                     g2=pycurve.G2_GEN, s_g2=s_g2)


def from_numpy(g1, g1_lagrange, g2, s_g2, device=None) -> ParamsKZG:
    """The reference's SRS arrays ((n, 3, 16) 16-bit limbs) -> ParamsKZG."""
    dev = resolve(device)
    g1 = from_limbs16(g1, dev)
    k = g1.shape[0].bit_length() - 1
    return ParamsKZG(k=k, g1=g1, g1_lagrange=from_limbs16(g1_lagrange, dev),
                     g2=g2, s_g2=s_g2)


def _ints_to_u32(vals, nlimbs: int = 8) -> np.ndarray:
    """Nested int tuples -> uint32 limb array, last axis = nlimbs (LE)."""
    arr = np.asarray(vals, dtype=object)
    out = np.zeros(arr.shape + (nlimbs,), np.uint32)
    for idx in np.ndindex(arr.shape):
        v = int(arr[idx])
        for j in range(nlimbs):
            out[idx + (j,)] = (v >> (32 * j)) & 0xFFFFFFFF
    return out


def _u32_to_ints(arr: np.ndarray):
    """uint32 limb array (last axis LE) -> nested tuples of ints."""
    if arr.ndim == 1:
        return sum(int(x) << (32 * j) for j, x in enumerate(arr))
    return tuple(_u32_to_ints(a) for a in arr)


def load(path: str, device=None) -> ParamsKZG:
    """Read an SRS saved by :func:`save` or the reference's (.npz)."""
    with np.load(path, allow_pickle=False) as z:
        return from_numpy(z["g1"], z["g1_lagrange"],
                          _u32_to_ints(z["g2_u32"]),
                          _u32_to_ints(z["s_g2_u32"]), device)


def save(params: ParamsKZG, path: str) -> None:
    """Write the SRS in the reference's format (points as (n, 3, 16)
    16-bit limbs), uncompressed (as ``keygen.save``), through a temporary
    file that replaces `path` whole."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(
        tmp, k=params.k, g1=to_limbs16(params.g1),
        g1_lagrange=to_limbs16(params.g1_lagrange),
        g2_u32=_ints_to_u32(params.g2), s_g2_u32=_ints_to_u32(params.s_g2))
    os.replace(tmp, path)


def get_or_create(k: int, cache_dir: str = ".zkodst_cache", seed: int = 0,
                  device=None) -> ParamsKZG:
    """The SRS of (k, seed) from ``srs_bn254_k<k>[_s<seed>].npz`` in
    `cache_dir`, made with :func:`setup` and written there when the file
    is missing; a file that cannot be read is made again and
    overwritten."""
    os.makedirs(cache_dir, exist_ok=True)
    sfx = f"_s{seed}" if seed else ""
    path = os.path.join(cache_dir, f"srs_bn254_k{k}{sfx}.npz")
    if os.path.exists(path):
        try:
            return load(path, device)
        except (KeyError, ValueError, OSError) as ex:
            print(f"# stale SRS cache {path} ({type(ex).__name__}): "
                  "regenerating", flush=True)
    params = setup(k, seed=seed, device=device)
    save(params, path)
    return params


def commit_lagrange_many(params: ParamsKZG, evals_batch: torch.Tensor,
                         c: int = 13, body_bits: Optional[int] = None,
                         tail_rows: int = 0, mesh=None,
                         mesh_axis="x") -> list:
    """Commit B evaluation-form polynomials -> list of B affine points.

    evals_batch: (B, n, 8) Fr Montgomery limbs. With `body_bits`, the first
    n − tail_rows rows are bounded by 2^body_bits (u64 witness cells): the
    body MSM zeroes the tail rows and runs only ceil(body_bits / c)
    windows, and the tail_rows full-width rows (blinds) go through a small
    separate MSM whose sums are added on. With `mesh`, the points are
    sharded over `mesh_axis` (``parallel/msm_sharded.py``), full width: the
    reference drops the body split there (``prover.py:655``)."""
    g1l = params.g1_lagrange
    if mesh is not None:
        return curve.to_affine_ints(msm_many_sharded_mont(
            g1l, evals_batch, mesh, mesh_axis, c))
    n = evals_batch.shape[1]
    body = evals_batch
    if body_bits is not None and tail_rows:
        body = evals_batch.clone()
        body[:, n - tail_rows:] = 0
    bits = msm.SCALAR_BITS if body_bits is None else body_bits
    accs = None
    for i in range(0, n, MSM_CHUNK):
        part = msm.msm_many_mont(g1l[i: i + MSM_CHUNK],
                                 body[:, i: i + MSM_CHUNK], c, bits)
        accs = part if accs is None else curve.add(accs, part)
    if body_bits is not None and tail_rows:
        tail = msm.msm_many_mont(g1l[n - tail_rows:],
                                 evals_batch[:, n - tail_rows:], c)
        accs = curve.add(accs, tail)
    return curve.to_affine_ints(accs)


def commit_coeff_many(params: ParamsKZG, coeffs_batch: torch.Tensor,
                      c: int = 13, mesh=None, mesh_axis="x") -> list:
    """Commit B coefficient-form polynomials (B, m, 8), m ≤ n, over the
    monomial basis [τ^i]G -> list of B affine points (``srs.py:240-271``,
    chunked as ``_msm_chunked`` :133-145; with `mesh`, the points sharded
    over `mesh_axis`)."""
    m = coeffs_batch.shape[1]
    if mesh is not None:
        return curve.to_affine_ints(msm_many_sharded_mont(
            params.g1[:m], coeffs_batch, mesh, mesh_axis, c))
    accs = None
    for i in range(0, m, MSM_CHUNK):
        part = msm.msm_many_mont(params.g1[i: min(i + MSM_CHUNK, m)],
                                 coeffs_batch[:, i: i + MSM_CHUNK], c)
        accs = part if accs is None else curve.add(accs, part)
    return curve.to_affine_ints(accs)


def commit_coeff(params: ParamsKZG, coeffs: torch.Tensor, c: int = 13):
    """Commit one coefficient-form polynomial (m, 8) -> affine point."""
    return commit_coeff_many(params, coeffs[None], c)[0]
