"""Multi-scalar multiplication (Pippenger) over packed points.

Counterpart of the packed chained-scan path of ``zkodst_tpu/ops/msm.py``
(``msm`` :385-484, ``_chain_window`` :341-381, ``_seg_scan_chains``
:220-243, ``_seg_scan_chained_full`` :246-273, ``_weighted_total_packed``
:276-297), batched over B scalar vectors and all windows at once:

  per window:  sort (digit, index) -> gather points chain-major
               -> chain scan (kernel 11) + chain-aggregate scan (kernel 10)
               -> bucket sums gathered at each digit's last sorted row,
                  cross-chain carries applied (kernel 9)
               -> Σ d·B_d via two suffix-sum scans (kernels 11, 10, 9)
  combine:     Σ_w 2^(c·w)·S_w (kernel 12)

Sorting, gathers, ``searchsorted`` and ``cumsum`` are glue, as in the
reference. Inputs of any N are padded with identity points and zero
scalars to a multiple of 128 lanes (below that, to a power of two of at
least 16), which adds only zero-digit rows (bucket 0 has weight 0).
"""

from __future__ import annotations

import torch

from ..kernels.ec import chain_scan_local, scale_reduce, seg_scan_tiles, \
    seg_step
from . import curve
from .field import FR, MASK32

SCALAR_BITS = 254
_MAX_TILE = 2048            # widest flat scan run by one seg_scan_tiles


def _digits(scalars: torch.Tensor, c: int, nwin: int) -> torch.Tensor:
    """(B, N, 8) normal-form limbs -> (B, nwin, N) int64 c-bit digits, all
    windows at once. A window whose bits straddle two 32-bit limbs takes
    its high part from the next limb; windows past bit 255 are zero."""
    limbs = torch.nn.functional.pad(scalars.to(torch.int64) & MASK32, (0, 2))
    bit = torch.arange(nwin, device=scalars.device) * c
    limb = torch.clamp(bit // 32, max=8)
    off = bit % 32
    d = (limbs[..., limb] >> off) | (limbs[..., limb + 1] << (32 - off))
    return (d & ((1 << c) - 1)).transpose(1, 2)


def _chain_w(n: int) -> int:
    """Chain count W of the chained scan: the widest power of two up to
    2048 that leaves each chain at least two elements (2048 at n = 2^17)."""
    w = 2048
    while w > 1 and (n % w or n // w < 2):
        w //= 2
    if w == 1:
        raise ValueError(f"no chain width for n={n}")
    return w


def _idp(batch: int, n: int, device) -> torch.Tensor:
    """(batch, 24, n) packed identity points."""
    return curve.pack(curve.identity((n,), device)).expand(batch, 24, n)


def _seg_scan_flat(pt: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan of rows of ≤ 2048 lanes: one tile."""
    if pt.shape[2] > _MAX_TILE:
        raise ValueError(f"flat scan of {pt.shape[2]} > {_MAX_TILE} lanes")
    return seg_scan_tiles(pt, starts)


def _seg_scan_chains(pt, starts, W: int):
    """Chained segmented scan of chain-major points: returns the per-chain
    local scan and each chain's exclusive cross-chain carry (batch, 24, W)."""
    B, _, n = pt.shape
    S = n // W
    local = chain_scan_local(pt, starts, W)
    agg = local[:, :, (S - 1) * W:]
    aggf = starts.reshape(B, S, W).any(dim=1)          # chain has a start
    incl = _seg_scan_flat(agg, aggf)
    carry = torch.cat([_idp(B, 1, pt.device), incl[:, :, :-1]], dim=2)
    return local, carry


def _first_start(sw: torch.Tensor) -> torch.Tensor:
    """(..., W, S) flags -> position of each chain's first start (S if
    none)."""
    S = sw.shape[-1]
    first = torch.argmax(sw.to(torch.int8), dim=-1)
    return torch.where(sw.any(dim=-1), first, torch.full_like(first, S))


def _seg_scan_chained_full(pt, starts, W: int):
    """Full segmented inclusive scan in natural order through the chained
    kernel; chain l covers the natural range [l·S, (l+1)·S)."""
    B, _, n = pt.shape
    S = n // W

    def cm(a):
        return a.reshape(a.shape[:-1] + (W, S)).transpose(-1, -2) \
            .reshape(a.shape)

    def nat(a):
        return a.reshape(a.shape[:-1] + (S, W)).transpose(-1, -2) \
            .reshape(a.shape)

    local, carry = _seg_scan_chains(cm(pt).contiguous(), cm(starts), W)
    sw = starts.reshape(B, W, S)
    s_of = torch.arange(n, device=pt.device) % S
    needs = s_of < torch.repeat_interleave(_first_start(sw), S, dim=-1)
    carry_full = torch.repeat_interleave(carry, S, dim=-1)
    return seg_step(nat(local).contiguous(), carry_full, ~needs)


def _weighted_total(buckets: torch.Tensor) -> torch.Tensor:
    """Σ_{d≥1} d·B_d of packed (batch, 24, nb) buckets via suffix sums
    S_j = Σ_{d≥j} B_d, total = Σ_{j≥1} S_j. Returns (batch, 24, 1)."""
    B, _, nb = buckets.shape
    first = torch.zeros((B, nb), dtype=torch.bool, device=buckets.device)
    first[:, 0] = True

    def seg_scan(pt):
        if nb >= 2048 and nb % 512 == 0:
            return _seg_scan_chained_full(pt, first, 512)
        return _seg_scan_flat(pt, first)

    suffix = seg_scan(buckets.flip(-1).contiguous()).flip(-1)
    tmp = torch.cat([_idp(B, 1, buckets.device), suffix[:, :, 1:]], dim=2)
    return seg_scan(tmp.contiguous())[:, :, -1:]


def _windows(pts_packed, skeys, sidx, c: int, W: int):
    """All windows of all batches at once on the chained path.

    pts_packed (24, N); skeys/sidx (R, N) sorted digits and their point
    indices, R = batch·windows. Returns the (R, 24, 1) window totals."""
    R, N = skeys.shape
    S = N // W
    dev = skeys.device
    starts = torch.ones_like(skeys, dtype=torch.bool)
    starts[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    # chain-major layout: chain l owns sorted rows [l·S, (l+1)·S)
    sidx_p = sidx.reshape(R, W, S).transpose(1, 2).reshape(R, N)
    starts_p = starts.reshape(R, W, S).transpose(1, 2).reshape(R, N)
    g = pts_packed[:, sidx_p].permute(1, 0, 2).contiguous()   # (R, 24, N)
    local, carry = _seg_scan_chains(g, starts_p, W)
    del g

    nb = 1 << c
    d = torch.arange(nb, device=dev, dtype=skeys.dtype).expand(R, nb)
    right = torch.searchsorted(skeys.contiguous(), d.contiguous(),
                               right=True)
    left = torch.cat([torch.zeros_like(right[:, :1]), right[:, :-1]], dim=1)
    present = right > left
    tj = torch.clamp(right - 1, min=0)
    tl, ts = tj // S, tj % S                    # chain, position in chain
    idx = (ts * W + tl)[:, None, :].expand(R, 24, nb)
    vals = torch.gather(local, 2, idx)
    del local
    # the carry applies iff the tail's segment began in an earlier chain
    fs = _first_start(starts.reshape(R, W, S))
    needs = ts < torch.gather(fs, 1, tl)
    cvals = torch.gather(carry, 2, tl[:, None, :].expand(R, 24, nb))
    vals = seg_step(vals, cvals, ~needs)
    vals = torch.where(present[:, None, :], vals, _idp(R, nb, dev))
    return _weighted_total(vals.contiguous())


def msm_many(points: torch.Tensor, scalars: torch.Tensor, c: int = 8,
             scalar_bits: int = SCALAR_BITS) -> torch.Tensor:
    """B MSMs over the same points: Σ_i scalars[b, i]·points[i].

    points (N, 3, 8) projective; scalars (B, N, 8) NORMAL-form limbs (< 2^256,
    only the low `scalar_bits` bits are read). Returns (B, 3, 8)."""
    N = points.shape[0]
    B = scalars.shape[0]
    dev = points.device
    # wide windows pay only when 2^c is small next to N (floor 4)
    c = min(c, max(4, N.bit_length() - 1))
    nwin = (scalar_bits + c - 1) // c
    n = -(-N // 128) * 128 if N > 128 else max(16, 1 << (N - 1).bit_length())
    if n != N:
        points = torch.cat([points, curve.identity((n - N,), dev)])
        scalars = torch.cat([scalars, torch.zeros(
            (B, n - N, 8), dtype=scalars.dtype, device=dev)], dim=1)
    W = _chain_w(n)
    logn = max(1, (n - 1).bit_length())
    digs = _digits(scalars, c, nwin).reshape(B * nwin, n)
    keys = (digs << logn) | torch.arange(n, device=dev)
    skp = torch.sort(keys, dim=1).values        # keys are unique
    skeys, sidx = skp >> logn, skp & ((1 << logn) - 1)
    pts_packed = curve.pack(points)[0]                     # (24, n)
    sums = _windows(pts_packed, skeys, sidx, c, W)         # (B·nwin, 24, 1)
    ws = sums.reshape(B, nwin, 24).transpose(1, 2).contiguous()
    return curve.unpack(scale_reduce(ws, c)[:, :, None])[:, 0]


def msm(points: torch.Tensor, scalars: torch.Tensor, c: int = 8,
        scalar_bits: int = SCALAR_BITS) -> torch.Tensor:
    """Σ_i scalars[i]·points[i]: (N, 3, 8), (N, 8) normal form -> (3, 8)."""
    return msm_many(points, scalars[None], c, scalar_bits)[0]


def to_normal(mont: torch.Tensor) -> torch.Tensor:
    """Fr Montgomery limbs -> normal form (Montgomery multiply by raw 1)."""
    one_raw = torch.zeros(8, dtype=torch.int32, device=mont.device)
    one_raw[0] = 1
    return FR.mul(mont, one_raw.expand_as(mont))


def msm_many_mont(points, mont_batch, c: int = 8,
                  scalar_bits: int = SCALAR_BITS):
    """msm_many with Fr Montgomery scalars (converted first)."""
    return msm_many(points, to_normal(mont_batch), c, scalar_bits)
