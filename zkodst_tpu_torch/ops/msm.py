"""Multi-scalar multiplication (Pippenger) over packed points.

Counterpart of the packed chained-scan path of ``zkodst_tpu/ops/msm.py``
(``msm`` :385-484, ``_chain_window`` :341-381, ``_seg_scan_chains``
:220-243, ``_seg_scan_chained_full`` :246-273 (here in chain-major order,
``_seg_scan_chained``), ``_weighted_total_packed`` :276-297), batched
over B scalar vectors and all windows at once:

  per window:  sort (digit, index)
               -> chain scan (kernel 11, each point read through the
                  sorted index) + chain-aggregate scan (kernel 10)
               -> bucket sums gathered at each digit's last sorted row,
                  cross-chain carries applied in place (kernel 9)
               -> Σ d·B_d via a suffix-sum scan (kernels 11, 10, 9) and
                  the sum of the suffix sums (kernels 11, 10, 8)
  combine:     Σ_w 2^(c·w)·S_w (kernel 12)

Sorting, the bucket tails' gather and ``searchsorted`` are glue, as in
the reference; the points are not gathered per window: kernel 11 reads
them from the MSM's own (n, 3, 8) table. Inputs of any N are padded with
identity points and zero scalars to a multiple of 128 lanes (below that,
to a power of two of at least 16), which adds only zero-digit rows
(bucket 0 has weight 0).

One path for both curves of the port: BN254 G1 (the default) and the
Pasta pallas curve of the IPA backend, whose MSMs the reference runs as a
per-lane double-and-add (``zkodst_tpu/proof/ipa.py`` ``_msm_mont_cfg``);
an MSM is a group element, so the two give the same point. ``curve``
picks the kernels' instance and the identity; the scalars' width
defaults to the curve's scalar field (254 bits on BN254, 255 on pallas).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.ec import chain_scan_local, ec_add, scale_reduce, \
    seg_scan_tiles, seg_step
from ..utils.timing import span
from .curve import BN254, Curve, pack, unpack
from .field import FR, MASK32

SCALAR_BITS = 254           # BN254's scalar field
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


def _sort_windows(scalars: torch.Tensor, c: int, nwin: int):
    """(B, n, 8) scalars -> (skeys, sidx), (B·nwin, n) int64: each window's
    c-bit digits sorted, and their point indices (ties in index order)."""
    B, n, _ = scalars.shape
    logn = max(1, (n - 1).bit_length())
    digs = _digits(scalars, c, nwin).reshape(B * nwin, n)
    keys = (digs << logn) | torch.arange(n, device=scalars.device)
    skp = torch.sort(keys, dim=1).values        # keys are unique
    return skp >> logn, skp & ((1 << logn) - 1)


def _starts(skeys: torch.Tensor) -> torch.Tensor:
    """Segment starts of sorted digit rows: a row's first element and each
    that differs from the one before it."""
    starts = torch.ones_like(skeys, dtype=torch.bool)
    starts[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    return starts


def _chain_w(n: int) -> int:
    """Chain count W of the chained scan: the widest power of two up to
    2048 that leaves each chain at least two elements (2048 at n = 2^17)."""
    w = 2048
    while w > 1 and (n % w or n // w < 2):
        w //= 2
    if w == 1:
        raise ValueError(f"no chain width for n={n}")
    return w


def _idp(batch: int, n: int, device, curve: Curve) -> torch.Tensor:
    """(batch, 24, n) packed identity points."""
    return pack(curve.identity((n,), device)).expand(batch, 24, n)


def _seg_scan_flat(pt: torch.Tensor, starts: torch.Tensor,
                   curve: Curve) -> torch.Tensor:
    """Segmented inclusive scan of rows of ≤ 2048 lanes: one tile."""
    if pt.shape[2] > _MAX_TILE:
        raise ValueError(f"flat scan of {pt.shape[2]} > {_MAX_TILE} lanes")
    return seg_scan_tiles(pt, starts, curve=curve)


def _seg_scan_chains(pt, starts, W: int, curve: Curve, index=None):
    """Chained segmented scan: returns the per-chain local scan (chain-major)
    and each chain's exclusive cross-chain carry (batch, 24, W). pt and
    starts chain-major, or (`index`) pt the (n, 3, 8) point table read
    through `index` and starts in the index's order (chain l the rows'
    elements [l·S, (l+1)·S))."""
    B, n = starts.shape
    S = n // W
    local = chain_scan_local(pt, starts, W, curve=curve, index=index)
    agg = local[:, :, (S - 1) * W:]
    aggf = (starts.reshape(B, S, W).any(dim=1) if index is None
            else starts.reshape(B, W, S).any(dim=2))   # chain has a start
    incl = _seg_scan_flat(agg, aggf, curve)
    carry = torch.cat([_idp(B, 1, local.device, curve), incl[:, :, :-1]],
                      dim=2)
    return local, carry


def _first_start(sw: torch.Tensor) -> torch.Tensor:
    """(..., W, S) flags -> position of each chain's first start (S if
    none)."""
    S = sw.shape[-1]
    first = torch.argmax(sw.to(torch.int8), dim=-1)
    return torch.where(sw.any(dim=-1), first, torch.full_like(first, S))


def _seg_scan_chained(pt, starts, W: int, curve: Curve):
    """Full segmented inclusive scan of chain-major points (chain l covers
    the natural range [l·S, (l+1)·S), its s-th element at s·W + l; starts
    in the same order), in chain-major order: the per-chain scan, and each
    chain's carry added in place by kernel 9 to its elements before its
    first start."""
    B, _, n = pt.shape
    local, carry = _seg_scan_chains(pt, starts, W, curve)
    fs = _first_start(starts.reshape(B, n // W, W).transpose(1, 2))
    return seg_step(local, carry, curve=curve, fs=fs, out=local)


def _weighted_total(buckets: torch.Tensor, curve: Curve) -> torch.Tensor:
    """Σ_{d≥1} d·B_d of packed (batch, 24, nb) buckets via suffix sums
    S_j = Σ_{d≥j} B_d, total = Σ_{j≥1} S_j. Returns (batch, 24, 1)."""
    B, _, nb = buckets.shape
    dev = buckets.device
    first = torch.zeros((B, nb), dtype=torch.bool, device=dev)
    first[:, 0] = True
    if nb < 2048 or nb % 512:
        suffix = _seg_scan_flat(buckets.flip(-1).contiguous(), first,
                                curve).flip(-1)
        tmp = torch.cat([_idp(B, 1, dev, curve), suffix[:, :, 1:]], dim=2)
        return _seg_scan_flat(tmp.contiguous(), first, curve)[:, :, -1:]
    # the chained scans in chain-major order throughout, of the reversed
    # buckets (their flags are `first` in either order)
    W = 512
    rev = buckets.reshape(B, 24, W, nb // W).transpose(2, 3).flip((2, 3)) \
        .reshape(B, 24, nb)
    suffix = _seg_scan_chained(rev, first, W, curve)
    # [0, S_1, ..., S_{nb-1}] chain-major is the chain-major suffix sums
    # reversed, with the identity at 0; Σ_j S_j is the scan's last element
    # alone: chain W − 1's local total plus its carry (it has no start)
    tmp = suffix.flip(-1)
    tmp[:, :, :1] = _idp(B, 1, dev, curve)
    local, carry = _seg_scan_chains(tmp, first, W, curve)
    return ec_add(local[:, :, -1:], carry[:, :, -1:], curve=curve)


def _windows(points, skeys, sidx, c: int, W: int, curve: Curve):
    """All windows of all batches at once on the chained path.

    points (N, 3, 8); skeys/sidx (R, N) sorted digits and their point
    indices, R = batch·windows. Chain l of a row owns its sorted elements
    [l·S, (l+1)·S), which kernel 11 reads through sidx. Returns the
    (R, 24, 1) window totals."""
    R, N = skeys.shape
    S = N // W
    dev = skeys.device
    starts = _starts(skeys)
    local, carry = _seg_scan_chains(points, starts, W, curve, index=sidx)

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
    # the carry of chain tl applies iff the tail's segment began in an
    # earlier chain: in place, each tail reading its chain's carry; an
    # absent digit's sum is the identity below, so it adds nothing
    fs = _first_start(starts.reshape(R, W, S))
    keep = ~present | (ts >= torch.gather(fs, 1, tl))
    seg_step(vals, carry, keep, curve, out=vals, q_index=tl)
    vals = torch.where(present[:, None, :], vals, _idp(R, nb, dev, curve))
    return _weighted_total(vals.contiguous(), curve)


def msm_many(points: torch.Tensor, scalars: torch.Tensor, c: int = 8,
             scalar_bits: Optional[int] = None,
             curve: Curve = BN254) -> torch.Tensor:
    """B MSMs over the same points of `curve`: Σ_i scalars[b, i]·points[i].

    points (N, 3, 8) projective; scalars (B, N, 8) NORMAL-form limbs (< 2^256,
    only the low `scalar_bits` bits are read: by default the width of the
    curve's scalar field). Returns (B, 3, 8). Opens the span ``msm``, which
    counts the points times the batch and the windows, from the shapes."""
    if scalar_bits is None:
        scalar_bits = curve.SF.p.bit_length()
    N = points.shape[0]
    B = scalars.shape[0]
    dev = points.device
    # wide windows pay only when 2^c is small next to N (floor 4)
    c = min(c, max(4, N.bit_length() - 1))
    nwin = (scalar_bits + c - 1) // c
    with span("msm", points=N * B, windows=B * nwin):
        n = -(-N // 128) * 128 if N > 128 \
            else max(16, 1 << (N - 1).bit_length())
        if n != N:
            points = torch.cat([points, curve.identity((n - N,), dev)])
            scalars = torch.cat([scalars, torch.zeros(
                (B, n - N, 8), dtype=scalars.dtype, device=dev)], dim=1)
        skeys, sidx = _sort_windows(scalars, c, nwin)
        # the window sums, (B·nwin, 24, 1)
        sums = _windows(points, skeys, sidx, c, _chain_w(n), curve)
        ws = sums.reshape(B, nwin, 24).transpose(1, 2).contiguous()
        return unpack(scale_reduce(ws, c, curve=curve)[:, :, None])[:, 0]


def msm(points: torch.Tensor, scalars: torch.Tensor, c: int = 8,
        scalar_bits: Optional[int] = None,
        curve: Curve = BN254) -> torch.Tensor:
    """Σ_i scalars[i]·points[i]: (N, 3, 8), (N, 8) normal form -> (3, 8)."""
    return msm_many(points, scalars[None], c, scalar_bits, curve)[0]


def to_normal(mont: torch.Tensor) -> torch.Tensor:
    """Fr Montgomery limbs -> normal form (Montgomery multiply by raw 1)."""
    one_raw = torch.zeros(8, dtype=torch.int32, device=mont.device)
    one_raw[:1].fill_(1)                    # a fill on the device
    return FR.mul(mont, one_raw.expand_as(mont))


def msm_many_mont(points, mont_batch, c: int = 8,
                  scalar_bits: Optional[int] = None):
    """msm_many with Fr Montgomery scalars (converted first)."""
    return msm_many(points, to_normal(mont_batch), c, scalar_bits)
