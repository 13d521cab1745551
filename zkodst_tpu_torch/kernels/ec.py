"""Kernels 8–12: BN254 G1 kernels on packed points (CUDA source
``cuda/csrc/ec.cu``), each beside its plain PyTorch twin.

Packed points are ``(batch, 24, n)`` int32 (see :mod:`..ops.curve`), flags
``(batch, n)`` bool. The twins repeat the kernels' association of
additions and doublings, so kernel and twin agree limb for limb.

=====================  ===============================================
wrapper                replaces (``zkodst_tpu/pallas/ec.py``)
=====================  ===============================================
``ec_add``             ``_ec_add_kernel`` (via ``ec_add_t``)
``seg_step``           ``_seg_step_kernel`` (via ``seg_step_t``)
``seg_scan_tiles``     ``_seg_scan_tile_kernel`` (via ``seg_scan_tiles``)
``chain_scan_local``   ``_chain_scan_kernel`` (via ``chain_scan_local``)
``scale_reduce``       ``_scale_reduce_kernel`` (via ``scale_reduce``)
=====================  ===============================================

Two outputs of the TPU kernels have no consumer on the MSM path and are
not produced here: the saturated flag rows of ``_seg_step_kernel`` and
``_seg_scan_tile_kernel`` (the MSM derives its own segment flags).
``scale_reduce`` takes the ``nlive`` window sums directly instead of a
128-lane block padded with identities, and combines them by Horner with
the complete doubling (``dbl_limbs``), the JAX msm's own association.
"""

from __future__ import annotations

import torch

from ..ops.curve import add_limbs, dbl_limbs, lanes64
from ..ops.field import to_i32
from .build import call

SCAN_THREADS = 256          # runs per row in seg_scan_tiles (≤ 256)


def _packed(y: torch.Tensor) -> torch.Tensor:
    """(batch, n, 3, 8) int64 limb values -> (batch, 24, n) int32."""
    return to_i32(y.reshape(y.shape[0], y.shape[1], 24)
                  .transpose(1, 2)).contiguous()


def _check_points(*xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != 24:
            raise ValueError(f"packed points must be (batch, 24, n) int32, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != xs[0].device:
            raise ValueError("operands on different devices")


def _flags(f: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if f.shape != (like.shape[0], like.shape[2]):
        raise ValueError(f"flags {tuple(f.shape)} do not match points "
                         f"{tuple(like.shape)}")
    return f.to(device=like.device, dtype=torch.uint8).contiguous()


# -- kernel 8: o = p + q ----------------------------------------------------

def ec_add_plain(p, q):
    return _packed(add_limbs(lanes64(p), lanes64(q)))


def ec_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    _check_points(p, q)
    if p.shape != q.shape:
        raise ValueError(f"ec_add shapes {tuple(p.shape)} {tuple(q.shape)}")
    if p.device.type == "cpu":
        return ec_add_plain(p, q)
    p, q = p.contiguous(), q.contiguous()
    out = torch.empty_like(p)
    call("ec", "zk_ec_add", p.data_ptr(), q.data_ptr(), out.data_ptr(),
         p.shape[0], p.shape[2])
    return out


# -- kernel 9: o = keep ? p : p + q -------------------------------------------

def seg_step_plain(p, q, keep):
    pl = lanes64(p)
    s = add_limbs(pl, lanes64(q))
    return _packed(torch.where(keep.bool()[..., None, None], pl, s))


def seg_step(p: torch.Tensor, q: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    _check_points(p, q)
    keep = _flags(keep, p)
    if p.device.type == "cpu":
        return seg_step_plain(p, q, keep)
    p, q = p.contiguous(), q.contiguous()
    out = torch.empty_like(p)
    call("ec", "zk_seg_step", p.data_ptr(), q.data_ptr(), keep.data_ptr(),
         out.data_ptr(), p.shape[0], p.shape[2])
    return out


# -- kernel 11: per-chain segmented scan ----------------------------------------

def chain_scan_local_plain(p, f, W: int):
    B, _, n = p.shape
    S = n // W
    pts = lanes64(p).reshape(B, S, W, 3, 8)
    fl = f.bool().reshape(B, S, W)
    out = torch.empty_like(pts)
    acc = pts[:, 0]
    out[:, 0] = acc
    for k in range(1, S):
        x = pts[:, k]
        acc = torch.where(fl[:, k, :, None, None], x, add_limbs(acc, x))
        out[:, k] = acc
    return _packed(out.reshape(B, n, 3, 8))


def chain_scan_local(p: torch.Tensor, f: torch.Tensor, W: int) -> torch.Tensor:
    """Segmented inclusive scan of each chain l = lanes l, W+l, 2W+l, ...;
    a chain's head starts a segment. f: segment-start flags."""
    _check_points(p)
    f = _flags(f, p)
    if p.shape[2] % W:
        raise ValueError(f"n={p.shape[2]} is not a multiple of W={W}")
    if p.device.type == "cpu":
        return chain_scan_local_plain(p, f, W)
    p = p.contiguous()
    out = torch.empty_like(p)
    call("ec", "zk_chain_scan", p.data_ptr(), f.data_ptr(), out.data_ptr(),
         p.shape[0], p.shape[2], W)
    return out


# -- kernel 10: segmented scan of a row as one tile -------------------------------

def _runs(n: int) -> int:
    return min(SCAN_THREADS, n)


def seg_scan_tiles_plain(p, f):
    B, _, n = p.shape
    nthr = _runs(n)
    run = n // nthr
    pts = lanes64(p).reshape(B, nthr, run, 3, 8)
    fl = f.bool().reshape(B, nthr, run)
    out = torch.empty_like(pts)
    acc = pts[:, :, 0]
    out[:, :, 0] = acc
    has = fl[:, :, 0].clone()
    for k in range(1, run):
        x = pts[:, :, k]
        acc = torch.where(fl[:, :, k, None, None], x, add_limbs(acc, x))
        out[:, :, k] = acc
        has |= fl[:, :, k]
    d = 1
    while d < nthr:                      # Hillis–Steele over the runs
        me, mh = acc[:, d:], has[:, d:]
        new = torch.where(mh[..., None, None], me, add_limbs(acc[:, :-d], me))
        acc = torch.cat([acc[:, :d], new], dim=1)
        has = torch.cat([has[:, :d], mh | has[:, :-d]], dim=1)
        d <<= 1
    if nthr > 1:                         # exclusive carry of earlier runs
        before = torch.cumsum(fl[:, 1:].to(torch.int32), dim=-1) == 0
        tail = out[:, 1:]
        carried = add_limbs(acc[:, :-1, None].expand_as(tail), tail)
        out[:, 1:] = torch.where(before[..., None, None], carried, tail)
    return _packed(out.reshape(B, n, 3, 8))


def seg_scan_tiles(p: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan of each row, run as one tile (one block);
    a row's first lane starts a segment."""
    _check_points(p)
    f = _flags(f, p)
    n = p.shape[2]
    if n % _runs(n):
        raise ValueError(f"a row of {n} lanes must be a multiple of "
                         f"{SCAN_THREADS} above it")
    if p.device.type == "cpu":
        return seg_scan_tiles_plain(p, f)
    p = p.contiguous()
    out = torch.empty_like(p)
    call("ec", "zk_seg_scan_tiles", p.data_ptr(), f.data_ptr(),
         out.data_ptr(), p.shape[0], n, _runs(n))
    return out


# -- kernel 12: Σ_w 2^(c·w)·P_w ---------------------------------------------------

def scale_reduce_plain(ws, c: int):
    pts = lanes64(ws)                    # (B, nlive, 3, 8)
    acc = pts[:, -1]
    for w in range(pts.shape[1] - 2, -1, -1):
        for _ in range(c):
            acc = dbl_limbs(acc)
        acc = add_limbs(acc, pts[:, w])
    return _packed(acc[:, None])[:, :, 0]


def scale_reduce(ws: torch.Tensor, c: int) -> torch.Tensor:
    """ws (batch, 24, nlive) window sums -> (batch, 24) Σ_w 2^(c·w)·ws_w."""
    _check_points(ws)
    if ws.device.type == "cpu":
        return scale_reduce_plain(ws, c)
    ws = ws.contiguous()
    out = torch.empty(ws.shape[:2], dtype=torch.int32, device=ws.device)
    call("ec", "zk_scale_reduce", ws.data_ptr(), out.data_ptr(),
         ws.shape[0], ws.shape[2], c)
    return out

