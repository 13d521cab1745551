"""Kernels 1–5: elementwise field products, sums and differences, and the
prefix product (CUDA source ``cuda/csrc/mulmod.cu``), each beside its
plain PyTorch twin. Kernels 1–3 take any of the four fields of
:mod:`..ops.field` (BN254's two and the two Pasta fields: a launch on a
Pasta field counts as ``zk_mulmod[pasta_fp]`` and so on); kernels 4 and 5
take BN254's alone.

=====================  ===============================================
wrapper                replaces (``zkodst_tpu/pallas/mulmod.py``)
=====================  ===============================================
``mulmod``             ``_mulmod_kernel`` (via ``mulmod_t``)
``addmod``             ``_addmod_kernel`` (via ``addmod_t``)
``submod``             ``_submod_kernel`` (via ``submod_t``)
``chain_cumprod``      ``_mul_chain_kernel`` (via ``chain_cumprod_t``)
``cumprod_tile``       ``_mul_scan_tile_kernel`` (via ``cumprod_tile_t``)
=====================  ===============================================

mulmod, addmod and submod are bound on the card by memory (96 bytes per
element, 64 when one operand is broadcast, which the kernel reads in
place instead of a materialised copy). Each operand is read through a
period and a divisor: output element i reads element (i / div) mod period
of the operand's held elements. That covers a broadcast constant (the R²
and raw-1 multipliers of the witness and MSM scalars, β, γ and the θ
powers of the grand products, the quotient's ``1 − l_last`` and
``0 − x``), a column broadcast over leading dimensions (SHPLONK's ω^j
against every claim) and a value per row of a leading dimension (the
carry of each run of ``cumprod_incl``, SHPLONK's coefficient per claim).
:data:`OPERAND_COPIES` counts the operands that the wrappers still copy
whole. mulmod and cumprod_tile write into ``out`` where the caller gives
one (the buffers of :meth:`..ops.field.Field.inv_batch`). ``chain_cumprod``
scans runs of S = n/W contiguous elements with a block per run (several
short runs a block); ``cumprod_tile`` scans up to :data:`TILE_MAX`
elements read in place at a stride (the run totals of ``chain_cumprod``)
on a thread-block cluster. Both scan either way (``reverse``: suffix
products) and ``cumprod_tile`` can leave each element out of its own
product (``exclusive``). :meth:`..ops.field.Field.cumprod_incl` chains
them with mulmod. Every output is a canonical field value, so a twin need
not repeat its kernel's order of products to agree with it limb for limb.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.field import Field, to_i32, to_i64
from .build import call


def _ready(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels read uint4 vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


# Operands of a binop launch copied whole since the last reset: "broadcast"
# (an operand with a stride-0 dimension that could not be read in place)
# and "strided" (an operand without one whose elements are not contiguous).
OPERAND_COPIES = {"broadcast": 0, "strided": 0}


def _operand(x: torch.Tensor):
    """(tensor of m elements, m, div) such that element i of the broadcast
    x is element (i // div) mod m of the tensor. The dimensions of x that
    hold more than one value must be one block, with broadcast (stride-0)
    or size-1 dimensions before it (the period) and after it (the
    divisor); the block is copied only if it is not contiguous (a value
    per claim taken from a wider table: m elements). Any other layout is
    copied whole and counted in OPERAND_COPIES."""
    dims, strides = x.shape[:-1], x.stride()[:-1]
    real = [j for j, (d, st) in enumerate(zip(dims, strides))
            if d > 1 and st != 0]
    if not real:
        return _ready(x[(0,) * len(dims)]), 1, 1
    a, b = real[0], real[-1] + 1
    if x.stride(-1) == 1 and all(strides[j] != 0 or dims[j] == 1
                                 for j in range(a, b)):
        block = x[(0,) * a + (slice(None),) * (b - a) + (0,) * (len(dims) - b)]
        period, div = block.numel() // 8, math.prod(dims[b:])
        if block.is_contiguous() or block.numel() < x.numel():
            return _ready(block), period, div
    kind = "broadcast" if 0 in strides else "strided"
    OPERAND_COPIES[kind] += 1
    return _ready(x), x.numel() // 8, 1


def _check(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.int32 or x.shape[-1] != 8:
            raise ValueError(f"{name} takes (..., 8) int32, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != xs[0].device:
            raise ValueError(f"{name} operands on different devices")


def _output(name: str, out, shape, device) -> torch.Tensor:
    """A new (shape) int32 tensor, or `out` checked to be one the kernels
    can write: that shape, contiguous, 16-byte aligned, on `device`. It
    must not overlap an input."""
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=device)
    if (out.dtype != torch.int32 or tuple(out.shape) != tuple(shape)
            or out.device != device or not out.is_contiguous()
            or (out.device.type == "cuda" and out.data_ptr() % 16)):
        raise ValueError(f"{name}: out must be a contiguous, aligned int32 "
                         f"{tuple(shape)} tensor on {device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    return out


def _into(out, result: torch.Tensor) -> torch.Tensor:
    """A twin's result, written into `out` where the caller gave one."""
    return result if out is None else out.copy_(result)


def field_tag(F: Field):
    """The launch count's tag of a binop on F: None for BN254's fields, the
    field's name for a Pasta field."""
    return None if F.kernel_id < 2 else F.name


def _bn254_only(name: str, F: Field) -> None:
    if F.kernel_id > 1:
        raise ValueError(f"{name} is built for BN254's fields alone, not "
                         f"{F.name}")


def _binop(entry: str, F: Field, a: torch.Tensor, b: torch.Tensor,
           out=None) -> torch.Tensor:
    """Launch `entry` on broadcast operands a, b of one shape."""
    out = _output(entry, out, a.shape, a.device)
    if out.numel() == 0:
        return out
    (a, pa, da), (b, pb, db) = _operand(a), _operand(b)
    call("mulmod", entry, a.data_ptr(), b.data_ptr(), out.data_ptr(),
         out.numel() // 8, pa, da, pb, db, F.kernel_id, tag=field_tag(F))
    return out


# -- kernel 1: a·b·2^-256 mod p -----------------------------------------------

def mulmod_plain(F: Field, a: torch.Tensor, b: torch.Tensor,
                 out=None) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return _into(out, to_i32(F.mont_mul64(to_i64(a), to_i64(b))))


def mulmod(F: Field, a: torch.Tensor, b: torch.Tensor,
           out=None) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 8) Montgomery products (broadcast), in
    `out` where given."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return mulmod_plain(F, a, b, out=out)
    _check("mulmod", a, b)
    return _binop("zk_mulmod", F, a, b, out)


# -- kernel 2: (a + b) mod p --------------------------------------------------

def addmod_plain(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return to_i32(F.add64(to_i64(a), to_i64(b)))


def addmod(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 8) field sums (broadcast)."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return addmod_plain(F, a, b)
    _check("addmod", a, b)
    return _binop("zk_addmod", F, a, b)


# -- kernel 3: (a − b) mod p --------------------------------------------------

def submod_plain(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return to_i32(F.sub64(to_i64(a), to_i64(b)))


def submod(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 8) field differences (broadcast)."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return submod_plain(F, a, b)
    _check("submod", a, b)
    return _binop("zk_submod", F, a, b)


# -- kernel 4: the products along each run of S contiguous elements -----------

def chain_cumprod_plain(F: Field, x: torch.Tensor, W: int,
                        reverse: bool = False) -> torch.Tensor:
    n = x.shape[0]
    runs = to_i64(x).reshape(W, n // W, 8)
    if reverse:
        runs = runs.flip(1)
    out = runs.clone()
    for k in range(1, runs.shape[1]):
        out[:, k] = F.mont_mul64(out[:, k - 1], runs[:, k])
    if reverse:
        out = out.flip(1)
    return to_i32(out.reshape(n, 8))


def chain_cumprod(F: Field, x: torch.Tensor, W: int,
                  reverse: bool = False) -> torch.Tensor:
    """(n, 8) -> (n, 8): element e of run l = x[l·S] · … · x[e], with runs
    of S = n/W contiguous elements; with `reverse`, x[e] · … ·
    x[(l+1)·S − 1] (the run's total at its head)."""
    _check("chain_cumprod", x)
    if x.dim() != 2 or x.shape[0] % W:
        raise ValueError(f"chain_cumprod takes (n, 8) with n a multiple of "
                         f"W={W}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return chain_cumprod_plain(F, x, W, reverse)
    _bn254_only("chain_cumprod", F)
    x = _ready(x)
    out = torch.empty_like(x)
    call("mulmod", "zk_chain_cumprod", x.data_ptr(), out.data_ptr(), W,
         x.shape[0] // W, int(reverse), F.kernel_id)
    return out


# -- kernel 5: the prefix product of a short vector read at a stride ----------

TILE_PER = 2            # elements a thread (kTilePer)
TILE_MAX = 2048         # elements a call: 32 warps of a cluster (kTileMax)
TILE_CLUSTER = 8        # blocks of the cluster at TILE_MAX (at most 16)


def tile_layout(m: int):
    """(cluster, threads a block) of a cumprod_tile launch on m elements:
    TILE_PER elements a thread, whole warps, the cluster as near
    TILE_CLUSTER blocks as the warps allow (a power of two)."""
    warps = max(1, -(-m // (32 * TILE_PER)))
    cluster = 1
    while cluster * 2 <= min(TILE_CLUSTER, warps):
        cluster *= 2
    return cluster, 32 * -(-warps // cluster)


def tile_serial_products(m: int) -> int:
    """Products in series in a cumprod_tile launch on m elements: a
    thread's two elements, the warp's 5 shuffle levels, the scan of the
    call's warp totals, and the last product (12 at m = 2048)."""
    cluster, threads = tile_layout(m)
    return 1 + 5 + (cluster * threads // 32 - 1).bit_length() + 1


def _tile_m(x: torch.Tensor, m, stride: int, offset: int) -> int:
    """The element count of a cumprod_tile call, checked: m elements of x
    at offset, offset + stride, … must lie inside x."""
    _check("cumprod_tile", x)
    if x.dim() != 2:
        raise ValueError(f"cumprod_tile takes (n, 8), got {tuple(x.shape)}")
    m = x.shape[0] if m is None else m
    if (m < 0 or m > TILE_MAX or stride < 1 or offset < 0
            or (m and offset + (m - 1) * stride >= x.shape[0])):
        raise ValueError(f"cumprod_tile: {m} elements at offset {offset}, "
                         f"stride {stride} of {x.shape[0]} (at most "
                         f"{TILE_MAX} elements)")
    return m


def cumprod_tile_plain(F: Field, x: torch.Tensor, m=None, stride: int = 1,
                       offset: int = 0, reverse: bool = False,
                       exclusive: bool = False, out=None) -> torch.Tensor:
    m = _tile_m(x, m, stride, offset)
    acc = to_i64(x[offset:offset + m * stride:stride])
    if reverse:
        acc = acc.flip(0)
    d = 1
    while d < m:                                # Hillis–Steele
        acc = torch.cat([acc[:d], F.mont_mul64(acc[d:], acc[:-d])])
        d <<= 1
    if exclusive and m:
        one = torch.tensor(F.ONE.astype(np.int64), device=acc.device)[None]
        acc = torch.cat([one, acc[:-1]])
    if reverse:
        acc = acc.flip(0)
    return _into(out, to_i32(acc))


def cumprod_tile(F: Field, x: torch.Tensor, m=None, stride: int = 1,
                 offset: int = 0, reverse: bool = False,
                 exclusive: bool = False, out=None) -> torch.Tensor:
    """(n, 8) -> (m, 8): the products of the m elements x[offset + i·stride]
    (m = n by default) through each element, in order (``reverse``: from
    each element to the last; ``exclusive``: without the element itself),
    in one cluster launch; into `out` where given."""
    m = _tile_m(x, m, stride, offset)
    if x.device.type == "cpu":
        return cumprod_tile_plain(F, x, m, stride, offset, reverse,
                                  exclusive, out)
    _bn254_only("cumprod_tile", F)
    x = _ready(x)
    out = _output("cumprod_tile", out, (m, 8), x.device)
    if m == 0:
        return out
    cluster, threads = tile_layout(m)
    call("mulmod", "zk_cumprod_tile", x.data_ptr(), out.data_ptr(), m,
         stride, offset, int(reverse), int(exclusive), threads, cluster,
         F.kernel_id)
    return out
