"""Kernels 1–5: elementwise field products, sums and differences, and the
prefix product (CUDA source ``cuda/csrc/mulmod.cu``), each beside its
plain PyTorch twin.

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
whole. ``chain_cumprod`` scans runs of S = n/W contiguous elements with a
block per run (several short runs a block); ``cumprod_tile`` scans up to
a few thousand elements in one block. :meth:`..ops.field.Field.cumprod_incl`
chains them with mulmod. Every output is a canonical field value, so a
twin need not repeat its kernel's order of products to agree with it limb
for limb.
"""

from __future__ import annotations

import math

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


def _binop(entry: str, F: Field, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Launch `entry` on broadcast operands a, b of one shape."""
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    (a, pa, da), (b, pb, db) = _operand(a), _operand(b)
    call("mulmod", entry, a.data_ptr(), b.data_ptr(), out.data_ptr(),
         out.numel() // 8, pa, da, pb, db, F.kernel_id)
    return out


# -- kernel 1: a·b·2^-256 mod p -----------------------------------------------

def mulmod_plain(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return to_i32(F.mont_mul64(to_i64(a), to_i64(b)))


def mulmod(F: Field, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 8) Montgomery products (broadcast)."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return mulmod_plain(F, a, b)
    _check("mulmod", a, b)
    return _binop("zk_mulmod", F, a, b)


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

def chain_cumprod_plain(F: Field, x: torch.Tensor, W: int) -> torch.Tensor:
    n = x.shape[0]
    runs = to_i64(x).reshape(W, n // W, 8)
    out = runs.clone()
    for k in range(1, runs.shape[1]):
        out[:, k] = F.mont_mul64(out[:, k - 1], runs[:, k])
    return to_i32(out.reshape(n, 8))


def chain_cumprod(F: Field, x: torch.Tensor, W: int) -> torch.Tensor:
    """(n, 8) -> (n, 8): element e of run l = x[l·S] · … · x[e], with runs
    of S = n/W contiguous elements."""
    _check("chain_cumprod", x)
    if x.dim() != 2 or x.shape[0] % W:
        raise ValueError(f"chain_cumprod takes (n, 8) with n a multiple of "
                         f"W={W}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return chain_cumprod_plain(F, x, W)
    x = _ready(x)
    out = torch.empty_like(x)
    call("mulmod", "zk_chain_cumprod", x.data_ptr(), out.data_ptr(), W,
         x.shape[0] // W, F.kernel_id)
    return out


# -- kernel 5: inclusive prefix product of one short vector -------------------

def cumprod_tile_plain(F: Field, x: torch.Tensor) -> torch.Tensor:
    acc = to_i64(x)
    d = 1
    while d < acc.shape[0]:                     # Hillis–Steele
        acc = torch.cat([acc[:d], F.mont_mul64(acc[d:], acc[:-d])])
        d <<= 1
    return to_i32(acc)


def cumprod_tile(F: Field, x: torch.Tensor) -> torch.Tensor:
    """(m, 8) -> (m, 8) inclusive prefix products, in one block."""
    _check("cumprod_tile", x)
    if x.dim() != 2:
        raise ValueError(f"cumprod_tile takes (m, 8), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return cumprod_tile_plain(F, x)
    x = _ready(x)
    out = torch.empty_like(x)
    call("mulmod", "zk_cumprod_tile", x.data_ptr(), out.data_ptr(),
         x.shape[0], F.kernel_id)
    return out
