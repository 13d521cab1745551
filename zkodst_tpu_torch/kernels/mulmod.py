"""Kernels 1, 2, 4 and 5: elementwise field products and sums, and the
prefix product (CUDA source ``cuda/csrc/mulmod.cu``), each beside its
plain PyTorch twin.

=====================  ===============================================
wrapper                replaces (``zkodst_tpu/pallas/mulmod.py``)
=====================  ===============================================
``mulmod``             ``_mulmod_kernel`` (via ``mulmod_t``)
``addmod``             ``_addmod_kernel`` (via ``addmod_t``)
``chain_cumprod``      ``_mul_chain_kernel`` (via ``chain_cumprod_t``)
``cumprod_tile``       ``_mul_scan_tile_kernel`` (via ``cumprod_tile_t``)
=====================  ===============================================

mulmod and addmod are bound on the card by memory (96 bytes per element,
64 when the second operand is one broadcast constant, which the kernel
reads once instead of a materialised copy): the R² and raw-1 multipliers
of the witness and MSM scalars, β, γ and the θ powers of the grand
products. ``chain_cumprod`` gives each of W threads a run of S = n/W
contiguous elements; ``cumprod_tile`` scans up to a few thousand elements
in one block. :meth:`..ops.field.Field.cumprod_incl` chains them with
mulmod. Every output is a canonical field value, so a twin need not repeat
its kernel's order of products to agree with it limb for limb.
"""

from __future__ import annotations

import torch

from ..ops.field import Field, to_i32, to_i64
from .build import call


def _ready(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels read uint4 vectors)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _is_const(b: torch.Tensor) -> bool:
    """True if every element of b is the same 8 limbs (a broadcast)."""
    return b.stride(-1) == 1 and all(
        s == 0 or d == 1 for s, d in zip(b.stride()[:-1], b.shape[:-1]))


def _check(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.int32 or x.shape[-1] != 8:
            raise ValueError(f"{name} takes (..., 8) int32, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != xs[0].device:
            raise ValueError(f"{name} operands on different devices")


def _binop(entry: str, F: Field, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    const = _is_const(b)
    a = _ready(a)
    b = _ready(b[(0,) * (b.dim() - 1)] if const else b)
    out = torch.empty_like(a)
    call("mulmod", entry, a.data_ptr(), b.data_ptr(), out.data_ptr(),
         a.numel() // 8, 0 if const else 1, F.kernel_id)
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
