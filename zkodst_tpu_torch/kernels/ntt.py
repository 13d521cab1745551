"""Kernels 6 and 7: the radix-2 DIT NTT's tail and head passes (CUDA
source ``cuda/csrc/ntt.cu``), each beside its plain PyTorch twin.

=====================  ===============================================
wrapper                replaces (``zkodst_tpu/pallas/ntt.py``)
=====================  ===============================================
``ntt_tail``           ``_tail_kernel``
``ntt_head``           ``_head_kernel``
=====================  ===============================================

Rows are ``(batch, n, 8)`` int32 Montgomery limbs; ``pw`` is the
``(n/2, 8)`` table w^0 … w^(n/2−1) of the transform's root w. ``ntt_tail``
takes a row in natural order, applies the bit-reversal permutation and
every stage with half-size h < T (the kernel runs them on slabs of T
elements in shared memory); ``ntt_head`` applies the one stage h ≥ T, one
thread per butterfly. :func:`..ops.ntt.ntt` chains one tail and log2(n/T)
heads. The butterfly of half-size h pairs elements i and i + h of each
block of 2h and takes the twiddle w^((n/2h)·j) at offset j in the block.
"""

from __future__ import annotations

import torch

from ..ops.field import Field, to_i32, to_i64
from .build import call
from .mulmod import _check, _ready

TILE = 2048         # slab of the tail kernel: 64 KB of shared memory


def bit_reverse(n: int, device="cpu") -> torch.Tensor:
    """(n,) int64 permutation i -> the bit-reverse of i in log2(n) bits."""
    logn = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _stage64(F: Field, x: torch.Tensor, pw: torch.Tensor, h: int):
    """One butterfly stage of half-size h on (batch, n, 8) int64 limbs."""
    B, n, _ = x.shape
    xv = x.reshape(B, n // (2 * h), 2, h, 8)
    u, v = xv[:, :, 0], xv[:, :, 1]
    tw = pw[(n // (2 * h)) * torch.arange(h, device=x.device)]
    t = F.mont_mul64(v, tw.expand_as(v))
    return torch.stack([F.add64(u, t), F.sub64(u, t)], dim=2).reshape(B, n, 8)


def _check_rows(name: str, x: torch.Tensor, pw: torch.Tensor) -> None:
    _check(name, x, pw)
    n = x.shape[1] if x.dim() == 3 else 0
    if x.dim() != 3 or n & (n - 1) or n < 2 or pw.shape != (n // 2, 8):
        raise ValueError(f"{name}: rows (batch, n, 8) with n a power of two "
                         f"and pw (n/2, 8), got {tuple(x.shape)} and "
                         f"{tuple(pw.shape)}")


# -- kernel 6: bit reversal and the stages h < T ------------------------------

def ntt_tail_plain(F: Field, x: torch.Tensor, pw: torch.Tensor,
                   T: int) -> torch.Tensor:
    y = to_i64(x)[:, bit_reverse(x.shape[1], x.device)]
    p64 = to_i64(pw)
    h = 1
    while h < T:
        y = _stage64(F, y, p64, h)
        h *= 2
    return to_i32(y)


def ntt_tail(F: Field, x: torch.Tensor, pw: torch.Tensor,
             T: int) -> torch.Tensor:
    """(batch, n, 8) natural order -> bit-reversed, then every stage of
    half-size h < T (T a power of two, 2 ≤ T ≤ n)."""
    _check_rows("ntt_tail", x, pw)
    n = x.shape[1]
    if T & (T - 1) or not 2 <= T <= min(n, 2 * TILE):
        raise ValueError(f"ntt_tail: slab T={T} for n={n}")
    if x.device.type == "cpu":
        return ntt_tail_plain(F, x, pw, T)
    x, pw = _ready(x), _ready(pw)
    out = torch.empty_like(x)
    call("ntt", "zk_ntt_tail", x.data_ptr(), out.data_ptr(), pw.data_ptr(),
         x.shape[0], n, T, F.kernel_id)
    return out


# -- kernel 7: one stage h ≥ T ------------------------------------------------

def ntt_head_plain(F: Field, x: torch.Tensor, pw: torch.Tensor,
                   h: int) -> torch.Tensor:
    return to_i32(_stage64(F, to_i64(x), to_i64(pw), h))


def ntt_head(F: Field, x: torch.Tensor, pw: torch.Tensor,
             h: int) -> torch.Tensor:
    """(batch, n, 8) -> the butterflies of half-size h (h < n)."""
    _check_rows("ntt_head", x, pw)
    n = x.shape[1]
    if h & (h - 1) or not 1 <= h < n:
        raise ValueError(f"ntt_head: half-size h={h} for n={n}")
    if x.device.type == "cpu":
        return ntt_head_plain(F, x, pw, h)
    x, pw = _ready(x), _ready(pw)
    out = torch.empty_like(x)
    call("ntt", "zk_ntt_head", x.data_ptr(), out.data_ptr(), pw.data_ptr(),
         x.shape[0], n, h, F.kernel_id)
    return out
