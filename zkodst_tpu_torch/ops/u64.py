"""64-bit words as (lo, hi) 32-bit pairs.

Counterpart of ``zkodst_tpu/ops/u64.py``: a word is a tensor whose last
axis has size 2, ``w[..., 0]`` = low and ``w[..., 1]`` = high 32 bits. The
port holds the halves in ``int64`` (values in [0, 2^32)), which keeps every
add, shift and compare exact on CPU and CUDA alike. Host-side constructors
return the reference's uint32 numpy layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import timing

MASK32 = 0xFFFFFFFF


def from_int(x: int) -> np.ndarray:
    """Python int (< 2^64) -> u64 pair [lo, hi] (uint32)."""
    x = int(x) & 0xFFFFFFFFFFFFFFFF
    return np.array([x & MASK32, x >> 32], dtype=np.uint32)


def from_ints(xs) -> np.ndarray:
    """Ints of any nesting -> (..., 2) uint32 array."""
    arr = np.asarray(xs, dtype=object)
    flat = [int(x) & 0xFFFFFFFFFFFFFFFF for x in arr.ravel()]
    lo = np.array([x & MASK32 for x in flat], dtype=np.uint32)
    hi = np.array([x >> 32 for x in flat], dtype=np.uint32)
    return np.stack([lo, hi], axis=-1).reshape(arr.shape + (2,))


def to_ints(w) -> np.ndarray:
    """(..., 2) pairs (numpy or tensor) -> object ndarray of Python ints."""
    if isinstance(w, torch.Tensor):
        w = timing.read(w)
    w = np.asarray(w).astype(np.int64)
    return w[..., 0].astype(object) + w[..., 1].astype(object) * (1 << 32)


def to_u32(w) -> np.ndarray:
    """(..., 2) pairs (tensor or numpy) -> the reference's uint32 numpy
    layout, on the host."""
    if isinstance(w, torch.Tensor):
        w = timing.read(w)
    return np.asarray(w).astype(np.uint32)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^64 on int64-held pairs."""
    lo = a[..., 0] + b[..., 0]
    hi = (a[..., 1] + b[..., 1] + (lo >> 32)) & MASK32
    return torch.stack([lo & MASK32, hi], dim=-1)


def xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_xor(a, b)


def rotr(a: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate right by a static n in [0, 64)."""
    n = int(n) % 64
    lo, hi = a[..., 0], a[..., 1]
    if n == 0:
        return a
    if n >= 32:
        lo, hi = hi, lo
        n -= 32
        if n == 0:
            return torch.stack([lo, hi], dim=-1)
    return torch.stack([((lo >> n) | (hi << (32 - n))) & MASK32,
                        ((hi >> n) | (lo << (32 - n))) & MASK32], dim=-1)


def shl(a: torch.Tensor, n: int) -> torch.Tensor:
    """Left shift (mod 2^64) by a static n in [0, 64)."""
    n = int(n) % 64
    lo, hi = a[..., 0], a[..., 1]
    if n == 0:
        return a
    if n >= 32:
        return torch.stack([torch.zeros_like(lo), (lo << (n - 32)) & MASK32],
                           dim=-1)
    return torch.stack([(lo << n) & MASK32,
                        ((hi << n) | (lo >> (32 - n))) & MASK32], dim=-1)


def to_limbs16(a: torch.Tensor) -> torch.Tensor:
    """u64 pairs (..., 2) -> four 16-bit little-endian limbs (..., 4)."""
    lo, hi = a[..., 0], a[..., 1]
    return torch.stack([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16],
                       dim=-1)


def from_limbs16(limbs: torch.Tensor) -> torch.Tensor:
    """Four 16-bit limbs (..., 4) -> u64 pairs (..., 2)."""
    lo = limbs[..., 0] | (limbs[..., 1] << 16)
    hi = limbs[..., 2] | (limbs[..., 3] << 16)
    return torch.stack([lo, hi], dim=-1)
