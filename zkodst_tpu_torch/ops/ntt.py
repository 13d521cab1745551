"""Number-theoretic transform over limb tensors.

Counterpart of ``zkodst_tpu/ops/ntt.py`` (``powers_table`` :88-98, ``ntt``
:160-192, ``intt`` :195-202). Columns are ``(..., n, 8)`` Montgomery limbs
along axis −2, natural order in and out. A transform is one tail pass
(bit reversal and the stages h < T, kernel 6) and one head pass per
remaining stage (kernel 7); see :mod:`..kernels.ntt`. The coset transforms
(:218-232) come with the quotient.
"""

from __future__ import annotations

import torch

from ..kernels.ntt import TILE, ntt_head, ntt_tail
from .field import Field

# (field, n, root, device) -> the (n/2, 8) twiddle table
_TWIDDLES: dict = {}


def powers_table(F: Field, g: int, n: int, device="cpu") -> torch.Tensor:
    """[1, g, g², …, g^(n−1)] as (n, 8) Montgomery limbs, made on `device`
    by log-doubling (one broadcast-constant multiply per doubling)."""
    arr = F.from_ints([1, g % F.p], device)
    while arr.shape[0] < n:
        m = arr.shape[0]
        arr = torch.cat([arr, F.mul(arr, F.from_ints(pow(g, m, F.p),
                                                     device))])
    return arr[:n]


def _twiddles(F: Field, n: int, w: int, device) -> torch.Tensor:
    key = (F.name, n, w, str(device))
    if key not in _TWIDDLES:
        _TWIDDLES[key] = powers_table(F, w, n // 2, device)
    return _TWIDDLES[key]


def ntt(F: Field, a: torch.Tensor, w: int) -> torch.Tensor:
    """Forward NTT along axis −2: coefficients -> evaluations a(w^i).

    a: (..., n, 8) Montgomery limbs, n a power of two; w a primitive n-th
    root of unity (Python int, normal form)."""
    shape = a.shape
    n = shape[-2]
    if n == 1:
        return a.clone()
    x = a.reshape(-1, n, 8)
    pw = _twiddles(F, n, w, a.device)
    T = min(TILE, n)
    x = ntt_tail(F, x, pw, T)
    h = T
    while h < n:
        x = ntt_head(F, x, pw, h)
        h *= 2
    return x.reshape(shape)


def intt(F: Field, a: torch.Tensor, w: int) -> torch.Tensor:
    """Inverse NTT along axis −2 (the forward transform with w⁻¹, ÷ n)."""
    n = a.shape[-2]
    out = ntt(F, a, pow(w, -1, F.p))
    return F.mul(out, F.from_ints(pow(n, -1, F.p), a.device))
