"""Number-theoretic transform over limb tensors.

Counterpart of ``zkodst_tpu/ops/ntt.py`` (``powers_table`` :88-98, ``ntt``
:160-192, ``intt`` :195-202). Columns are ``(..., n, 8)`` Montgomery limbs
along axis −2, natural order in and out. A transform is one tail pass
(bit reversal and the stages h < T, kernel 6) and one head pass per
remaining stage (kernel 7); see :mod:`..kernels.ntt`. The coset
transforms (:218-232) scale coefficient i by g^i around them.
"""

from __future__ import annotations

import torch

from ..kernels.ntt import TILE, ntt_head, ntt_tail
from .field import Field

# (field, g, n, device) -> the (n, 8) table g^0 … g^(n−1)
_POW_TABLES: dict = {}


def powers_table(F: Field, g: int, n: int, device="cpu") -> torch.Tensor:
    """[1, g, g², …, g^(n−1)] as (n, 8) Montgomery limbs, made on `device`
    by log-doubling (one broadcast-constant multiply per doubling)."""
    arr = F.from_ints([1, g % F.p], device)
    while arr.shape[0] < n:
        m = arr.shape[0]
        arr = torch.cat([arr, F.mul(arr, F.from_ints(pow(g, m, F.p),
                                                     device))])
    return arr[:n]


def pow_table(F: Field, g: int, n: int, device) -> torch.Tensor:
    """:func:`powers_table`, made once per (field, g, n, device) and
    kept."""
    key = (F.name, g, n, str(device))
    if key not in _POW_TABLES:
        _POW_TABLES[key] = powers_table(F, g, n, device)
    return _POW_TABLES[key]


def _twiddles(F: Field, n: int, w: int, device) -> torch.Tensor:
    """The (n/2, 8) twiddle table w^0 … w^(n/2−1)."""
    return pow_table(F, w, n // 2, device)


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


def coset_scale(F: Field, a: torch.Tensor, g: int,
                inverse: bool = False) -> torch.Tensor:
    """Multiply coefficient i by g^i (g^−i with inverse): a(X) -> a(gX)."""
    gg = pow(g, -1, F.p) if inverse else g % F.p
    return F.mul(a, pow_table(F, gg, a.shape[-2], a.device))


def coset_ntt(F: Field, a: torch.Tensor, w: int, g: int) -> torch.Tensor:
    """Evaluate a(X) over the coset {g·w^i}."""
    return ntt(F, coset_scale(F, a, g), w)


def coset_intt(F: Field, a: torch.Tensor, w: int, g: int) -> torch.Tensor:
    """Coefficients from evaluations over the coset {g·w^i}."""
    return coset_scale(F, intt(F, a, w), g, inverse=True)
