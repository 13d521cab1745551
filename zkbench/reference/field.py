"""BN254's two prime fields in Python ints, and the few field helpers the
plain verifier needs (square roots for point decompression, roots of
unity, batched inversion, a radix-2 inverse NTT)."""

from __future__ import annotations

from typing import List, Optional, Sequence

# scalar field r (the circuit's field) and base field q (point coordinates)
R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47

# a non-square generator of r's multiplicative group (halo2curves' Fr
# MULTIPLICATIVE_GENERATOR), and δ, the generator of its odd-order part:
# the permutation columns live on the cosets δ^c·H
GEN = 7
TWO_ADICITY = 28
DELTA = pow(GEN, 1 << TWO_ADICITY, R)


def sqrt_q(a: int) -> Optional[int]:
    """A square root mod q (q ≡ 3 mod 4), or None."""
    a %= Q
    y = pow(a, (Q + 1) // 4, Q)
    return y if y * y % Q == a else None


SMALLEST_NON_RESIDUE = 5


def root_of_unity(log_order: int) -> int:
    """A primitive 2^log_order-th root of unity of r: t^((r−1)/2^S) for
    the smallest non-residue t, squared down to the order asked for."""
    w = pow(SMALLEST_NON_RESIDUE, (R - 1) >> TWO_ADICITY, R)
    for _ in range(TWO_ADICITY - log_order):
        w = w * w % R
    return w


def powers(base: int, n: int, p: int = R) -> List[int]:
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % p
    return out


def batch_inv(xs: Sequence[int], p: int = R) -> List[int]:
    """Every inverse with one modular exponentiation (no zero allowed)."""
    pref = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        pref[i + 1] = pref[i] * x % p
    inv = pow(pref[-1], -1, p)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = pref[i] * inv % p
        inv = inv * xs[i] % p
    return out


def intt(evals: Sequence[int], omega: int) -> List[int]:
    """Coefficients of the polynomial with these values on ⟨ω⟩ (length a
    power of two): an iterative radix-2 transform with ω⁻¹, scaled by 1/n."""
    n = len(evals)
    a = list(evals)
    j = 0
    for i in range(1, n):                       # bit-reversal permutation
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    winv = pow(omega, -1, R)
    size = 2
    while size <= n:
        half = size // 2
        wstep = pow(winv, n // size, R)
        tw = powers(wstep, half)
        for start in range(0, n, size):
            for k in range(half):
                u = a[start + k]
                v = a[start + k + half] * tw[k] % R
                a[start + k] = (u + v) % R
                a[start + k + half] = (u - v) % R
        size *= 2
    ninv = pow(n, -1, R)
    return [x * ninv % R for x in a]
