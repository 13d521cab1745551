"""Host-side prime-field reference arithmetic (Python ints).

A copy of ``zkodst_tpu/ops/pyfield.py``: the BN254 and Pasta constants,
the Montgomery radix, roots of unity, square roots (point decompression)
and the int oracles the port's tests and host code use.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

# BN254: Fr = scalar field (circuit/NTT field), Fq = base field (point
# coordinates).
BN254_FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
BN254_FQ = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47

# Pasta: the "pallas" curve's base field and its scalar field (the base
# field of "vesta"); both are just above 2^254, below 2^255.
PALLAS_BASE = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
VESTA_BASE = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

R_BITS = 256            # Montgomery radix R = 2^256


def _two_adicity(n: int) -> int:
    s = 0
    while n % 2 == 0:
        n //= 2
        s += 1
    return s


@dataclass(frozen=True)
class PF:
    """A prime field of odd characteristic, host-side."""

    p: int
    name: str = "PF"

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, self.p - 2, self.p)

    @property
    def r(self) -> int:
        """The Montgomery radix 2^256 reduced mod p."""
        return (1 << R_BITS) % self.p

    @property
    def two_adicity(self) -> int:
        return _two_adicity(self.p - 1)

    def is_square(self, a: int) -> bool:
        return a % self.p == 0 or pow(a, (self.p - 1) // 2, self.p) == 1

    @lru_cache(maxsize=None)
    def smallest_qnr(self) -> int:
        g = 2
        while self.is_square(g):
            g += 1
        return g

    def sqrt(self, a: int):
        """Tonelli–Shanks; returns a root or None."""
        a %= self.p
        if a == 0:
            return 0
        if not self.is_square(a):
            return None
        p = self.p
        s = self.two_adicity
        q = (p - 1) >> s
        z = pow(self.smallest_qnr(), q, p)
        m, c, t, r = s, z, pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r

    def root_of_unity(self, log_order: int) -> int:
        """A primitive 2^log_order-th root of unity: w0 = t^((p-1)/2^S) for
        the smallest non-residue t, squared down to the requested order."""
        s = self.two_adicity
        if log_order > s:
            raise ValueError(f"2-adicity {s} < requested {log_order}")
        w = pow(self.smallest_qnr(), (self.p - 1) >> s, self.p)
        for _ in range(s - log_order):
            w = w * w % self.p
        return w


FR = PF(BN254_FR, "bn254_fr")
FQ = PF(BN254_FQ, "bn254_fq")
