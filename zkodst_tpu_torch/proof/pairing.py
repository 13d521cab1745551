"""BN254 optimal-ate pairing on the host (Python ints).

A copy of ``zkodst_tpu/proof/pairing.py`` over the port's
:mod:`..ops.pycurve` and :mod:`..ops.pyfield`: the verifier's pairing
check. Verification is cheap and stays on the host; only proving runs on
the card.

Tower: Fq2 = Fq[u]/(u²+1), Fq6 = Fq2[v]/(v³−ξ) with ξ = 9+u,
Fq12 = Fq6[w]/(w²−v). G2 points are untwisted into E(Fq12) via
(x, y) ↦ (x·w², y·w³), then a textbook Miller loop over 6x+2 with affine
line functions and a plain final exponentiation ((p¹²−1)/r by square and
multiply).
"""

from __future__ import annotations

from ..ops.pycurve import G2 as G2_GROUP
from ..ops.pycurve import G2_GEN, R_ORDER, Group
from ..ops.pyfield import FQ

P = FQ.p

# BN parameter x: p(x) = 36x⁴+36x³+24x²+6x+1, r(x) = 36x⁴+36x³+18x²+6x+1.
BN_X = 4965661367192848881
ATE_LOOP = 6 * BN_X + 2

assert 36 * BN_X**4 + 36 * BN_X**3 + 24 * BN_X**2 + 6 * BN_X + 1 == P
assert 36 * BN_X**4 + 36 * BN_X**3 + 18 * BN_X**2 + 6 * BN_X + 1 == R_ORDER


# ---------------------------------------------------------------------------
# Fq12 tower (tuples of tuples; no classes on the hot path)
# ---------------------------------------------------------------------------

def _f2(c0=0, c1=0):
    return (c0 % P, c1 % P)


F2_ZERO, F2_ONE = _f2(), _f2(1)
XI = _f2(9, 1)


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return (a[0] * d % P, (-a[1] * d) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul_xi(a):
    """ξ·a with ξ = 9+u: (9a0 − a1, a0 + 9a1)."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    # Karatsuba-style (Toom) combination with v³ = ξ
    c0 = f2_add(t0, f2_mul_xi(f2_sub(
        f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_v(a):
    """v·(a0 + a1 v + a2 v²) = ξ·a2 + a0 v + a1 v²."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_mul(a0, a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))),
               f2_mul(a0, c0))
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


F12_ZERO = (F6_ZERO, F6_ZERO)
F12_ONE = (F6_ONE, F6_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0, t1 = f6_mul(a0, b0), f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_v(t1))                   # w² = v
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_inv(a):
    a0, a1 = a
    t = f6_sub(f6_mul(a0, a0), f6_mul_v(f6_mul(a1, a1)))
    tinv = f6_inv(t)
    return (f6_mul(a0, tinv), f6_neg(f6_mul(a1, tinv)))


def f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_mul(base, base)
        e >>= 1
    return out


def f12_scalar(c0: int):
    """Embed Fq into Fq12."""
    return (((c0 % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def f12_eq(a, b):
    return a == b


# w^k basis elements for the untwist map
_W = (F6_ZERO, F6_ONE)                                 # w
_W2 = f12_mul(_W, _W)
_W3 = f12_mul(_W2, _W)


def untwist(q):
    """E'(Fq2) affine point -> E(Fq12): (x·w², y·w³)."""
    if q is None:
        return None
    (x, y) = q
    xe = ((x, F2_ZERO, F2_ZERO), F6_ZERO)
    ye = ((y, F2_ZERO, F2_ZERO), F6_ZERO)
    return (f12_mul(xe, _W2), f12_mul(ye, _W3))


# E(Fq12) group ops (b = 3 embedded)
_G12 = Group(f12_add, f12_sub, f12_mul, f12_inv, f12_neg,
             lambda a, k: f12_mul(a, f12_scalar(k)),
             F12_ZERO, F12_ONE, f12_scalar(3))


def _embed_g1(p):
    if p is None:
        return None
    return (f12_scalar(p[0]), f12_scalar(p[1]))


def _line(t, r, p):
    """Evaluate the line through t, r (E(Fq12) affine) at p."""
    (x1, y1), (x2, y2) = t, r
    xp, yp = p
    if x1 == x2 and y1 == y2:
        lam = f12_mul(f12_mul(f12_scalar(3), f12_mul(x1, x1)),
                      f12_inv(f12_mul(f12_scalar(2), y1)))
    elif x1 == x2:
        return f12_sub(xp, x1)                       # vertical line
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    return f12_sub(f12_sub(yp, y1), f12_mul(lam, f12_sub(xp, x1)))


def _frob12(a):
    """Frobenius x ↦ x^p on an E(Fq12) point, via generic pow."""
    def fp(e):
        return f12_pow(e, P)
    return (fp(a[0]), fp(a[1]))


def miller_loop(q, p):
    """f_{6x+2,Q}(P) with the two optimal-ate Frobenius corrections."""
    if q is None or p is None:
        return F12_ONE
    qq = untwist(q)
    pp = _embed_g1(p)
    f = F12_ONE
    t = qq
    for bit in bin(ATE_LOOP)[3:]:
        f = f12_mul(f12_mul(f, f), _line(t, t, pp))
        t = _G12.add(t, t)
        if bit == "1":
            f = f12_mul(f, _line(t, qq, pp))
            t = _G12.add(t, qq)
    q1 = _frob12(qq)
    q2 = _G12.neg(_frob12(q1))
    f = f12_mul(f, _line(t, q1, pp))
    t = _G12.add(t, q1)
    f = f12_mul(f, _line(t, q2, pp))
    return f


_FINAL_EXP = (P**12 - 1) // R_ORDER


def pairing(q, p):
    """e(P, Q): G1 × G2 -> μ_r ⊂ Fq12 (q = G2 affine/Fq2, p = G1 affine)."""
    return f12_pow(miller_loop(q, p), _FINAL_EXP)


def pairing_check(pairs) -> bool:
    """∏ e(P_i, Q_i) == 1 for [(g1_point, g2_point), ...].

    Products of Miller loops share one final exponentiation."""
    acc = F12_ONE
    for (g1, g2) in pairs:
        acc = f12_mul(acc, miller_loop(g2, g1))
    return f12_pow(acc, _FINAL_EXP) == F12_ONE


__all__ = ["pairing", "pairing_check", "miller_loop", "untwist",
           "BN_X", "ATE_LOOP", "G2_GEN", "G2_GROUP"]
