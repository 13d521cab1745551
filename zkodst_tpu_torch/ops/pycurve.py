"""Host-side BN254 curve reference arithmetic (Python ints).

A copy of ``zkodst_tpu/ops/pycurve.py``: the affine G1/G2 oracle used by
the SRS setup (window tables, [τ]G2), point compression and the tests,
and the Pasta "pallas" curve of the IPA backend.

G1: y^2 = x^3 + 3 over Fq, generator (1, 2).
G2: y^2 = x^3 + 3/(9+u) over Fq2 = Fq[u]/(u^2+1).
PASTA_G1: y^2 = x^3 + 5 over PALLAS_BASE, scalar field VESTA_BASE,
cofactor 1, generator (−1, 2).
"""

from __future__ import annotations

from .pyfield import FQ, FR, PALLAS_BASE, VESTA_BASE

P = FQ.p
R_ORDER = FR.p  # group order of G1/G2 subgroups

B1 = 3


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P,
            (a[0] * b[1] + a[1] * b[0]) % P)


def fq2_smul(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fq2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return (a[0] * d % P, (-a[1] * d) % P)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)

B2 = fq2_mul((3, 0), fq2_inv((9, 1)))

G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

G1_GEN = (1, 2)


class Group:
    """Short-Weierstrass group ops in affine coordinates; points are (x, y)
    tuples or None for the identity."""

    def __init__(self, add, sub, mul, inv, neg, smul, zero, one, b,
                 order: int = R_ORDER):
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.finv, self.fneg, self.fsmul = inv, neg, smul
        self.fzero, self.fone, self.b = zero, one, b
        self.order = order

    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        lhs = self.fmul(y, y)
        rhs = self.fadd(self.fmul(self.fmul(x, x), x), self.b)
        return lhs == rhs

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 != y2 or y1 == self.fzero:
                return None
            lam = self.fmul(self.fsmul(self.fmul(x1, x1), 3),
                            self.finv(self.fsmul(y1, 2)))
        else:
            lam = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        x3 = self.fsub(self.fsub(self.fmul(lam, lam), x1), x2)
        y3 = self.fsub(self.fmul(lam, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def neg(self, p):
        if p is None:
            return None
        return (p[0], self.fneg(p[1]))

    # Jacobian internals for scalar multiplication: one inversion per mul
    # instead of one per addition (dbl-2009-l / add-2007-bl, a = 0).
    def _jdbl(self, pt):
        X1, Y1, Z1 = pt
        mul, add, sub, smul = self.fmul, self.fadd, self.fsub, self.fsmul
        A = mul(X1, X1)
        B = mul(Y1, Y1)
        C = mul(B, B)
        t = sub(sub(mul(add(X1, B), add(X1, B)), A), C)
        D = smul(t, 2)
        E = smul(A, 3)
        F = mul(E, E)
        X3 = sub(F, smul(D, 2))
        Y3 = sub(mul(E, sub(D, X3)), smul(C, 8))
        Z3 = smul(mul(Y1, Z1), 2)
        return (X3, Y3, Z3)

    def _jadd(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        mul, add, sub, smul = self.fmul, self.fadd, self.fsub, self.fsmul
        Z1Z1 = mul(Z1, Z1)
        Z2Z2 = mul(Z2, Z2)
        U1 = mul(X1, Z2Z2)
        U2 = mul(X2, Z1Z1)
        S1 = mul(mul(Y1, Z2), Z2Z2)
        S2 = mul(mul(Y2, Z1), Z1Z1)
        H = sub(U2, U1)
        if H == self.fzero:
            if S1 == S2:
                return self._jdbl(p)
            return None
        I = mul(smul(H, 2), smul(H, 2))
        J = mul(H, I)
        r = smul(sub(S2, S1), 2)
        V = mul(U1, I)
        X3 = sub(sub(mul(r, r), J), smul(V, 2))
        Y3 = sub(mul(r, sub(V, X3)), smul(mul(S1, J), 2))
        Z3 = mul(sub(sub(mul(add(Z1, Z2), add(Z1, Z2)), Z1Z1), Z2Z2), H)
        return (X3, Y3, Z3)

    def mul(self, p, k: int):
        k %= self.order
        if p is None or k == 0:
            return None
        acc, base = None, (p[0], p[1], self.fone)
        while k:
            if k & 1:
                acc = self._jadd(acc, base)
            if k != 1:
                base = self._jdbl(base)
            k >>= 1
        if acc is None or acc[2] == self.fzero:
            return None
        zinv = self.finv(acc[2])
        zinv2 = self.fmul(zinv, zinv)
        return (self.fmul(acc[0], zinv2),
                self.fmul(acc[1], self.fmul(zinv2, zinv)))


def _fq_smul(a, k):
    return a * k % P


G1 = Group(lambda a, b: (a + b) % P, lambda a, b: (a - b) % P,
           lambda a, b: a * b % P, lambda a: pow(a, P - 2, P),
           lambda a: (-a) % P, _fq_smul, 0, 1, B1)

G2 = Group(fq2_add, fq2_sub, fq2_mul, fq2_inv, fq2_neg, fq2_smul,
           FQ2_ZERO, FQ2_ONE, B2)

_PP = PALLAS_BASE
PASTA_G1 = Group(lambda a, b: (a + b) % _PP, lambda a, b: (a - b) % _PP,
                 lambda a, b: a * b % _PP, lambda a: pow(a, _PP - 2, _PP),
                 lambda a: (-a) % _PP, lambda a, k: a * k % _PP,
                 0, 1, 5, order=VESTA_BASE)
PASTA_G1_GEN = (_PP - 1, 2)

if not PASTA_G1.is_on_curve(PASTA_G1_GEN):
    raise AssertionError("Pasta generator not on curve")
if PASTA_G1.mul(PASTA_G1_GEN, VESTA_BASE - 1) != PASTA_G1.neg(PASTA_G1_GEN):
    raise AssertionError("Pasta generator has wrong order")
