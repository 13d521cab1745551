"""BN254 G1 in Python ints: affine points as (x, y) tuples, None for the
identity; Jacobian coordinates inside scalar multiplication and the
Pippenger multi-scalar multiplication. Nothing here imports torch, so a
process pool can run :func:`msm_window` cheaply."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .field import Q, R, sqrt_q

B = 3
GEN = (1, 2)

Point = Optional[Tuple[int, int]]


def neg(pt: Point) -> Point:
    return None if pt is None else (pt[0], (-pt[1]) % Q)


def add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 != y2 or y1 == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    return (x3, (lam * (x1 - x3) - y1) % Q)


# Jacobian (X, Y, Z), None for the identity; a = 0 (dbl-2009-l,
# add-2007-bl, madd-2007-bl)
def _jdbl(p):
    if p is None:
        return None
    X1, Y1, Z1 = p
    A = X1 * X1 % Q
    Bq = Y1 * Y1 % Q
    C = Bq * Bq % Q
    D = 2 * ((X1 + Bq) * (X1 + Bq) - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    return (X3, (E * (D - X3) - 8 * C) % Q, 2 * Y1 * Z1 % Q)


def _jadd(p, q):
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    H = (U2 - U1) % Q
    r = 2 * (S2 - S1) % Q
    if H == 0:
        return _jdbl(p) if r == 0 else None
    I = 4 * H * H % Q
    J = H * I % Q
    V = U1 * I % Q
    X3 = (r * r - J - 2 * V) % Q
    Y3 = (r * (V - X3) - 2 * S1 * J) % Q
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % Q
    return (X3, Y3, Z3)


def _jmadd(p, q: Tuple[int, int]):
    """Jacobian p + affine q."""
    if p is None:
        return (q[0], q[1], 1)
    X1, Y1, Z1 = p
    Z1Z1 = Z1 * Z1 % Q
    U2 = q[0] * Z1Z1 % Q
    S2 = q[1] * Z1 * Z1Z1 % Q
    H = (U2 - X1) % Q
    r = 2 * (S2 - Y1) % Q
    if H == 0:
        return _jdbl(p) if r == 0 else None
    HH = H * H % Q
    I = 4 * HH % Q
    J = H * I % Q
    V = X1 * I % Q
    X3 = (r * r - J - 2 * V) % Q
    Y3 = (r * (V - X3) - 2 * Y1 * J) % Q
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % Q
    return (X3, Y3, Z3)


def _affine(p) -> Point:
    if p is None or p[2] % Q == 0:
        return None
    zi = pow(p[2], -1, Q)
    zi2 = zi * zi % Q
    return (p[0] * zi2 % Q, p[1] * zi2 * zi % Q)


def mul(pt: Point, k: int) -> Point:
    k %= R
    if pt is None or k == 0:
        return None
    acc, base = None, (pt[0], pt[1], 1)
    while k:
        if k & 1:
            acc = _jadd(acc, base)
        k >>= 1
        if k:
            base = _jdbl(base)
    return _affine(acc)


def lin_comb(points: Sequence[Point], scalars: Sequence[int]) -> Point:
    """Σ k_i·P_i for a few points (one scalar multiplication each)."""
    acc = None
    for pt, k in zip(points, scalars):
        acc = add(acc, mul(pt, k))
    return acc


def msm_window(points: Sequence[Tuple[int, int]], scalars: Sequence[int],
               c: int, w: int):
    """Window w of a Pippenger MSM: Σ_d d·(Σ_{digit_w(k_i) = d} P_i), as
    a Jacobian point (or None). Points are affine and not the identity."""
    buckets: List = [None] * (1 << c)
    shift, mask = c * w, (1 << c) - 1
    for pt, k in zip(points, scalars):
        d = (k >> shift) & mask
        if d:
            buckets[d] = _jmadd(buckets[d], pt)
    running = total = None
    for d in range(mask, 0, -1):
        running = _jadd(running, buckets[d])
        total = _jadd(total, running)
    return total


def combine_windows(sums: Sequence, c: int) -> Point:
    """Σ_w 2^(c·w)·S_w from the windows' Jacobian sums."""
    acc = None
    for s in reversed(sums):
        for _ in range(c):
            acc = _jdbl(acc)
        acc = _jadd(acc, s)
    return _affine(acc)


def decompress(data: bytes) -> Point:
    """32 bytes (LE x, y's parity in bit 255, zeros for the identity) ->
    the point; ValueError unless it encodes one."""
    if len(data) != 32:
        raise ValueError("a point takes 32 bytes")
    if data == bytes(32):
        return None
    b = bytearray(data)
    if b[31] & 0x40:
        raise ValueError("bit 254 is set")
    ysign = (b[31] >> 7) & 1
    b[31] &= 0x3F
    x = int.from_bytes(bytes(b), "little")
    if x >= Q:
        raise ValueError("x out of range")
    y = sqrt_q(x * x * x + B)
    if y is None:
        raise ValueError("not on the curve")
    if (y & 1) != ysign:
        y = Q - y
    return (x, y)


def compress(pt: Point) -> bytes:
    if pt is None:
        return bytes(32)
    b = bytearray(pt[0].to_bytes(32, "little"))
    if pt[1] & 1:
        b[31] |= 0x80
    return bytes(b)
