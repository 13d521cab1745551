"""Curves in homogeneous projective coordinates on limb tensors: BN254 G1
and, for the IPA backend, the Pasta "pallas" curve.

Counterpart of ``zkodst_tpu/ops/curve.py``. A point is a ``(..., 3, 8)``
int32 tensor of base-field Montgomery limbs (X : Y : Z); the identity is
(0 : 1 : 0). Addition is the complete RCB16 Alg. 7 formula (a = 0, b3 = 3b:
9 on BN254, 15 on pallas) in the operation order of
``zkodst_tpu/pallas/ec.py`` ``_ec_add_vecs``, so identity and doubling need
no branches; doubling is RCB16 Alg. 9 in the order of ``_double_impl``
(:func:`dbl_limbs`).

:class:`Curve` holds one curve's constants and its group operations
(:data:`BN254`, :data:`PASTA`); the module-level functions are BN254's.

Packed form: the kernels take ``(batch, 24, n)`` tensors (row c·8 + i =
limb i of coordinate c), so that lanes are the fast axis; :func:`pack` and
:func:`unpack` convert.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import FQ, FR, MASK32, PASTA_FP, PASTA_FR, Field


def identity(shape=(), device="cpu") -> torch.Tensor:
    """(..., 3, 8) BN254 identity points."""
    return BN254.identity(shape, device)


def from_affine_ints(pts, device="cpu") -> torch.Tensor:
    """Affine (x, y) int tuples or None -> (N, 3, 8) BN254 projective
    points."""
    return BN254.from_affine_ints(pts, device)


def to_affine_ints(pts: torch.Tensor):
    """(..., 3, 8) BN254 projective -> list of affine tuples / None."""
    return BN254.to_affine_ints(pts)


def pack(points: torch.Tensor) -> torch.Tensor:
    """(..., n, 3, 8) -> (batch, 24, n) with batch = prod(...)."""
    n = points.shape[-3]
    return points.reshape(-1, n, 24).transpose(1, 2).contiguous()


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """(batch, 24, n) -> (batch, n, 3, 8)."""
    b, _, n = packed.shape
    return packed.transpose(1, 2).reshape(b, n, 3, 8)


def _mul_b3(F: Field, b3: int, a):
    """b3·a of int64 limb values by a chain of additions (each sum is a
    canonical value, so any chain gives the kernel's result)."""
    acc, base, k = None, a, b3
    while k:
        if k & 1:
            acc = base if acc is None else F.add64(acc, base)
        k >>= 1
        if k:
            base = F.add64(base, base)
    return acc


def add_limbs(p: torch.Tensor, q: torch.Tensor,
              curve: "Curve" = None) -> torch.Tensor:
    """Complete addition on int64 limb values, (..., 3, 8) each, on
    `curve` (BN254 by default); the plain twin of zk::ec_add in
    cuda/csrc/field.cuh. The formula's independent products, sums and
    differences run stacked, six products per call: each value is the same
    as the kernel's, computed in fewer (larger) tensor operations."""
    F, b3 = (curve or BN254).F, (curve or BN254).b3
    mul, add, sub = F.mont_mul64, F.add64, F.sub64
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    x2, y2, z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    s1 = add(torch.stack([x1, y1, x1]), torch.stack([y1, z1, z1]))
    s2 = add(torch.stack([x2, y2, x2]), torch.stack([y2, z2, z2]))
    t0, t1, t2, u1, u2, u3 = mul(torch.stack([x1, y1, z1, *s1]),
                                 torch.stack([x2, y2, z2, *s2]))
    # x1y2 + x2y1, y1z2 + y2z1, x1z2 + x2z1
    t3, t4, w3 = sub(torch.stack([u1, u2, u3]),
                     add(torch.stack([t0, t1, t0]), torch.stack([t1, t2, t2])))
    t0_3 = add(add(t0, t0), t0)                     # 3·x1x2
    t2_9, y3p = _mul_b3(F, b3, torch.stack([t2, w3]))   # b3·z1z2, b3·w3
    z3p, t1m = add(t1, t2_9), sub(t1, t2_9)
    m = mul(torch.stack([t3, t4, y3p, t1m, z3p, t0_3]),
            torch.stack([t1m, y3p, t0_3, z3p, t4, t3]))
    x3 = sub(m[0], m[1])
    y3, z3 = add(torch.stack([m[2], m[4]]), torch.stack([m[3], m[5]]))
    return torch.stack([x3, y3, z3], dim=-2)


def dbl_limbs(p: torch.Tensor, curve: "Curve" = None) -> torch.Tensor:
    """Complete doubling on int64 limb values, (..., 3, 8), on `curve`
    (BN254 by default); the plain twin of zk::ec_dbl in
    cuda/csrc/field.cuh, RCB16 Alg. 9 (a = 0, b3 = 3b: 9 on BN254, 15 on
    pallas) in the operation sequence of ``zkodst_tpu/ops/curve.py``
    ``_double_impl``: three layers of independent products (4, 2, 2), each
    one stacked call."""
    F, b3 = (curve or BN254).F, (curve or BN254).b3
    mul, add, sub = F.mont_mul64, F.add64, F.sub64
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    t0, t1, xy, t2 = mul(torch.stack([y, y, x, z]), torch.stack([y, z, y, z]))
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)                                # 8·y²
    b3z2 = _mul_b3(F, b3, t2)                       # b3·z²
    x3, z3 = mul(torch.stack([b3z2, t1]), torch.stack([z3, z3]))
    y3 = add(t0, b3z2)
    w = sub(t0, add(add(b3z2, b3z2), b3z2))         # y² − 3·b3·z²
    ya, xa = mul(torch.stack([w, w]), torch.stack([y3, xy]))
    return torch.stack([add(xa, xa), add(ya, x3), z3], dim=-2)


def lanes64(packed: torch.Tensor) -> torch.Tensor:
    """(batch, 24, n) int32 -> (batch, n, 3, 8) int64 limb values."""
    return unpack(packed).to(torch.int64) & MASK32


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective addition of (..., 3, 8) BN254 points
    (broadcast). Goes through the ec_add wrapper: kernel 8 for points on
    the card."""
    return BN254.add(p, q)


class Curve:
    """One curve y² = x³ + b (a = 0, cofactor 1) over the base field `F`,
    its scalars in `SF`: the constants and the group operations on
    (..., 3, 8) point tensors. `kernel_id` selects the curve of kernel 8
    (0 BN254, 1 pallas)."""

    def __init__(self, F: Field, SF: Field, b: int, name: str,
                 kernel_id: int):
        self.F, self.SF, self.b, self.b3 = F, SF, b, 3 * b
        self.name, self.kernel_id = name, kernel_id

    def __repr__(self):
        return f"Curve({self.name})"

    def identity(self, shape=(), device="cpu") -> torch.Tensor:
        """(..., 3, 8) identity points (0 : 1 : 0), filled on `device`:
        one 32-byte upload, whatever the shape."""
        out = torch.zeros(tuple(shape) + (3, 8), dtype=torch.int32,
                          device=device)
        out[..., 1, :] = self.F.const(self.F.ONE, device)
        return out

    def from_affine_ints(self, pts, device="cpu") -> torch.Tensor:
        """Affine (x, y) int tuples or None -> (N, 3, 8) projective."""
        coords = np.zeros((len(pts), 3), dtype=object)
        for i, pt in enumerate(pts):
            coords[i] = (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
        return self.F.from_ints(coords, device)

    def to_affine_ints(self, pts: torch.Tensor):
        """(..., 3, 8) projective -> list of affine tuples / None."""
        p = self.F.p
        out = []
        for x, y, z in self.F.to_ints(pts.reshape(-1, 3, 8)):
            if z == 0:
                out.append(None)
            else:
                zinv = pow(int(z), -1, p)
                out.append((int(x) * zinv % p, int(y) * zinv % p))
        return out

    def add(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Complete addition of (..., 3, 8) points (broadcast): kernel 8
        for points on the card."""
        from ..kernels.ec import ec_add

        p, q = torch.broadcast_tensors(p, q)
        shape = p.shape
        p2, q2 = p.reshape(-1, 3, 8), q.reshape(-1, 3, 8)
        return unpack(ec_add(pack(p2), pack(q2), self)).reshape(shape)

    def double(self, p: torch.Tensor) -> torch.Tensor:
        """2·p as the complete addition p + p (kernel 8)."""
        return self.add(p, p)

    @staticmethod
    def select(cond: torch.Tensor, p: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
        """p where cond, else q; cond has the points' leading shape."""
        return torch.where(cond[..., None, None], p, q)

    def scalar_mul(self, p: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """k_i·p_i for (N, 3, 8) points and (N, 8) NORMAL-form scalar
        limbs (the scalar field's width: 255 bits on pallas):
        double-and-add from the top bit down, all lanes at once (two
        launches of kernel 8 a bit), as the reference's ``scalar_mul``.
        The counterpart of the reference's function; no path of the port
        calls it (MSMs go through :func:`..ops.msm.msm_many`)."""
        bits = self.SF.p.bit_length()
        limbs = k.to(torch.int64) & MASK32
        acc = self.identity(p.shape[:-2], p.device)
        for i in range(bits - 1, -1, -1):
            acc = self.double(acc)
            bit = ((limbs[..., i // 32] >> (i % 32)) & 1).bool()
            acc = self.select(bit, self.add(acc, p), acc)
        return acc


BN254 = Curve(FQ, FR, 3, "bn254", 0)
PASTA = Curve(PASTA_FP, PASTA_FR, 5, "pallas", 1)
