"""BN254 G1 in homogeneous projective coordinates on limb tensors.

Counterpart of ``zkodst_tpu/ops/curve.py`` (the BN254 instance). A point is
a ``(..., 3, 8)`` int32 tensor of Fq Montgomery limbs (X : Y : Z); the
identity is (0 : 1 : 0). Addition is the complete RCB16 Alg. 7 formula
(a = 0, b3 = 9) in the operation order of ``zkodst_tpu/pallas/ec.py``
``_ec_add_vecs``, so identity and doubling need no branches; doubling is
RCB16 Alg. 9 in the order of ``_double_impl`` (:func:`dbl_limbs`).

Packed form: the kernels take ``(batch, 24, n)`` tensors (row c·8 + i =
limb i of coordinate c), so that lanes are the fast axis; :func:`pack` and
:func:`unpack` convert.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import FQ, MASK32

ONE = FQ.ONE


def identity(shape=(), device="cpu") -> torch.Tensor:
    """(..., 3, 8) identity points."""
    z = np.zeros(tuple(shape) + (3, 8), np.uint32)
    z[..., 1, :] = ONE
    return FQ.const(z, device)


def from_affine_ints(pts, device="cpu") -> torch.Tensor:
    """Affine (x, y) int tuples or None -> (N, 3, 8) projective points."""
    coords = np.zeros((len(pts), 3), dtype=object)
    for i, pt in enumerate(pts):
        coords[i] = (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
    return FQ.from_ints(coords, device)


def to_affine_ints(pts: torch.Tensor):
    """(..., 3, 8) projective -> list of affine tuples / None."""
    vals = FQ.to_ints(pts.reshape(-1, 3, 8))
    out = []
    for x, y, z in vals:
        if z == 0:
            out.append(None)
        else:
            zinv = pow(int(z), -1, FQ.p)
            out.append((int(x) * zinv % FQ.p, int(y) * zinv % FQ.p))
    return out


def pack(points: torch.Tensor) -> torch.Tensor:
    """(..., n, 3, 8) -> (batch, 24, n) with batch = prod(...)."""
    n = points.shape[-3]
    return points.reshape(-1, n, 24).transpose(1, 2).contiguous()


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """(batch, 24, n) -> (batch, n, 3, 8)."""
    b, _, n = packed.shape
    return packed.transpose(1, 2).reshape(b, n, 3, 8)


def _mul9(a):
    a2 = FQ.add64(a, a)
    a4 = FQ.add64(a2, a2)
    a8 = FQ.add64(a4, a4)
    return FQ.add64(a8, a)


def add_limbs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition on int64 limb values, (..., 3, 8) each; the plain
    twin of zk::ec_add in cuda/csrc/field.cuh. The formula's independent
    products, sums and differences run stacked, six products per call:
    each value is the same as the kernel's, computed in fewer (larger)
    tensor operations."""
    mul, add, sub = FQ.mont_mul64, FQ.add64, FQ.sub64
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
    t2_9, y3p = _mul9(torch.stack([t2, w3]))        # b3·z1z2, b3·w3
    z3p, t1m = add(t1, t2_9), sub(t1, t2_9)
    m = mul(torch.stack([t3, t4, y3p, t1m, z3p, t0_3]),
            torch.stack([t1m, y3p, t0_3, z3p, t4, t3]))
    x3 = sub(m[0], m[1])
    y3, z3 = add(torch.stack([m[2], m[4]]), torch.stack([m[3], m[5]]))
    return torch.stack([x3, y3, z3], dim=-2)


def dbl_limbs(p: torch.Tensor) -> torch.Tensor:
    """Complete doubling on int64 limb values, (..., 3, 8); the plain twin
    of zk::ec_dbl in cuda/csrc/field.cuh, RCB16 Alg. 9 (a = 0, b3 = 9) in
    the operation sequence of ``zkodst_tpu/ops/curve.py`` ``_double_impl``:
    three layers of independent products (4, 2, 2), each one stacked call."""
    mul, add, sub = FQ.mont_mul64, FQ.add64, FQ.sub64
    x, y, z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    t0, t1, xy, t2 = mul(torch.stack([y, y, x, z]), torch.stack([y, z, y, z]))
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)                                # 8·y²
    b3z2 = _mul9(t2)                                # b3·z²
    x3, z3 = mul(torch.stack([b3z2, t1]), torch.stack([z3, z3]))
    y3 = add(t0, b3z2)
    w = sub(t0, add(add(b3z2, b3z2), b3z2))         # y² − 3·b3·z²
    ya, xa = mul(torch.stack([w, w]), torch.stack([y3, xy]))
    return torch.stack([add(xa, xa), add(ya, x3), z3], dim=-2)


def lanes64(packed: torch.Tensor) -> torch.Tensor:
    """(batch, 24, n) int32 -> (batch, n, 3, 8) int64 limb values."""
    return unpack(packed).to(torch.int64) & MASK32


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete projective addition of (..., 3, 8) points (broadcast).

    Goes through the ec_add wrapper: kernel 8 for points on the card."""
    from ..kernels.ec import ec_add

    p, q = torch.broadcast_tensors(p, q)
    shape = p.shape
    p2, q2 = p.reshape(-1, 3, 8), q.reshape(-1, 3, 8)
    return unpack(ec_add(pack(p2), pack(q2))).reshape(shape)
