"""Prime-field arithmetic on limb tensors (BN254 Fr and Fq).

Counterpart of ``zkodst_tpu/ops/field.py``. A field element is the
canonical Montgomery value a·2^256 mod p in 8 little-endian 32-bit limbs;
tensors are ``torch.int32`` holding the limbs' bit patterns, shape
``(..., 8)``. The value does not depend on limb width, so
:func:`from_limbs16` / :func:`to_limbs16` convert exactly to and from the
reference's ``(..., 16)`` 16-bit limbs.

The plain arithmetic (``*64`` methods) works on ``int64`` tensors holding
32-bit limb values, because CPU ``torch.uint32`` has no add, ``>>`` or
``<``; the Montgomery product splits operands into 16-bit halves so every
partial product and column sum stays exact in int64. :meth:`Field.mul`,
:meth:`Field.add` and :meth:`Field.cumprod_incl` go through the wrappers
of kernels/mulmod.py, which launch the CUDA kernels for tensors on the
card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pyfield

L = 8                   # 32-bit limbs per element
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF
MUL_CHUNK = 1 << 18     # elements per plain Montgomery product pass


def ints_to_limbs(xs) -> np.ndarray:
    """Python ints (< 2^256, any nesting) -> (..., 8) uint32 limbs."""
    arr = np.asarray(xs, dtype=object)
    raw = b"".join(int(x).to_bytes(32, "little") for x in arr.ravel())
    return np.frombuffer(raw, dtype="<u4").reshape(arr.shape + (L,)).copy()


def limbs_to_ints(limbs) -> np.ndarray:
    """(..., 8) limbs (numpy or tensor, any int dtype) -> object ndarray."""
    a = np.ascontiguousarray(_np_u32(limbs))
    shape = a.shape[:-1]
    raw = a.astype("<u4").tobytes()
    out = np.empty(int(np.prod(shape, dtype=np.int64)), dtype=object)
    for i in range(out.shape[0]):
        out[i] = int.from_bytes(raw[32 * i: 32 * i + 32], "little")
    return out.reshape(shape)


def _np_u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def to_i64(t: torch.Tensor) -> torch.Tensor:
    """int32 limb bit patterns -> int64 limb values in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 limb values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


def from_limbs16(a16, device="cpu") -> torch.Tensor:
    """The reference's (..., 16) 16-bit limbs (uint32 numpy) -> (..., 8)
    int32 tensor of the same values."""
    a = np.asarray(a16).astype(np.uint32)
    a32 = a[..., 0::2] | (a[..., 1::2] << np.uint32(16))
    return torch.from_numpy(a32.view(np.int32).copy()).to(device)


def to_limbs16(t: torch.Tensor) -> np.ndarray:
    """(..., 8) limb tensor -> the reference's (..., 16) uint32 layout."""
    a = _np_u32(t)
    out = np.stack([a & np.uint32(MASK16), a >> np.uint32(16)], axis=-1)
    return out.reshape(a.shape[:-1] + (2 * L,))


def _split16(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a & MASK16, a >> 16], dim=-1).flatten(-2)


def _carries(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry out of each limb of a ripple chain in which limb i generates
    (`gen`) or passes on (`prop`) a carry, never both, by a Kogge–Stone
    prefix over the limbs. (..., L) bool -> (..., L) int64."""
    g, p = gen, prop
    d = 1
    while d < g.shape[-1]:
        pad = torch.zeros_like(g[..., :d])
        g = g | (p & torch.cat([pad, g[..., :-d]], -1))
        p = p & torch.cat([pad, p[..., :-d]], -1)
        d *= 2
    return g.to(torch.int64)


def _into(c: torch.Tensor) -> torch.Tensor:
    """Carries out of each limb -> carries into each limb."""
    return torch.nn.functional.pad(c, (1, -1))


def _add_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod 2^256 of 32-bit limb values."""
    s = a + b
    r = s & MASK32
    return (r + _into(_carries(s > MASK32, r == MASK32))) & MASK32


def _sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a − b) mod 2^256 of 32-bit limb values, and the borrow out (a < b)."""
    d = a - b
    c = _carries(d < 0, d == 0)
    return (d - _into(c)) & MASK32, c[..., -1].bool()


def _carry(t: torch.Tensor, bits: int) -> torch.Tensor:
    """Propagate carries of nonnegative int64 columns in place (ripple);
    the carry out of the last column is dropped."""
    mask = (1 << bits) - 1
    for i in range(t.shape[-1] - 1):
        t[..., i + 1] += t[..., i] >> bits
        t[..., i] &= mask
    t[..., -1] &= mask
    return t


class Field:
    """Static per-modulus constants and the limb arithmetic."""

    def __init__(self, p: int, name: str, kernel_id: int):
        self.p = p
        self.name = name
        self.kernel_id = kernel_id          # modulus selector of zk_mulmod
        self.py = pyfield.PF(p, name)
        self.r = (1 << pyfield.R_BITS) % p
        self.r2 = self.r * self.r % p
        self.P = ints_to_limbs(p)
        self.ONE = ints_to_limbs(self.r)     # 1 in Montgomery form
        self.R2 = ints_to_limbs(self.r2)
        self.pinv16 = (-pow(p, -1, 1 << 16)) % (1 << 16)
        self._p32 = [int(x) for x in self.P]
        self._p16 = [(p >> (16 * i)) & MASK16 for i in range(2 * L)]

    def __repr__(self):
        return f"Field({self.name})"

    # -- host <-> tensor ---------------------------------------------------
    def from_ints(self, xs, device="cpu") -> torch.Tensor:
        """Python ints -> (..., 8) int32 Montgomery limbs."""
        arr = np.asarray(xs, dtype=object)
        mont = np.vectorize(lambda x: int(x) % self.p * self.r % self.p,
                            otypes=[object])(arr) if arr.size else arr
        return self.const(ints_to_limbs(mont), device)

    def to_ints(self, t) -> np.ndarray:
        """(..., 8) Montgomery limbs -> object ndarray of Python ints."""
        rinv = pow(self.r, -1, self.p)
        return np.vectorize(lambda v: v * rinv % self.p,
                            otypes=[object])(limbs_to_ints(t))

    @staticmethod
    def const(limbs: np.ndarray, device="cpu") -> torch.Tensor:
        """uint32 limb array -> int32 tensor on `device`."""
        a = np.ascontiguousarray(np.asarray(limbs, np.uint32))
        return torch.from_numpy(a.view(np.int32).copy()).to(device)

    # -- ring ops on int32 tensors -------------------------------------------
    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a·b·2^-256 (kernel 1 on the card)."""
        from ..kernels.mulmod import mulmod

        return mulmod(self, a, b)

    def add(self, a, b):
        """(a + b) mod p (kernel 2 on the card)."""
        from ..kernels.mulmod import addmod

        return addmod(self, a, b)

    def sub(self, a, b):
        """(a − b) mod p in plain PyTorch on any device: no ported phase
        subtracts yet (the quotient's F.sub, TPU kernel 3, comes with it)."""
        return to_i32(self.sub64(to_i64(a), to_i64(b)))

    def inv(self, a):
        """Elementwise a^(p−2) (0 maps to 0), on the host: the tensor is
        read back, inverted with Python ints and put back on its device.
        The path inverts one element per `inv_batch`; 32 bytes each way
        replace the ~380 one-element launches of a square-and-multiply on
        the card."""
        vals = self.to_ints(a)
        inv = np.vectorize(lambda v: pow(int(v), self.p - 2, self.p),
                           otypes=[object])(vals) if vals.size else vals
        return self.from_ints(inv, a.device)

    def inv_batch(self, a):
        """Inverse of every element of an (n, 8) column (Montgomery's
        trick): prefix and suffix products, one inverse of the total, then
        inv_i = prefix_{<i} · suffix_{>i} · total⁻¹. Every element must be
        nonzero."""
        pre = self.cumprod_incl(a)
        suf = self.cumprod_incl(a, reverse=True)
        one = self.const(self.ONE, a.device)[None]
        pre_exc = torch.cat([one, pre[:-1]])
        suf_exc = torch.cat([suf[1:], one])
        return self.mul(self.mul(pre_exc, suf_exc), self.inv(pre[-1]))

    def cumprod_incl(self, a, reverse: bool = False, W: int = 2048):
        """Inclusive cumulative product along axis 0 of an (n, 8) column
        (suffix products with reverse=True).

        Up to W elements: one tile scan (kernel 5). Longer: the column,
        padded with ones to a multiple of W, is cut into W runs of S
        contiguous elements; each run's local products (kernel 4), a tile
        scan of the W run totals (kernel 5), and each run times the product
        of the runs before it (kernel 1), as the reference's chained TPU
        path (``zkodst_tpu/ops/field.py:342-357``)."""
        from ..kernels.mulmod import chain_cumprod, cumprod_tile

        n = a.shape[0]
        x = a.flip(0) if reverse else a
        if n <= W:
            out = cumprod_tile(self, x)
        else:
            S = -(-n // W)
            if S * W != n:
                pad = self.const(self.ONE, a.device).expand(S * W - n, L)
                x = torch.cat([x, pad])
            local = chain_cumprod(self, x.contiguous(), W)
            incl = cumprod_tile(self, local[S - 1::S].contiguous())
            one = self.const(self.ONE, a.device)[None]
            carry = torch.cat([one, incl[:-1]])
            out = self.mul(local.view(W, S, L), carry[:, None, :])
            out = out.reshape(S * W, L)[:n]
        return out.flip(0) if reverse else out

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    # -- plain arithmetic on int64 limb values ---------------------------------
    def _p64(self, device) -> torch.Tensor:
        return torch.tensor(self._p32, dtype=torch.int64, device=device)

    def reduce_once64(self, t):
        """t - p if t >= p else t, for t < 2p."""
        d, borrow = _sub_limbs(t, self._p64(t.device))
        return torch.where(borrow[..., None], t, d)

    def add64(self, a, b):
        return self.reduce_once64(_add_limbs(a, b))

    def sub64(self, a, b):
        d, borrow = _sub_limbs(a, b)
        return torch.where(borrow[..., None],
                           _add_limbs(d, self._p64(d.device)), d)

    def mont_mul64(self, a, b):
        """Montgomery product of int64 limb values (CIOS on 16-bit digits:
        partial products < 2^32, column sums < 2^38). Long inputs run in
        chunks of 2^18 elements: the partial-product grid takes 4 KB per
        element."""
        a, b = torch.broadcast_tensors(a, b)
        if a.numel() > MUL_CHUNK * L:
            fa, fb = a.reshape(-1, L), b.reshape(-1, L)
            return torch.cat([self.mont_mul64(fa[i: i + MUL_CHUNK],
                                              fb[i: i + MUL_CHUNK])
                              for i in range(0, fa.shape[0], MUL_CHUNK)]
                             ).reshape(a.shape)
        a16, b16 = _split16(a), _split16(b)
        n16 = 2 * L
        # column sums of the 16×16 partial products: row i of the padded
        # (16, 32) grid, read with a row length of 31, starts i columns on
        pp = a16[..., :, None] * b16[..., None, :]
        flat = torch.nn.functional.pad(pp, (0, n16)).flatten(-2)
        t = flat[..., :n16 * (2 * n16 - 1)].reshape(
            pp.shape[:-1] + (2 * n16 - 1,)).sum(-2)
        t = torch.nn.functional.pad(t, (0, 2))
        p16 = torch.tensor(self._p16, dtype=torch.int64, device=a.device)
        for i in range(n16):
            m = ((t[..., i] & MASK16) * self.pinv16) & MASK16
            t[..., i:i + n16] += m[..., None] * p16
            t[..., i + 1] += t[..., i] >> 16
        r16 = _carry(t[..., n16:2 * n16].clone(), 16)
        r = r16[..., 0::2] | (r16[..., 1::2] << 16)
        return self.reduce_once64(r)


FR = Field(pyfield.BN254_FR, "bn254_fr", 0)
FQ = Field(pyfield.BN254_FQ, "bn254_fq", 1)
