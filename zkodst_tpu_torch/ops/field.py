"""Prime-field arithmetic on limb tensors (BN254 Fr and Fq, and the two
Pasta fields of the IPA backend).

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
:meth:`Field.add`, :meth:`Field.sub`, :meth:`Field.cumprod_incl` and
:meth:`Field.inv_batch` go through the wrappers of kernels/mulmod.py, which
launch the CUDA kernels for tensors on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import timing
from . import pyfield

L = 8                   # 32-bit limbs per element
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF
# elements per plain Montgomery product pass: on the CPU a chunk whose
# digit columns (256 bytes an element) stay in the caches; on the card few
# passes, each ~100 launches
MUL_CHUNK = {"cpu": 1 << 12, "cuda": 1 << 18}
CHAIN_W = 2048          # runs of a chained prefix product (at most 2048)


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
        x = timing.read(x)
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
    return timing.upload(torch.from_numpy(a32.view(np.int32).copy()), device)


def to_limbs16(t: torch.Tensor) -> np.ndarray:
    """(..., 8) limb tensor -> the reference's (..., 16) uint32 layout."""
    a = _np_u32(t)
    out = np.stack([a & np.uint32(MASK16), a >> np.uint32(16)], axis=-1)
    return out.reshape(a.shape[:-1] + (2 * L,))


def _split16(a: torch.Tensor) -> torch.Tensor:
    return torch.stack([a & MASK16, a >> 16], dim=-1).flatten(-2)


# per (length, device): arange(length), and the column of digit product
# a16_i·b16_j (i + j) in the plain Montgomery product
_INDEX: dict = {}


def _index(kind: str, n: int, device) -> torch.Tensor:
    key = (kind, n, str(device))
    if key not in _INDEX:
        i = torch.arange(n, device=device)
        _INDEX[key] = i if kind == "arange" else \
            (i[:, None] + i[None, :]).reshape(-1)
    return _INDEX[key]


def _carries(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Carry out of each limb of a ripple chain in which limb i generates
    (`gen`) or passes on (`prop`) a carry, never both: the carry out of
    limb i is `gen` at the nearest limb at or below i that does not pass
    one on (a running maximum of those limbs' positions), or none.
    (..., L) bool -> (..., L) int64."""
    idx = _index("arange", gen.shape[-1], gen.device)
    pos = torch.cummax(torch.where(prop, -1, idx), dim=-1).values
    return (torch.gather(gen, -1, pos.clamp(min=0)) & (pos >= 0)) \
        .to(torch.int64)


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


def _carry16(t: torch.Tensor) -> torch.Tensor:
    """16-bit digits of nonnegative int64 columns below 2^38 whose value is
    below 2^(16·columns): three passes that move each column's carry up
    (leaving every column at most 2^16), then the remaining carries of one
    by :func:`_carries`. The value has no carry out of the top column, so
    none is dropped."""
    for _ in range(3):
        t = (t & MASK16) + torch.nn.functional.pad((t >> 16)[..., :-1],
                                                   (1, 0))
    return (t + _into(_carries(t > MASK16, t == MASK16))) & MASK16


def _scan_length(n: int, W: int) -> int:
    """Elements of cumprod_incl's scan of n: n, or n rounded up to a
    multiple of W where the scan is chained."""
    return n if n <= W else -(-n // W) * W


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
        self._consts: dict = {}

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
        """uint32 limb array -> int32 tensor on `device` (a copy from the
        host through :func:`timing.upload`)."""
        a = np.ascontiguousarray(np.asarray(limbs, np.uint32))
        return timing.upload(torch.from_numpy(a.view(np.int32).copy()),
                             device)

    # -- ring ops on int32 tensors -------------------------------------------
    def mul(self, a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
        """Montgomery product a·b·2^-256 (kernel 1 on the card), into
        `out` where given."""
        from ..kernels.mulmod import mulmod

        return mulmod(self, a, b, out=out)

    def add(self, a, b):
        """(a + b) mod p (kernel 2 on the card)."""
        from ..kernels.mulmod import addmod

        return addmod(self, a, b)

    def sub(self, a, b):
        """(a − b) mod p (kernel 3 on the card)."""
        from ..kernels.mulmod import submod

        return submod(self, a, b)

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
        nonzero. Each product is scanned into a buffer one element longer
        than its scan, with 1 at the far end, so the exclusive products
        and the total are views of it."""
        n = a.shape[0]
        N = _scan_length(n, CHAIN_W)
        one = self.const(self.ONE, a.device)
        pre = torch.empty((N + 1, L), dtype=torch.int32, device=a.device)
        pre[0] = one                            # pre[i] = a[0] · … · a[i−1]
        self._scan_into(a, pre[1:], False, CHAIN_W)
        suf = torch.empty((N + 1, L), dtype=torch.int32, device=a.device)
        suf[N] = one                            # suf[i] = a[i] · … · a[n−1]
        self._scan_into(a, suf[:N], True, CHAIN_W)
        return self.mul(self.mul(pre[:n], suf[1:n + 1]), self.inv(pre[n]))

    def cumprod_incl(self, a, reverse: bool = False, W: int = CHAIN_W):
        """Inclusive cumulative product along axis 0 of an (n, 8) column
        (suffix products with reverse=True).

        Up to W elements: one tile scan (kernel 5). Longer: the column is
        cut into W runs of S contiguous elements (padded with ones at its
        end to a multiple of W, a copy only for such a ragged column);
        each run's local products (kernel 4), a tile scan of the W run
        totals read in place into each run's carry, the product of the runs
        before it (kernel 5), and each run times its carry (kernel 1), as
        the reference's chained TPU path
        (``zkodst_tpu/ops/field.py:342-357``). With reverse=True kernels 4
        and 5 walk the column from its end, and each run's carry is the
        product of the runs after it: nothing is flipped."""
        n = a.shape[0]
        out = torch.empty((_scan_length(n, W), L), dtype=torch.int32,
                          device=a.device)
        return self._scan_into(a, out, reverse, W)[:n]

    def _scan_into(self, a, out, reverse: bool, W: int):
        """The inclusive products of cumprod_incl, written into `out`
        (_scan_length(n, W) contiguous elements); returns `out`."""
        from ..kernels.mulmod import chain_cumprod, cumprod_tile

        n = a.shape[0]
        if n <= W:
            return cumprod_tile(self, a, reverse=reverse, out=out)
        S = out.shape[0] // W
        x = a
        if S * W != n:
            pad = self.const(self.ONE, a.device).expand(S * W - n, L)
            x = torch.cat([a, pad])
        local = chain_cumprod(self, x, W, reverse=reverse)
        carry = cumprod_tile(self, local, W, stride=S,
                             offset=0 if reverse else S - 1,
                             reverse=reverse, exclusive=True)
        self.mul(local.view(W, S, L), carry[:, None, :],
                 out=out.view(W, S, L))
        return out

    def sum(self, a: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Σ along `dim` by halving: the first half plus the second
        (kernel 2), an odd last row carried to the next round."""
        while a.shape[dim] > 1:
            m = a.shape[dim]
            h = m // 2
            s = self.add(a.narrow(dim, 0, h), a.narrow(dim, h, h))
            a = torch.cat([s, a.narrow(dim, 2 * h, 1)], dim) if m % 2 else s
        return a.select(dim, 0)

    def neg(self, a):
        """(0 − a) mod p, the zero a broadcast constant (kernel 3)."""
        return self.sub(torch.zeros(L, dtype=torch.int32, device=a.device), a)

    # -- plain arithmetic on int64 limb values ---------------------------------
    def _p64(self, device, digits: int = 32) -> torch.Tensor:
        """p as int64 limb values (32-bit limbs, or 16-bit digits), made
        once per device."""
        key = (digits, str(device))
        if key not in self._consts:
            self._consts[key] = torch.tensor(
                self._p32 if digits == 32 else self._p16, dtype=torch.int64,
                device=device)
        return self._consts[key]

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
        """Montgomery product of int64 limb values on 16-bit digits (SOS):
        the 32 columns of a·b (one outer product and one index_add), then
        16 reduction steps, step i adding m_i·p at digit i and carrying
        digit i on, so no column exceeds 2^38; the high 16 columns are the
        result before the final subtraction. Long inputs run in chunks of
        :data:`MUL_CHUNK` elements for their device."""
        a, b = torch.broadcast_tensors(a, b)
        chunk = MUL_CHUNK.get(a.device.type, MUL_CHUNK["cuda"])
        if a.numel() > chunk * L:
            fa, fb = a.reshape(-1, L), b.reshape(-1, L)
            return torch.cat([self.mont_mul64(fa[i: i + chunk],
                                              fb[i: i + chunk])
                              for i in range(0, fa.shape[0], chunk)]
                             ).reshape(a.shape)
        a16, b16 = _split16(a), _split16(b)
        n16 = 2 * L
        dev = a.device
        t = torch.zeros(a16.shape[:-1] + (2 * n16,), dtype=torch.int64,
                        device=dev)
        t.index_add_(-1, _index("diag", n16, dev),
                     (a16[..., :, None] * b16[..., None, :]).flatten(-2))
        p16 = self._p64(dev, 16)
        for i in range(n16):
            m = (t[..., i] * self.pinv16) & MASK16
            t[..., i:i + n16] += m[..., None] * p16
            t[..., i + 1] += t[..., i] >> 16
        r16 = _carry16(t[..., n16:])
        r = r16[..., 0::2] | (r16[..., 1::2] << 16)
        return self.reduce_once64(r)


FR = Field(pyfield.BN254_FR, "bn254_fr", 0)
FQ = Field(pyfield.BN254_FQ, "bn254_fq", 1)
# Pasta: the pallas curve's base field (point coordinates) and its scalar
# field (the vesta curve's base), as the reference's PASTA_FP / PASTA_FR.
# Their kernels are the binops alone (kernels 1–3).
PASTA_FP = Field(pyfield.PALLAS_BASE, "pasta_fp", 2)
PASTA_FR = Field(pyfield.VESTA_BASE, "pasta_fr", 3)
