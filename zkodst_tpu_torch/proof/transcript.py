"""Fiat–Shamir transcript: the prover's and the verifier's side, in three
wire formats.

A copy of ``zkodst_tpu/proof/transcript.py``. Every mode hashes with
Blake2b-512 under
the personalization ``b"Halo2-Transcript"``, with domain prefixes 0 =
challenge squeeze, 1 = point, 2 = scalar; scalars are 32-byte LE; a
challenge absorbs prefix 0, finalizes a copy of the state to 64 bytes and
reduces the 512-bit LE integer mod r.

* ``"v1"``: points are absorbed and written as 32-byte compressed G1 (LE x,
  y parity in bit 255, identity = zeros).
* ``"halo2ce"``: points are absorbed as their full affine coordinates
  (x ∥ y, 32-byte LE each) and written in the halo2curves bn256 layout (LE
  x, y parity in bit 6 of byte 31, bit 255 clear); the verifying key
  enters as one scalar (``VerifyingKey.transcript_repr``) and the
  instances value by value (``prover.absorb_instances``).
* ``"pasta"`` (the IPA backend on the Pasta pallas curve): points are
  absorbed and written as 32 bytes, LE x (255 bits: PALLAS_BASE is above
  2^254) with y's parity in bit 255; scalars and challenges are mod
  VESTA_BASE, the curve's scalar field.
"""

from __future__ import annotations

import hashlib

from ..ops import pycurve
from ..ops.pyfield import FQ, FR, PALLAS_BASE, PF, VESTA_BASE

PERSON = b"Halo2-Transcript"
PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"

MODES = ("v1", "halo2ce", "pasta")
_PALLAS = PF(PALLAS_BASE, "pallas_base")


def compress_g1(pt) -> bytes:
    """Affine (x, y) int tuple or None -> 32 bytes (LE x, y-parity bit 255)."""
    if pt is None:
        return bytes(32)
    x, y = pt
    b = bytearray(int(x).to_bytes(32, "little"))
    assert b[31] & 0xC0 == 0, "x exceeds 254 bits"
    if y & 1:
        b[31] |= 0x80
    return bytes(b)


def _point_from(b: bytearray, ysign: int):
    """The point with x = `b` (sign bits cleared) and y of parity `ysign`;
    raises ValueError if there is none."""
    b[31] &= 0x3F
    x = int.from_bytes(bytes(b), "little")
    if x >= FQ.p:
        raise ValueError("x out of range")
    y = FQ.sqrt((x * x % FQ.p) * x % FQ.p + pycurve.B1)
    if y is None:
        raise ValueError("not on the curve")
    if (y & 1) != ysign:
        y = FQ.p - y
    return (x, y)


def decompress_g1(data: bytes):
    """Inverse of compress_g1; raises ValueError unless `data` encodes a
    point of the curve (or the identity)."""
    if len(data) != 32:
        raise ValueError("a point takes 32 bytes")
    if data == bytes(32):
        return None
    b = bytearray(data)
    if b[31] & 0x40:
        raise ValueError("bit 254 is set (compress_g1 never sets it)")
    return _point_from(b, (b[31] >> 7) & 1)


def compress_g1_halo2ce(pt) -> bytes:
    """halo2curves bn256 layout: 32-byte LE x, y parity in bit 6 of byte
    31; the identity is 32 zero bytes."""
    if pt is None:
        return bytes(32)
    x, y = pt
    b = bytearray(int(x).to_bytes(32, "little"))
    assert b[31] & 0xC0 == 0, "x exceeds 254 bits"
    if y & 1:
        b[31] |= 0x40
    return bytes(b)


def decompress_g1_halo2ce(data: bytes):
    """Inverse of compress_g1_halo2ce; raises ValueError unless `data`
    encodes a point of the curve (or the identity) with bit 255 clear."""
    if len(data) != 32:
        raise ValueError("a point takes 32 bytes")
    if data == bytes(32):
        return None
    b = bytearray(data)
    if b[31] & 0x80:
        raise ValueError("bit 255 must be clear (halo2curves layout)")
    return _point_from(b, (b[31] >> 6) & 1)


def compress_pasta(pt) -> bytes:
    """Pallas point -> 32 bytes: LE x (255 bits), y's parity in bit 255;
    the identity is 32 zero bytes."""
    if pt is None:
        return bytes(32)
    x, y = pt
    b = bytearray(int(x).to_bytes(32, "little"))
    assert b[31] & 0x80 == 0, "x exceeds 255 bits"
    if y & 1:
        b[31] |= 0x80
    return bytes(b)


def decompress_pasta(data: bytes):
    """Inverse of compress_pasta (y² = x³ + 5 over PALLAS_BASE); raises
    ValueError unless `data` encodes a point of the curve (or the
    identity)."""
    if len(data) != 32:
        raise ValueError("a point takes 32 bytes")
    if data == bytes(32):
        return None
    b = bytearray(data)
    ysign = (b[31] >> 7) & 1
    b[31] &= 0x7F
    x = int.from_bytes(bytes(b), "little")
    p = _PALLAS.p
    if x >= p:
        raise ValueError("x out of range")
    y = _PALLAS.sqrt((x * x % p * x + pycurve.PASTA_G1.b) % p)
    if y is None:
        raise ValueError("not on the curve")
    if (y & 1) != ysign:
        y = p - y
    return (x, y)


def _coords_bytes(pt) -> bytes:
    """Full affine coordinates x ∥ y (32-byte LE each); identity = zeros."""
    if pt is None:
        return bytes(64)
    return (int(pt[0]).to_bytes(32, "little")
            + int(pt[1]).to_bytes(32, "little"))


class _Transcript:
    """The Blake2b state both sides absorb into and squeeze from."""

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"transcript mode {mode!r} is not one of "
                             f"{MODES}")
        self.mode = mode
        self.r = VESTA_BASE if mode == "pasta" else FR.p   # scalars mod r
        self._h = hashlib.blake2b(digest_size=64, person=PERSON)

    def _wire(self, pt) -> bytes:
        """A point as the proof carries it."""
        if self.mode == "halo2ce":
            return compress_g1_halo2ce(pt)
        if self.mode == "pasta":
            return compress_pasta(pt)
        return compress_g1(pt)

    def common_point(self, pt) -> None:
        self._h.update(PREFIX_POINT)
        if self.mode == "halo2ce":
            self._h.update(_coords_bytes(pt))
        else:
            self._h.update(self._wire(pt))

    def common_scalar(self, v: int) -> None:
        self._h.update(PREFIX_SCALAR)
        self._h.update((int(v) % self.r).to_bytes(32, "little"))

    def squeeze_challenge(self) -> int:
        self._h.update(PREFIX_CHALLENGE)
        wide = self._h.copy().digest()
        return int.from_bytes(wide, "little") % self.r


class Blake2bWrite(_Transcript):
    """Prover-side transcript: absorbs proof elements, emits proof bytes."""

    def __init__(self, mode: str = "v1"):
        super().__init__(mode)
        self._proof = bytearray()

    def write_point(self, pt) -> None:
        self.common_point(pt)
        self._proof += self._wire(pt)

    def write_scalar(self, v: int) -> None:
        self.common_scalar(v)
        self._proof += (int(v) % self.r).to_bytes(32, "little")

    def finalize(self) -> bytes:
        return bytes(self._proof)


class Blake2bRead(_Transcript):
    """Verifier-side transcript: replays a proof byte stream. A malformed
    or missing element raises ValueError."""

    def __init__(self, proof: bytes, mode: str = "v1"):
        super().__init__(mode)
        self._proof = proof
        self._pos = 0

    def _take(self, nbytes: int) -> bytes:
        if self._pos + nbytes > len(self._proof):
            raise ValueError("proof too short")
        out = self._proof[self._pos: self._pos + nbytes]
        self._pos += nbytes
        return out

    def read_point(self):
        data = self._take(32)
        decode = {"halo2ce": decompress_g1_halo2ce,
                  "pasta": decompress_pasta}.get(self.mode, decompress_g1)
        pt = decode(data)
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        v = int.from_bytes(self._take(32), "little")
        if v >= self.r:
            raise ValueError("scalar out of range")
        self.common_scalar(v)
        return v

    def done(self) -> bool:
        return self._pos == len(self._proof)
