"""Fiat–Shamir transcript, prover side, v1 wire format.

A copy of the v1 mode of ``zkodst_tpu/proof/transcript.py``
``Blake2bWrite`` (:163-210): Blake2b-512 with personalization
``b"Halo2-Transcript"``; domain prefixes 0 = challenge squeeze, 1 = point,
2 = scalar; points absorbed and serialized as 32-byte compressed G1 (LE x,
y parity in bit 255, identity = zeros), scalars as 32-byte LE. A challenge
absorbs prefix 0, finalizes a copy of the state to 64 bytes and reduces
the 512-bit LE integer mod r.
"""

from __future__ import annotations

import hashlib

from ..ops.pyfield import FR

PERSON = b"Halo2-Transcript"
PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"


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


class Blake2bWrite:
    """Prover-side transcript: absorbs proof elements, emits proof bytes."""

    def __init__(self):
        self._h = hashlib.blake2b(digest_size=64, person=PERSON)
        self._proof = bytearray()

    def common_point(self, pt) -> None:
        self._h.update(PREFIX_POINT)
        self._h.update(compress_g1(pt))

    def common_scalar(self, v: int) -> None:
        self._h.update(PREFIX_SCALAR)
        self._h.update((int(v) % FR.p).to_bytes(32, "little"))

    def write_point(self, pt) -> None:
        self.common_point(pt)
        self._proof += compress_g1(pt)

    def write_scalar(self, v: int) -> None:
        self.common_scalar(v)
        self._proof += (int(v) % FR.p).to_bytes(32, "little")

    def squeeze_challenge(self) -> int:
        self._h.update(PREFIX_CHALLENGE)
        wide = self._h.copy().digest()
        return int.from_bytes(wide, "little") % FR.p

    def finalize(self) -> bytes:
        return bytes(self._proof)
