"""The verifier's side of the proof's Fiat–Shamir transcript, format "v1":
Blake2b-512 under the personalization ``Halo2-Transcript``, prefix 0 for
a challenge, 1 for a point, 2 for a scalar; points as 32-byte compressed
G1, scalars as 32-byte little-endian ints below r; a challenge is the
512-bit digest of a copy of the state, reduced mod r."""

from __future__ import annotations

import hashlib

from . import curve
from .field import R


class Transcript:
    def __init__(self, proof: bytes = b""):
        self._h = hashlib.blake2b(digest_size=64, person=b"Halo2-Transcript")
        self._proof = proof
        self._pos = 0

    def common_point(self, pt) -> None:
        self._h.update(b"\x01" + curve.compress(pt))

    def common_scalar(self, v: int) -> None:
        self._h.update(b"\x02" + (int(v) % R).to_bytes(32, "little"))

    def squeeze(self) -> int:
        self._h.update(b"\x00")
        return int.from_bytes(self._h.copy().digest(), "little") % R

    def _take(self, nbytes: int) -> bytes:
        if self._pos + nbytes > len(self._proof):
            raise ValueError("proof too short")
        out = self._proof[self._pos: self._pos + nbytes]
        self._pos += nbytes
        return out

    def read_point(self):
        pt = curve.decompress(self._take(32))
        self.common_point(pt)
        return pt

    def read_scalar(self) -> int:
        v = int.from_bytes(self._take(32), "little")
        if v >= R:
            raise ValueError("scalar out of range")
        self.common_scalar(v)
        return v

    def done(self) -> bool:
        return self._pos == len(self._proof)
