"""Streaming BLAKE2b hash gadget over the F-compression circuit.

Counterpart of ``zkodst_tpu/gadget.py``. The circuit proves the EIP-152
compression F once per instance, so a multi-block hash is a chain of
instances. The chain is checked on public values: every block's input
state h and output state h' are in the instance column, so the verifier
checks h_{i+1} == h'_i, h_0 == the parameterized IV and the t/f schedule
of RFC 7693 §3.3 (:func:`check_chain`), with no copies in the circuit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops import blake2, u64

BLOCK_BYTES = 128
MASK64 = 0xFFFFFFFFFFFFFFFF


@dataclass
class BlockCall:
    """One F call: the public inputs and outputs of one circuit instance."""

    h: Tuple[int, ...]        # 8 input state words
    m: Tuple[int, ...]        # 16 message words
    t: Tuple[int, int]        # offset counter (lo, hi)
    f: bool                   # final-block flag
    h_out: Tuple[int, ...]    # 8 output state words


class Blake2b:
    """Streaming (unkeyed) BLAKE2b that records its F calls: `finalize`
    returns (digest, [BlockCall, ...]), the instances to prove."""

    def __init__(self, digest_size: int = 64, rounds: int = 12):
        if not 1 <= digest_size <= 64:
            raise ValueError(f"digest_size {digest_size} not in 1..64")
        self.digest_size = digest_size
        self.rounds = rounds
        self.h = list(blake2.IV)
        self.h[0] ^= 0x01010000 ^ digest_size
        self._buf = b""
        self._t = 0
        self._calls: List[BlockCall] = []
        self._done = False

    def update(self, data: bytes) -> "Blake2b":
        if self._done:
            raise RuntimeError("finalize() already called")
        self._buf += data
        # compress every full block but a trailing exactly-full one: it
        # may be the final block, which needs f = true
        while len(self._buf) > BLOCK_BYTES:
            self._compress(self._buf[:BLOCK_BYTES], final=False)
            self._buf = self._buf[BLOCK_BYTES:]
        return self

    def _compress(self, block: bytes, final: bool) -> None:
        self._t += len(block)
        padded = block + b"\x00" * (BLOCK_BYTES - len(block))
        m = tuple(int.from_bytes(padded[j * 8:(j + 1) * 8], "little")
                  for j in range(16))
        t = (self._t & MASK64, (self._t >> 64) & MASK64)
        h_in = tuple(self.h)
        self.h = blake2.blake2f_py(list(self.h), list(m), t, final,
                                   self.rounds)
        self._calls.append(BlockCall(h_in, m, t, final, tuple(self.h)))

    def finalize(self) -> Tuple[bytes, List[BlockCall]]:
        if self._done:
            raise RuntimeError("finalize() already called")
        self._done = True
        self._compress(self._buf, final=True)
        self._buf = b""
        out = b"".join(x.to_bytes(8, "little") for x in self.h)
        return out[: self.digest_size], list(self._calls)

    @classmethod
    def digest(cls, data: bytes, digest_size: int = 64
               ) -> Tuple[bytes, List[BlockCall]]:
        return cls(digest_size).update(data).finalize()


def calls_to_arrays(calls: Sequence[BlockCall], pad_to: Optional[int] = None):
    """BlockCalls -> the circuit's batched (h, m, t, f) inputs (numpy);
    padding repeats the last call so the batch matches n_inst."""
    calls = list(calls)
    if pad_to is not None:
        if len(calls) > pad_to:
            raise ValueError(f"{len(calls)} blocks > {pad_to} instances")
        calls = calls + [calls[-1]] * (pad_to - len(calls))
    h = u64.from_ints([c.h for c in calls])
    m = u64.from_ints([c.m for c in calls])
    t = u64.from_ints([c.t for c in calls])
    f = np.array([c.f for c in calls], bool)
    return h, m, t, f


def check_chain(calls: Sequence[BlockCall], data_len: int,
                digest_size: int = 64) -> bool:
    """The verifier's chain rules over the public per-block values: the
    parameterized IV start, the h feed-forward and the t/f schedule."""
    if not calls:
        return False
    iv0 = list(blake2.IV)
    iv0[0] ^= 0x01010000 ^ digest_size
    if calls[0].h != tuple(iv0):
        return False
    nblocks = max(1, (data_len + BLOCK_BYTES - 1) // BLOCK_BYTES)
    if len(calls) != nblocks:
        return False
    for i, c in enumerate(calls):
        last = i == nblocks - 1
        if c.f != last:
            return False
        expect_t = data_len if last else (i + 1) * BLOCK_BYTES
        if c.t != (expect_t & MASK64, (expect_t >> 64) & MASK64):
            return False
        if i > 0 and c.h != calls[i - 1].h_out:
            return False
    return True


def chain_digest(calls: Sequence[BlockCall], digest_size: int = 64) -> bytes:
    out = b"".join(x.to_bytes(8, "little") for x in calls[-1].h_out)
    return out[:digest_size]


def instance_column_calls(built, pub, n_blocks: int) -> List[BlockCall]:
    """The BlockCalls read back from a proved instance column `pub` ((n, 2)
    u64 pairs, tensor or numpy) at the circuit's public-row layout."""
    from .circuit import blake2f as bc

    if isinstance(pub, torch.Tensor):
        pub = pub.cpu().numpy()
    words = u64.to_ints(np.asarray(pub)[: n_blocks * bc.R_PUB])
    calls = []
    for i in range(n_blocks):
        base = i * bc.R_PUB

        def word(r):
            return int(words[base + r])

        calls.append(BlockCall(
            h=tuple(word(bc.ROW_H + j) for j in range(8)),
            m=tuple(word(bc.ROW_M + j) for j in range(16)),
            t=(word(bc.ROW_T), word(bc.ROW_T + 1)),
            f=bool(word(bc.ROW_F)),
            h_out=tuple(word(bc.ROW_OUT + j) for j in range(8)),
        ))
    return calls
