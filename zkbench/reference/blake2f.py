"""The BLAKE2 compression F of EIP-152 (RFC 7693 §3.2) over numpy uint64
arrays: every compression of a batch at once."""

from __future__ import annotations

import numpy as np

IV = np.array([
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179], dtype=np.uint64)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

# (a, b, c, d) of the eight G calls of a round: four columns, four diagonals
G_INDICES = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)


def _rotr(x, n: int):
    return (x >> np.uint64(n)) | (x << np.uint64(64 - n))


def compress(h, m, t, f, rounds: int = 12) -> np.ndarray:
    """h (B, 8), m (B, 16), t (B, 2) uint64 and f (B,) bool -> the new
    state (B, 8) uint64."""
    h = np.asarray(h, np.uint64)
    m = np.asarray(m, np.uint64)
    t = np.asarray(t, np.uint64)
    f = np.asarray(f, bool)
    with np.errstate(over="ignore"):
        v = [h[:, i].copy() for i in range(8)] + \
            [np.full(h.shape[0], IV[i], np.uint64) for i in range(8)]
        v[12] ^= t[:, 0]
        v[13] ^= t[:, 1]
        v[14] = np.where(f, ~v[14], v[14])
        for rd in range(rounds):
            s = SIGMA[rd % 10]
            for gi, (a, b, c, d) in enumerate(G_INDICES):
                x, y = m[:, s[2 * gi]], m[:, s[2 * gi + 1]]
                v[a] = v[a] + v[b] + x
                v[d] = _rotr(v[d] ^ v[a], 32)
                v[c] = v[c] + v[d]
                v[b] = _rotr(v[b] ^ v[c], 24)
                v[a] = v[a] + v[b] + y
                v[d] = _rotr(v[d] ^ v[a], 16)
                v[c] = v[c] + v[d]
                v[b] = _rotr(v[b] ^ v[c], 63)
        return np.stack([h[:, i] ^ v[i] ^ v[i + 8] for i in range(8)], 1)
