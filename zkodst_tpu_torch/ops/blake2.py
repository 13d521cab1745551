"""BLAKE2b compression F (EIP-152 / RFC 7693).

Counterpart of ``zkodst_tpu/ops/blake2.py``: the constants, :func:`blake2f`
batched over leading axes on u64 pairs (PyTorch ops on whatever device the
tensors lie), the Python-int oracle :func:`blake2f_py`, the whole hash
:func:`blake2b_py` built on it, and the EIP-152 precompile codec with its
appendix vectors.
"""

from __future__ import annotations

import torch

from . import u64

# RFC 7693 §2.6 — BLAKE2b initialization vector.
IV = (
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
)

# RFC 7693 §2.7 — message word permutation schedule.
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

# RFC 7693 §3.2 — (a, b, c, d) of the 8 G calls per round: 4 column mixes,
# then 4 diagonal mixes.
G_INDICES = (
    (0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
    (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14),
)

ROUNDS = 12
MASK64 = 0xFFFFFFFFFFFFFFFF


def _g_vec(a, b, c, d, x, y):
    """G over a trailing lane axis: every argument (..., 4, 2)."""
    a = u64.add(u64.add(a, b), x)
    d = u64.rotr(u64.xor(d, a), 32)
    c = u64.add(c, d)
    b = u64.rotr(u64.xor(b, c), 24)
    a = u64.add(u64.add(a, b), y)
    d = u64.rotr(u64.xor(d, a), 16)
    c = u64.add(c, d)
    b = u64.rotr(u64.xor(b, c), 63)
    return a, b, c, d


def blake2f(h: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
            f: torch.Tensor, rounds: int = ROUNDS) -> torch.Tensor:
    """EIP-152 compression F, batched over leading axes.

    h (..., 8, 2), m (..., 16, 2), t (..., 2, 2): u64 pairs in integer
    tensors (values < 2^32); f (...,): the final-block flags. Returns the
    new state h' (..., 8, 2) int64 on the inputs' device. A round is the
    four column G calls as one step over a lane axis of 4, then the four
    diagonal ones after rotating the b, c and d rows."""
    h, m, t = (x.to(torch.int64) for x in (h, m, t))
    fmask = torch.where(f.to(torch.bool), u64.MASK32, 0)[..., None]
    iv = torch.tensor(u64.from_ints(list(IV)).astype("int64"),
                      device=h.device).expand_as(h)
    v = torch.cat([h, iv], dim=-2)
    v[..., 12, :] ^= t[..., 0, :]
    v[..., 13, :] ^= t[..., 1, :]
    v[..., 14, :] ^= fmask.expand_as(v[..., 14, :])
    for r in range(int(rounds)):
        s = torch.tensor(SIGMA[r % 10], device=h.device)
        a, b, c, d = (v[..., 4 * i:4 * i + 4, :] for i in range(4))
        a, b, c, d = _g_vec(a, b, c, d, m[..., s[0:8:2], :],
                            m[..., s[1:8:2], :])
        b, c, d = (torch.roll(x, -i, -2) for i, x in ((1, b), (2, c), (3, d)))
        a, b, c, d = _g_vec(a, b, c, d, m[..., s[8:16:2], :],
                            m[..., s[9:16:2], :])
        b, c, d = (torch.roll(x, i, -2) for i, x in ((1, b), (2, c), (3, d)))
        v = torch.cat([a, b, c, d], dim=-2)
    return u64.xor(u64.xor(h, v[..., 0:8, :]), v[..., 8:16, :])


def _rotr64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def _g_py(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & MASK64
    v[d] = _rotr64(v[d] ^ v[a], 32)
    v[c] = (v[c] + v[d]) & MASK64
    v[b] = _rotr64(v[b] ^ v[c], 24)
    v[a] = (v[a] + v[b] + y) & MASK64
    v[d] = _rotr64(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & MASK64
    v[b] = _rotr64(v[b] ^ v[c], 63)


def blake2f_py(h, m, t, f: bool, rounds: int = ROUNDS):
    """Python-int reference for F. h: list[8], m: list[16], t: (t0, t1)."""
    h = [x & MASK64 for x in h]
    v = h + list(IV)
    v[12] ^= t[0] & MASK64
    v[13] ^= t[1] & MASK64
    if f:
        v[14] ^= MASK64
    for r in range(rounds):
        s = SIGMA[r % 10]
        for gi, (a, b, c, d) in enumerate(G_INDICES):
            _g_py(v, a, b, c, d, m[s[2 * gi]], m[s[2 * gi + 1]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2b_py(data: bytes, digest_size: int = 64) -> bytes:
    """The whole (unkeyed) BLAKE2b on :func:`blake2f_py` (RFC 7693 §3.3)."""
    h = list(IV)
    h[0] ^= 0x01010000 ^ digest_size
    blocks = [data[i:i + 128] for i in range(0, len(data), 128)] or [b""]
    t = 0
    for i, block in enumerate(blocks):
        last = i == len(blocks) - 1
        t += len(block)
        padded = block + b"\x00" * (128 - len(block))
        m = [int.from_bytes(padded[j * 8:(j + 1) * 8], "little")
             for j in range(16)]
        h = blake2f_py(h, m, (t, 0), last)
    out = b"".join(x.to_bytes(8, "little") for x in h)
    return out[:digest_size]


# EIP-152 test vector 5 (= the final compression of blake2b-512("abc")).
EIP152_VECTOR = dict(
    rounds=12,
    h=(0x6A09E667F2BDC948, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
       0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
       0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179),
    m=(0x0000000000636261,) + (0,) * 15,
    t=(3, 0),
    f=True,
    expected=(
        "ba80a53f981c4d0d6a2797b69f12f6e94c212f14685ac4b74b12bb6fdbffa2d1"
        "7d87c5392aab792dc252d5de4533cc9518d38aa8dbf1925ab92386edd4009923"),
)


# ---------------------------------------------------------------------------
# EIP-152 precompile interface and the appendix vectors
# ---------------------------------------------------------------------------

EIP152_INPUT_LEN = 213   # 4 (rounds, BE) + 64 (h) + 128 (m) + 16 (t) + 1 (f)


def eip152_encode(rounds: int, h, m, t, f: bool) -> bytes:
    """F's inputs as the EIP-152 precompile call data (213 bytes)."""
    out = rounds.to_bytes(4, "big")
    out += b"".join(x.to_bytes(8, "little") for x in h)
    out += b"".join(x.to_bytes(8, "little") for x in m)
    out += t[0].to_bytes(8, "little") + t[1].to_bytes(8, "little")
    out += bytes([1 if f else 0])
    return out


def eip152_decode(data: bytes):
    """Parse and validate precompile input -> (rounds, h, m, t, f).
    Raises ValueError on a wrong length or a final-block flag other than
    0 or 1 (appendix vectors 1–3)."""
    if len(data) != EIP152_INPUT_LEN:
        raise ValueError(f"input length {len(data)} != {EIP152_INPUT_LEN}")
    rounds = int.from_bytes(data[0:4], "big")
    h = [int.from_bytes(data[4 + 8 * i: 12 + 8 * i], "little")
         for i in range(8)]
    m = [int.from_bytes(data[68 + 8 * i: 76 + 8 * i], "little")
         for i in range(16)]
    t = (int.from_bytes(data[196:204], "little"),
         int.from_bytes(data[204:212], "little"))
    if data[212] not in (0, 1):
        raise ValueError(f"final-block flag must be 0 or 1, got {data[212]}")
    return rounds, h, m, t, data[212] == 1


def _v5_input(rounds=12, f=True) -> bytes:
    v = EIP152_VECTOR
    return eip152_encode(rounds, v["h"], v["m"], v["t"], f)


# The EIP-152 appendix vectors: 1–3 are the malformed-input classes (short
# input, long input, invalid flag), 4–7 pin the published digests, 8
# (rounds = 2^32 − 1) is decoded only.
EIP152_VECTORS = [
    dict(n=1, input=_v5_input()[:-1], error="input length"),
    dict(n=2, input=_v5_input() + b"\x00", error="input length"),
    dict(n=3, input=_v5_input()[:-1] + b"\x02", error="final-block flag"),
    dict(n=4, input=_v5_input(rounds=0), expected=(
        "08c9bcf367e6096a3ba7ca8485ae67bb2bf894fe72f36e3cf1361d5f3af54fa5"
        "d282e6ad7f520e511f6c3e2b8c68059b9442be0454267ce079217e1319cde05b")),
    dict(n=5, input=_v5_input(), expected=EIP152_VECTOR["expected"]),
    dict(n=6, input=_v5_input(f=False), expected=(
        "75ab69d3190a562c51aef8d88f1c2775876944407270c42c9844252c26d28752"
        "98743e7f6d5ea2f2d3e8d226039cd31b4e426ac4f2d3d666a610c2116fde4735")),
    dict(n=7, input=_v5_input(rounds=1), expected=(
        "b63a380cb2897d521994a85234ee2c181b5f844d2c624c002677e9703449d2fb"
        "a551b3a8333bcdf5f2f7e08993d53923de3d64fcc68c034e717b9293fed7a421")),
    dict(n=8, input=_v5_input(rounds=0xFFFFFFFF), expected=None),
]
