"""Kernels 13 and 14: the BLAKE2f circuit's witness stream and the batched
BLAKE2f compression (CUDA source ``cuda/csrc/blake2f.cu``, the shared
arithmetic and cell writer in ``cuda/csrc/blake2f.cuh``), each beside its
plain PyTorch version.

=======================  ==============================================
wrapper                  replaces no Pallas kernel; in the JAX package
=======================  ==============================================
``blake2f_witness``      the ``lax.scan`` of ``circuit/blake2f.py``'s
                         ``_numeric_stream`` (jitted whole)
``blake2f_compress``     the ``lax.scan`` of ``ops/blake2.py``'s
                         ``blake2f`` (under ``jax.jit``)
=======================  ==============================================

The JAX package compiles both round loops into one XLA program each; as
eager PyTorch operations they are ~12,780 launches a flagship witness and
~1,930 a compression batch. Words are int64-held (lo, hi) pairs of 32-bit
halves, as everywhere in the port. They are counted apart from the twelve
ported Pallas kernels (:data:`..kernels.BLAKE2F_WRAPPERS`).
"""

from __future__ import annotations

import torch

from ..ops import blake2 as oblake2
from .build import call
from .mulmod import _ready

INIT_CELLS, G_CELLS, FINAL_CELLS = 143, 131, 8 * 33


def n_cells(rounds: int) -> int:
    """Cells of one instance's witness stream (12,983 at 12 rounds)."""
    return INIT_CELLS + 8 * G_CELLS * rounds + FINAL_CELLS


def _rounds(name: str, rounds) -> int:
    rounds = int(rounds)
    if not 0 <= rounds < 1 << 32:
        raise ValueError(f"{name}: rounds must be in [0, 2^32), got {rounds}")
    return rounds


# -- kernel 13: the witness stream --------------------------------------------

_SPREAD = {}        # device -> the 2^16 spread table of the plain version


def blake2f_witness_plain(h, m, t, f, rounds: int):
    """``circuit/blake2f._numeric_stream`` as (stream (B, cells, 2), h'
    (B, 8, 2))."""
    from ..circuit.blake2f import _numeric_stream
    from ..circuit.spread import spread_table

    tab = _SPREAD.get(h.device)
    if tab is None:
        tab = _SPREAD[h.device] = torch.from_numpy(spread_table()).to(
            h.device)
    lo, hi, out = _numeric_stream(h, m, t, f, rounds, tab)
    return torch.stack([lo, hi], dim=-1), out


def blake2f_witness(h, m, t, f, rounds: int):
    """The witness cell stream of B compressions in `_schedule`'s push
    order: h (B, 8, 2), m (B, 16, 2), t (B, 2, 2) int64 pairs, f (B,)
    int64 0 or 1. Returns (stream (B, n_cells(rounds), 2), h' (B, 8, 2)),
    int64."""
    B = h.shape[0] if h.dim() else -1
    if any(x.dtype != torch.int64 or tuple(x.shape) != shape
           or x.device != h.device
           for x, shape in ((h, (B, 8, 2)), (m, (B, 16, 2)), (t, (B, 2, 2)),
                            (f, (B,)))):
        raise ValueError("blake2f_witness takes int64 h (B, 8, 2), m (B, 16, "
                         "2), t (B, 2, 2) and f (B,) on one device, got "
                         f"{[(x.dtype, tuple(x.shape)) for x in (h, m, t, f)]}")
    rounds = _rounds("blake2f_witness", rounds)
    if h.device.type == "cpu":
        return blake2f_witness_plain(h, m, t, f, rounds)
    h, m, t, f = (_ready(x) for x in (h, m, t, f))
    stream = torch.empty((B, n_cells(rounds), 2), dtype=torch.int64,
                         device=h.device)
    out = torch.empty((B, 8, 2), dtype=torch.int64, device=h.device)
    if B:
        call("blake2f", "zk_blake2f_witness", h.data_ptr(), m.data_ptr(),
             t.data_ptr(), f.data_ptr(), stream.data_ptr(), out.data_ptr(),
             B, rounds)
    return stream, out


# -- kernel 14: the compression -----------------------------------------------

blake2f_compress_plain = oblake2.blake2f


def blake2f_compress(h, m, t, f, rounds: int = oblake2.ROUNDS):
    """EIP-152 compression F batched over leading axes (broadcast): h (...,
    8, 2), m (..., 16, 2), t (..., 2, 2) u64 pairs in any integer type
    (halves below 2^32), f (...,) final-block flags. Returns h' (..., 8, 2)
    int64."""
    tails = (h.shape[-2:], m.shape[-2:], t.shape[-2:])
    if tails != ((8, 2), (16, 2), (2, 2)) \
            or len({x.device for x in (h, m, t, f)}) > 1:
        raise ValueError("blake2f_compress takes h (..., 8, 2), m (..., 16, 2)"
                         ", t (..., 2, 2) and f (...) on one device, got "
                         f"{[tuple(x.shape) for x in (h, m, t, f)]}")
    rounds = _rounds("blake2f_compress", rounds)
    if h.device.type == "cpu":
        return blake2f_compress_plain(h, m, t, f, rounds)
    lead = torch.broadcast_shapes(h.shape[:-2], m.shape[:-2], t.shape[:-2],
                                  f.shape)
    h, m, t = (_ready(x.to(torch.int64).expand(lead + x.shape[-2:]))
               for x in (h, m, t))
    f = _ready(f.to(torch.bool).expand(lead))
    out = torch.empty(lead + (8, 2), dtype=torch.int64, device=h.device)
    if out.numel():
        call("blake2f", "zk_blake2f_compress", h.data_ptr(), m.data_ptr(),
             t.data_ptr(), f.data_ptr(), out.data_ptr(), out.numel() // 16,
             rounds)
    return out
