"""Kernels 13 and 14: the BLAKE2f circuit's witness, written into its
columns or as a stream, and the batched BLAKE2f compression (CUDA source
``cuda/csrc/blake2f.cu``, the shared arithmetic, chain and cell writer in
``cuda/csrc/blake2f.cuh``), each beside its plain PyTorch version.

=======================  ==============================================
wrapper                  replaces no Pallas kernel; in the JAX package
=======================  ==============================================
``blake2f_advice``       ``circuit/blake2f.py``'s ``_numeric_stream``
                         and the scatter into the columns, jitted as one
                         program by ``Blake2fCircuit._witness_impl``
``blake2f_witness``      the same kernel writing the stream itself (the
                         ``lax.scan`` of ``_numeric_stream``)
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

from dataclasses import dataclass

import torch

from ..ops import blake2 as oblake2
from .build import call
from .mulmod import _ready

INIT_CELLS, G_CELLS, FINAL_CELLS = 143, 131, 8 * 33
MAX_GROUPS = 65535      # the kernel's grid: rounds + 2 groups an instance


def n_cells(rounds: int) -> int:
    """Cells of one instance's witness stream (12,983 at 12 rounds)."""
    return INIT_CELLS + 8 * G_CELLS * rounds + FINAL_CELLS


def _rounds(name: str, rounds) -> int:
    rounds = int(rounds)
    if not 0 <= rounds < 1 << 32:
        raise ValueError(f"{name}: rounds must be in [0, 2^32), got {rounds}")
    return rounds


def _witness_inputs(name: str, h, m, t, f, rounds) -> tuple:
    """(B, rounds) of a witness call, or ValueError."""
    B = h.shape[0] if h.dim() else -1
    if any(x.dtype != torch.int64 or tuple(x.shape) != shape
           or x.device != h.device
           for x, shape in ((h, (B, 8, 2)), (m, (B, 16, 2)), (t, (B, 2, 2)),
                            (f, (B,)))):
        raise ValueError(f"{name} takes int64 h (B, 8, 2), m (B, 16, 2), "
                         "t (B, 2, 2) and f (B,) on one device, got "
                         f"{[(x.dtype, tuple(x.shape)) for x in (h, m, t, f)]}")
    rounds = _rounds(name, rounds)
    if h.device.type != "cpu" and rounds + 2 > MAX_GROUPS:
        raise ValueError(f"{name}: at most {MAX_GROUPS - 2} rounds on the "
                         f"card, got {rounds}")
    return B, rounds


# -- kernel 13: the witness ---------------------------------------------------

@dataclass(frozen=True, eq=False, repr=False)
class Placement:
    """Where one instance's witness stream goes in the circuit's columns,
    built once per circuit (``Blake2fCircuit``) from its layout. Instance b
    takes rows b·rows to (b + 1)·rows of every advice column and rows
    b·pub_rows on of the instance column; a cell no placement reaches is
    zero."""

    columns: tuple          # the advice columns, in the output's order
    n: int                  # rows of a column
    rows: int               # rows an instance takes
    pub_rows: int           # rows an instance takes in the instance column
    cells: int              # cells of an instance's stream
    # the plain version's: column -> (rows, stream indices), and column ->
    # (rows, (k, 2) values) for the constant cells
    scatter: dict
    const_scatter: dict
    # the kernel's (blake2f.cuh, place_cell): (cells, 4) int32: col·n +
    # row, −1 for none, a fourth ≤ −2 pointing into `more`; the constant
    # cells as col·n + row and (lo, hi)
    slots: torch.Tensor
    more: torch.Tensor
    const_dst: torch.Tensor
    const_val: torch.Tensor

    def __repr__(self) -> str:
        return (f"Placement({self.cells} cells, {self.rows} rows an "
                f"instance, n = {self.n})")


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


def blake2f_advice_plain(h, m, t, f, rounds: int, plan: Placement):
    """``_numeric_stream``, then the scatter of its cells, the constant
    cells and the instance block into zeroed columns."""
    stream, out = blake2f_witness_plain(h, m, t, f, rounds)
    B, dev = h.shape[0], h.device
    cols = torch.zeros((len(plan.columns) + 1, plan.n, 2), dtype=torch.int64,
                       device=dev)
    off = plan.rows * torch.arange(B, device=dev)[:, None]
    for j, col in enumerate(plan.columns):
        if col in plan.scatter:
            rows, idxs = plan.scatter[col]
            cols[j, (rows + off).ravel()] = stream[:, idxs].reshape(-1, 2)
        if col in plan.const_scatter:
            rows, vals = plan.const_scatter[col]
            cols[j, (rows + off).ravel()] = vals.repeat(B, 1)
    fcol = torch.stack([f, torch.zeros_like(f)], dim=-1)
    block = torch.cat([t, fcol[:, None, :], h, m, out], dim=-2)
    prow = (plan.pub_rows * torch.arange(B, device=dev)[:, None]
            + torch.arange(plan.pub_rows, device=dev)[None, :])
    cols[-1, prow.ravel()] = block.reshape(-1, 2)
    return cols


def blake2f_advice(h, m, t, f, rounds: int, plan: Placement):
    """The witness of B instances written into the circuit's columns: h
    (B, 8, 2), m (B, 16, 2), t (B, 2, 2) int64 pairs, f (B,) int64 0 or 1.
    Returns (len(plan.columns) + 1, n, 2) int64: the advice columns in
    ``plan.columns``' order, then the instance column. On the card: one
    memset and one launch."""
    B, rounds = _witness_inputs("blake2f_advice", h, m, t, f, rounds)
    if plan.cells != n_cells(rounds) or B * plan.rows > plan.n:
        raise ValueError(f"blake2f_advice: the placement holds {plan.cells} "
                         f"cells, {plan.n // max(plan.rows, 1)} instances; "
                         f"got {B} instances of {n_cells(rounds)} cells")
    if h.device.type == "cpu":
        return blake2f_advice_plain(h, m, t, f, rounds, plan)
    if plan.slots.device != h.device:
        raise ValueError("blake2f_advice: the placement is on "
                         f"{plan.slots.device}, the inputs on {h.device}")
    h, m, t, f = (_ready(x) for x in (h, m, t, f))
    cols = torch.empty((len(plan.columns) + 1, plan.n, 2), dtype=torch.int64,
                       device=h.device)
    call("blake2f", "zk_blake2f_advice", h.data_ptr(), m.data_ptr(),
         t.data_ptr(), f.data_ptr(), plan.slots.data_ptr(),
         plan.more.data_ptr(), plan.const_dst.data_ptr(),
         plan.const_val.data_ptr(), plan.const_dst.numel(), cols.data_ptr(),
         plan.rows, cols[-1].data_ptr(), cols.numel() * 8, B, rounds)
    return cols


_IDENTITY = {}      # (device, rounds) -> the identity placement's slots


def _identity(dev, rounds: int) -> torch.Tensor:
    """Slots that place cell i of an instance's stream at its index i."""
    slots = _IDENTITY.get((dev, rounds))
    if slots is None:
        cells = n_cells(rounds)
        slots = torch.full((cells, 4), -1, dtype=torch.int32, device=dev)
        slots[:, 0] = torch.arange(cells, dtype=torch.int32, device=dev)
        _IDENTITY[(dev, rounds)] = slots
    return slots


def blake2f_witness(h, m, t, f, rounds: int):
    """The witness cell stream of B compressions in `_schedule`'s push
    order: h (B, 8, 2), m (B, 16, 2), t (B, 2, 2) int64 pairs, f (B,)
    int64 0 or 1. Returns (stream (B, n_cells(rounds), 2), h' (B, 8, 2)),
    int64. On the card, the advice kernel with the identity placement."""
    B, rounds = _witness_inputs("blake2f_witness", h, m, t, f, rounds)
    if h.device.type == "cpu":
        return blake2f_witness_plain(h, m, t, f, rounds)
    h, m, t, f = (_ready(x) for x in (h, m, t, f))
    stream = torch.empty((B, n_cells(rounds), 2), dtype=torch.int64,
                         device=h.device)
    out = torch.empty((B, 8, 2), dtype=torch.int64, device=h.device)
    if B:
        call("blake2f", "zk_blake2f_witness", h.data_ptr(), m.data_ptr(),
             t.data_ptr(), f.data_ptr(), _identity(h.device, rounds).data_ptr(),
             stream.data_ptr(), out.data_ptr(), B, rounds)
    return stream, out


# -- kernel 14: the compression -----------------------------------------------

blake2f_compress_plain = oblake2.blake2f

# flag types the kernel reads as they are (nonzero: the final block)
_FLAG_TYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
               torch.int64)
_I64 = torch.int64


def _launch_ready(h, m, t, f, rounds) -> bool:
    """Inputs the kernel takes as they are: on the card, contiguous,
    16-byte aligned int64 h, m, t of one leading shape, bool flags of
    that shape, a round count in range."""
    if not (h.is_cuda and h.dtype is _I64 and m.dtype is _I64
            and t.dtype is _I64 and f.dtype is torch.bool
            and type(rounds) is int and 0 <= rounds < 1 << 32):
        return False
    lead = h.shape[:-2]
    return (h.shape[-2:] == (8, 2) and m.shape == lead + (16, 2)
            and t.shape == lead + (2, 2) and f.shape == lead
            and m.device == t.device == f.device == h.device
            and h.is_contiguous() and m.is_contiguous()
            and t.is_contiguous() and f.is_contiguous()
            and not (h.data_ptr() | m.data_ptr() | t.data_ptr()) & 15)


def blake2f_compress(h, m, t, f, rounds: int = oblake2.ROUNDS):
    """EIP-152 compression F batched over leading axes (broadcast): h (...,
    8, 2), m (..., 16, 2), t (..., 2, 2) u64 pairs in any integer type
    (halves below 2^32), f (...,) final-block flags. Returns h' (..., 8, 2)
    int64.

    On the card, inputs the kernel takes as they are go straight to the
    launch (the `bench` command's line 1 gives such); anything else is
    checked, cast, broadcast and copied first."""
    if not _launch_ready(h, m, t, f, rounds):
        tails = (h.shape[-2:], m.shape[-2:], t.shape[-2:])
        if tails != ((8, 2), (16, 2), (2, 2)) \
                or len({x.device for x in (h, m, t, f)}) > 1:
            raise ValueError("blake2f_compress takes h (..., 8, 2), m (..., "
                             "16, 2), t (..., 2, 2) and f (...) on one "
                             "device, got "
                             f"{[tuple(x.shape) for x in (h, m, t, f)]}")
        rounds = _rounds("blake2f_compress", rounds)
        if h.device.type == "cpu":
            return blake2f_compress_plain(h, m, t, f, rounds)
        lead = torch.broadcast_shapes(h.shape[:-2], m.shape[:-2],
                                      t.shape[:-2], f.shape)
        h, m, t = (_ready(x.to(_I64).expand(lead + x.shape[-2:]))
                   for x in (h, m, t))
        if f.dtype not in _FLAG_TYPES:
            f = f.to(torch.bool)
        f = f.expand(lead).contiguous()
    out = torch.empty(h.shape[:-2] + (8, 2), dtype=_I64, device=h.device)
    if out.numel():
        call("blake2f", "zk_blake2f_compress", h.data_ptr(), m.data_ptr(),
             t.data_ptr(), f.data_ptr(), f.element_size(), out.data_ptr(),
             out.numel() // 16, rounds)
    return out
