"""The BLAKE2f circuit: spread-XOR arithmetization and witness generation.

Counterpart of ``zkodst_tpu/circuit/blake2f.py``. One `_schedule`
expresses the whole compression as a sequence of ops and runs over two
backends that cannot drift apart:

* `_Layout` (host, once per circuit shape) allocates rows, records cell
  placements, copy constraints, selector rows and recompose coefficients —
  a line-for-line copy of the reference's, so the fixed columns, copies
  and gates are identical;
* `_Numeric` (PyTorch, batched) computes every witness cell as a flat
  stream. Inside a round the four column G calls are independent, as are
  the four diagonal ones, so each half-round runs `_g_sequence` once on
  words with a trailing lane axis of 4 and the per-lane streams are laid
  out G-major — the reference's push order. Rounds are a plain loop.
  With the scatter into the columns it is the plain version of kernel 13
  (`kernels/blake2.blake2f_advice`), which `Blake2fCircuit.witness`
  launches on the card through the placement table that `_placement`
  makes from the layout: one memset and one launch, where the stream and
  its scatter as eager operations took ~12,780 launches.

Row types and gate algebra are documented in the reference module.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import blake2 as kblake2
from ..ops import u64
from ..ops.blake2 import G_INDICES, IV, SIGMA
from ..utils.device import resolve
from ..utils.timing import upload
from .expr import Const, V
from .ir import BLINDING_ROWS, CircuitDef, CopyGroup, Gate, Lookup
from .spread import spread_int, table_u64

# instance ("pub") column layout, per instance block
ROW_T = 0          # rows 0,1: t0, t1
ROW_F = 2
ROW_H = 3          # rows 3..10: h[0..7]
ROW_M = 11         # rows 11..26: m[0..15]
ROW_OUT = 27       # rows 27..34: h'[0..7]
R_PUB = 35

ADVICE = ["d0", "s0", "d1", "s1", "d8", "s8", "d15", "s15",
          "ca", "cb", "cc", "ce", "cf", "w"]
SELECTORS = ["q_dec", "q_add", "q_xor", "q_rcp", "q_s88", "q_s115", "q_v14"]
KCOLS = ["k1", "k2", "k3", "k4", "k5"]
RCP_CELLS = ["ca", "cb", "cc", "ce", "cf"]

_M16 = 0xFFFF


@dataclass
class WordH:
    """A 64-bit word's circuit representation (any subset may exist).

    Layout backend: cell handles; numeric backend: tensors (word (..., 2)
    pairs, dense/spread lists of four (...) limb tensors)."""

    word: object = None
    dense: object = None
    spread: object = None


@dataclass(frozen=True)
class CellH:
    """Layout cell handle. idx = witness-stream index (None for constants
    in the `cst` fixed column, which carry `value` instead)."""

    col: str
    row: int
    idx: Optional[int] = None
    value: Optional[int] = None


def _limbs16_int(v: int) -> List[int]:
    return [(v >> (16 * i)) & 0xFFFF for i in range(4)]


# ---------------------------------------------------------------------------
# Layout backend (host)
# ---------------------------------------------------------------------------

class _Layout:
    def __init__(self):
        self.r = 0
        self.nidx = 0
        self.place: List[Tuple[str, int, int]] = []       # (col, row, idx)
        self.copies: List[Tuple[Tuple[str, int], Tuple[str, int]]] = []
        self.consts: List[Tuple[str, int, int]] = []      # (col, row, value)
        self.sel: Dict[str, List[int]] = defaultdict(list)
        self.kcoeff: List[Tuple[int, Tuple[int, ...]]] = []
        self.cst_values: List[int] = []
        self._cst_index: Dict[int, int] = {}
        self.n_outputs = 0

    def _push(self, col: str, row: int) -> CellH:
        idx = self.nidx
        self.nidx += 1
        self.place.append((col, row, idx))
        return CellH(col, row, idx)

    def _operand(self, col: str, row: int, cell: CellH) -> None:
        if cell.idx is not None:
            self.place.append((col, row, cell.idx))
        else:
            self.consts.append((col, row, cell.value))
        self.copies.append(((col, row), (cell.col, cell.row)))

    def _cst(self, value: int) -> CellH:
        row = self._cst_index.get(value)
        if row is None:
            row = len(self.cst_values)
            self.cst_values.append(value)
            self._cst_index[value] = row
        return CellH("cst", row, None, value)

    def _pub(self, row: int) -> CellH:
        idx = self.nidx
        self.nidx += 1
        return CellH("pub", row, idx)

    def input_t(self, j):
        return WordH(word=self._pub(ROW_T + j))

    def input_f(self):
        return self._pub(ROW_F)

    def input_h(self, i):
        return WordH(word=self._pub(ROW_H + i))

    def input_m(self, j):
        return WordH(word=self._pub(ROW_M + j))

    def dec(self, wh: WordH) -> WordH:
        r = self.r
        self.r += 2
        self.sel["q_dec"].append(r)
        dense, spread = [], []
        for i in range(4):
            rr = r + i // 2
            dense.append(self._push("d0" if i % 2 == 0 else "d1", rr))
            spread.append(self._push("s0" if i % 2 == 0 else "s1", rr))
        self._operand("w", r, wh.word)
        return WordH(word=wh.word, dense=dense, spread=spread)

    def add(self, u: WordH, v: WordH, x: Optional[WordH]) -> WordH:
        r = self.r
        self.r += 2
        self.sel["q_add"].append(r)
        self._operand("ca", r, u.word)
        self._operand("cb", r, v.word)
        self._operand("cc", r, x.word if x is not None else self._cst(0))
        self._push("ce", r)
        dense, spread = [], []
        for i in range(4):
            rr = r + i // 2
            dense.append(self._push("d0" if i % 2 == 0 else "d1", rr))
            spread.append(self._push("s0" if i % 2 == 0 else "s1", rr))
        wcell = self._push("w", r + 1)
        return WordH(word=wcell, dense=dense, spread=spread)

    def xor(self, u: WordH, v: WordH) -> WordH:
        dense, spread = [], []
        for i in range(4):
            r = self.r
            self.r += 1
            self.sel["q_xor"].append(r)
            self._operand("ca", r, u.spread[i])
            self._operand("cb", r, v.spread[i])
            self._push("d0", r)
            self._push("s0", r)
            dense.append(self._push("d1", r))
            spread.append(self._push("s1", r))
        return WordH(word=None, dense=dense, spread=spread)

    def rcp(self, pieces: Sequence, coeffs: Sequence[int]) -> WordH:
        r = self.r
        self.r += 1
        self.sel["q_rcp"].append(r)
        ks = [0] * 5
        for j, (pc, k) in enumerate(zip(pieces, coeffs)):
            self._operand(RCP_CELLS[j], r, pc)
            ks[j] = k
        self.kcoeff.append((r, tuple(ks)))
        return WordH(word=self._push("w", r))

    def s88(self, wh: WordH, i: int):
        r = self.r
        self.r += 2
        self.sel["q_s88"].append(r)
        self._operand("ca", r, wh.spread[i])
        lo = self._push("d8", r)
        self._push("s8", r)
        hi = self._push("d8", r + 1)
        self._push("s8", r + 1)
        return lo, hi

    def s115(self, wh: WordH, i: int):
        r = self.r
        self.r += 1
        self.sel["q_s115"].append(r)
        self._operand("ca", r, wh.spread[i])
        lo = self._push("d15", r)
        self._push("s15", r)
        bit = self._push("cb", r)
        return lo, bit

    def v14(self, f_cell) -> WordH:
        r = self.r
        self.r += 1
        self.sel["q_v14"].append(r)
        self._operand("ca", r, f_cell)
        spread = [self._push(c, r) for c in ("cb", "cc", "ce", "cf")]
        return WordH(word=None, dense=None, spread=spread)

    def relabel(self, e: WordH, o: int) -> WordH:
        return WordH(word=None,
                     dense=[e.dense[(i + o) % 4] for i in range(4)],
                     spread=[e.spread[(i + o) % 4] for i in range(4)])

    def const_word(self, value: int) -> WordH:
        return WordH(word=self._cst(value),
                     spread=[self._cst(spread_int(l))
                             for l in _limbs16_int(value)])

    def const_spread_word(self, value: int) -> WordH:
        return WordH(spread=[self._cst(spread_int(l))
                             for l in _limbs16_int(value)])

    def expose(self, wh: WordH, i: int) -> None:
        self.copies.append(
            (("pub", ROW_OUT + i), (wh.word.col, wh.word.row)))
        self.n_outputs += 1


# ---------------------------------------------------------------------------
# Numeric backend (PyTorch, int64-held 32-bit values)
# ---------------------------------------------------------------------------

class _Numeric:
    """Cell values over a batch shape `like.shape` — (B,) for the init and
    final phases, (B, 4) inside a half-round (four G calls as lanes). The
    stream is kept as separate low/high lists so a 32-bit push costs no
    stack."""

    def __init__(self, spread_tab: torch.Tensor, like: torch.Tensor):
        self.tab = spread_tab
        self.zero = torch.zeros_like(like)
        self.lo: List[torch.Tensor] = []
        self.hi: List[torch.Tensor] = []
        self.outputs: List[torch.Tensor] = []

    def spread(self, d):
        return self.tab[d]

    def full(self, word) -> WordH:
        l4 = u64.to_limbs16(word)
        dense = [l4[..., i] for i in range(4)]
        return WordH(word=word, dense=dense,
                     spread=[self.spread(d) for d in dense])

    def _push32(self, v):
        self.lo.append(v)
        self.hi.append(self.zero)

    def _push64(self, w):
        self.lo.append(w[..., 0])
        self.hi.append(w[..., 1])

    def stream(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lo, hi), each (*batch, cells)."""
        return torch.stack(self.lo, dim=-1), torch.stack(self.hi, dim=-1)

    # -- inputs (set by _numeric_stream) --
    def input_t(self, j):
        w = self.t[:, j]
        self._push64(w)
        return self.full(w)

    def input_f(self):
        self._push32(self.f)
        return self.f

    def input_h(self, i):
        w = self.h[:, i]
        self._push64(w)
        return self.full(w)

    def input_m(self, j):
        w = self.m[:, j]
        self._push64(w)
        return self.full(w)

    # -- ops --
    def dec(self, wh: WordH) -> WordH:
        full = self.full(wh.word)
        for i in range(4):
            self._push32(full.dense[i])
            self._push32(full.spread[i])
        return full

    def add(self, u: WordH, v: WordH, x: Optional[WordH]) -> WordH:
        dense, carry = [], None
        for i in range(4):
            ti = u.dense[i] + v.dense[i]
            if x is not None:
                ti = ti + x.dense[i]
            if carry is not None:
                ti = ti + carry
            dense.append(ti & _M16)
            carry = ti >> 16
        self._push32(carry)
        spread = [self.spread(d) for d in dense]
        for i in range(4):
            self._push32(dense[i])
            self._push32(spread[i])
        word = u64.from_limbs16(torch.stack(dense, dim=-1))
        self._push64(word)
        return WordH(word=word, dense=dense, spread=spread)

    def xor(self, u: WordH, v: WordH) -> WordH:
        dense, spread = [], []
        for i in range(4):
            odd = u.dense[i] & v.dense[i]
            even = u.dense[i] ^ v.dense[i]
            se = self.spread(even)
            self._push32(odd)
            self._push32(self.spread(odd))
            self._push32(even)
            self._push32(se)
            dense.append(even)
            spread.append(se)
        return WordH(word=None, dense=dense, spread=spread)

    def rcp(self, pieces: Sequence, coeffs: Sequence[int]) -> WordH:
        acc = None
        for p, k in zip(pieces, coeffs):
            assert k & (k - 1) == 0, "rcp coefficients must be powers of 2"
            pw = u64.shl(torch.stack([p, torch.zeros_like(p)], dim=-1),
                         k.bit_length() - 1)
            acc = pw if acc is None else u64.add(acc, pw)
        self._push64(acc)
        return self.full(acc)

    def s88(self, wh: WordH, i: int):
        vv = wh.dense[i]
        lo, hi = vv & 0xFF, vv >> 8
        self._push32(lo)
        self._push32(self.spread(lo))
        self._push32(hi)
        self._push32(self.spread(hi))
        return lo, hi

    def s115(self, wh: WordH, i: int):
        vv = wh.dense[i]
        lo, bit = vv & 0x7FFF, vv >> 15
        self._push32(lo)
        self._push32(self.spread(lo))
        self._push32(bit)
        return lo, bit

    def v14(self, f) -> WordH:
        iv6 = _limbs16_int(IV[6])
        dense = [iv6[i] ^ (f * _M16) for i in range(4)]
        spread = [self.spread(d) for d in dense]
        for i in range(4):
            self._push32(spread[i])
        return WordH(word=None, dense=dense, spread=spread)

    def relabel(self, e: WordH, o: int) -> WordH:
        return WordH(word=None,
                     dense=[e.dense[(i + o) % 4] for i in range(4)],
                     spread=[e.spread[(i + o) % 4] for i in range(4)])

    def const_word(self, value: int) -> WordH:
        w = torch.tensor(u64.from_int(value).astype(np.int64),
                         device=self.zero.device)
        return self.full(w.expand(self.zero.shape + (2,)))

    def const_spread_word(self, value: int) -> WordH:
        return self.const_word(value)

    def expose(self, wh: WordH, i: int) -> None:
        self.outputs.append(wh.word)


# ---------------------------------------------------------------------------
# The schedule — shared by both backends
# ---------------------------------------------------------------------------

_LIN = (1, 1 << 16, 1 << 32, 1 << 48)


def _init_phase(b):
    """Inputs + initial work vector. Returns (v, hd, m)."""
    t0 = b.input_t(0)
    t1 = b.input_t(1)
    f = b.input_f()
    h = [b.input_h(i) for i in range(8)]
    m = [b.input_m(j) for j in range(16)]

    hd = [b.dec(h[i]) for i in range(8)]
    td = [b.dec(t0), b.dec(t1)]

    v: List[WordH] = [None] * 16
    for i in range(8):
        v[i] = hd[i]
    for i in range(4):
        v[8 + i] = b.const_word(IV[i])
    v[12] = b.xor(td[0], b.const_spread_word(IV[4]))
    v[13] = b.xor(td[1], b.const_spread_word(IV[5]))
    v[14] = b.v14(f)
    v[15] = b.const_spread_word(IV[7])
    return v, hd, m


def _g_sequence(b, a, bw, c, d, x, y):
    """One G call: 35 rows / 131 stream cells."""
    a1 = b.add(a, bw, x)
    e1 = b.xor(d, a1)
    d1 = b.relabel(e1, 2)                       # >>> 32
    d1.word = b.rcp(d1.dense, _LIN).word

    c1 = b.add(c, d1, None)
    e2 = b.xor(bw, c1)
    lo8, hi8 = b.s88(e2, 1)                     # >>> 24: split limb 1
    b1w = b.rcp([e2.dense[0], lo8, hi8, e2.dense[2], e2.dense[3]],
                (1 << 40, 1 << 56, 1, 1 << 8, 1 << 24))
    b1 = b.dec(b1w)

    a2 = b.add(a1, b1, y)
    e3 = b.xor(d1, a2)
    d2 = b.relabel(e3, 1)                       # >>> 16
    d2.word = b.rcp(d2.dense, _LIN).word

    c2 = b.add(c1, d2, None)
    e4 = b.xor(b1, c2)
    lo15, bit = b.s115(e4, 3)                   # >>> 63: split top limb
    b2w = b.rcp([e4.dense[0], e4.dense[1], e4.dense[2], lo15, bit],
                (2, 1 << 17, 1 << 33, 1 << 49, 1))
    b2 = b.dec(b2w)
    return a2, b2, c2, d2


def _round(b, v, xys):
    """One round: 8 G calls with pre-selected (x, y) message operands."""
    for gi, (ia, ib, ic, idd) in enumerate(G_INDICES):
        x, y = xys[gi]
        v[ia], v[ib], v[ic], v[idd] = _g_sequence(
            b, v[ia], v[ib], v[ic], v[idd], x, y)


def _final_phase(b, v, hd):
    for i in range(8):
        tmp = b.xor(v[i], v[i + 8])
        out = b.xor(tmp, hd[i])
        hw = b.rcp(out.dense, _LIN)
        b.expose(hw, i)


def _schedule(b, rounds: int = 12) -> None:
    v, hd, m = _init_phase(b)
    for rd in range(rounds):
        s = SIGMA[rd % 10]
        xys = [(m[s[2 * gi]], m[s[2 * gi + 1]]) for gi in range(8)]
        _round(b, v, xys)
    _final_phase(b, v, hd)


def _lanes(ws: torch.Tensor, idx: torch.Tensor) -> WordH:
    """Words idx (4 lanes) of a (B, 16, 4, 2) dense/spread state."""
    sel = ws[:, idx]                                   # (B, 4, 4, 2)
    return WordH(dense=[sel[:, :, j, 0] for j in range(4)],
                 spread=[sel[:, :, j, 1] for j in range(4)])


def _numeric_stream(h, m, t, f, rounds: int, spread_tab):
    """Witness value stream in `_schedule`'s push order.

    h (B,8,2), m (B,16,2), t (B,2,2) int64 pairs; f (B,) int64.
    Returns (lo, hi) each (B, ncells), and the outputs (B, 8, 2)."""
    nb = _Numeric(spread_tab, f)
    nb.h, nb.m, nb.t, nb.f = h, m, t, f
    v, hd, mh = _init_phase(nb)
    parts = [nb.stream()]

    def pack(w: WordH):
        return torch.stack([torch.stack(w.dense, dim=-1),
                            torch.stack(w.spread, dim=-1)], dim=-1)

    state = torch.stack([pack(w) for w in v], dim=1)    # (B, 16, 4, 2)
    mdense = torch.stack([torch.stack(w.dense, dim=-1) for w in mh], dim=1)
    dev = f.device
    for rd in range(rounds):
        s = SIGMA[rd % 10]
        for half in range(2):
            gis = range(4 * half, 4 * half + 4)
            quads = torch.tensor([G_INDICES[gi] for gi in gis],
                                 device=dev).T               # (4 roles, 4)
            xi = torch.tensor([s[2 * gi] for gi in gis], device=dev)
            yi = torch.tensor([s[2 * gi + 1] for gi in gis], device=dev)
            nr = _Numeric(spread_tab, f.unsqueeze(-1).expand(-1, 4))
            a, bw, c, d = (_lanes(state, quads[r]) for r in range(4))
            x = WordH(dense=[mdense[:, xi, j] for j in range(4)])
            y = WordH(dense=[mdense[:, yi, j] for j in range(4)])
            outs = _g_sequence(nr, a, bw, c, d, x, y)
            state = state.clone()
            for r, w in enumerate(outs):
                state[:, quads[r]] = pack(w)
            lo, hi = nr.stream()                      # (B, 4, cells)
            parts.append((lo.flatten(1), hi.flatten(1)))
    v = [WordH(dense=[state[:, i, j, 0] for j in range(4)],
               spread=[state[:, i, j, 1] for j in range(4)])
         for i in range(16)]
    nbf = _Numeric(spread_tab, f)
    _final_phase(nbf, v, hd)
    parts.append(nbf.stream())
    lo = torch.cat([p[0] for p in parts], dim=-1)
    hi = torch.cat([p[1] for p in parts], dim=-1)
    return lo, hi, torch.stack(nbf.outputs, dim=-2)


# ---------------------------------------------------------------------------
# Circuit assembly + witness generation
# ---------------------------------------------------------------------------

def _gates() -> List[Gate]:
    P16, P32, P48, P64 = 1 << 16, 1 << 32, 1 << 48, 1 << 64

    def word_expr(off=0):
        return (V("d0", off) + V("d1", off) * P16
                + V("d0", off + 1) * P32 + V("d1", off + 1) * P48)

    gates = [
        Gate("dec", V("q_dec") * (V("w") - word_expr())),
        Gate("add.sum", V("q_add") * (V("ca") + V("cb") + V("cc")
                                      - V("w", 1) - V("ce") * P64)),
        Gate("add.limbs", V("q_add") * (V("w", 1) - word_expr())),
        Gate("add.carry",
             V("q_add") * V("ce") * (V("ce") - 1) * (V("ce") - 2)),
        Gate("xor", V("q_xor") * (V("ca") + V("cb") - V("s1") - 2 * V("s0"))),
        Gate("rcp", V("q_rcp") * (
            V("w") - (V("k1") * V("ca") + V("k2") * V("cb")
                      + V("k3") * V("cc") + V("k4") * V("ce")
                      + V("k5") * V("cf")))),
        Gate("s88", V("q_s88") * (V("ca") - V("s8") - V("s8", 1) * (4 ** 8))),
        Gate("s115", V("q_s115") * (V("ca") - V("s15") - V("cb") * (4 ** 15))),
        Gate("s115.bit", V("q_s115") * V("cb") * (V("cb") - 1)),
        Gate("v14.bit", V("q_v14") * V("ca") * (V("ca") - 1)),
    ]
    for i, col in enumerate(("cb", "cc", "ce", "cf")):
        c0 = spread_int(_limbs16_int(IV[6])[i])
        c1 = spread_int(_limbs16_int(IV[6])[i] ^ 0xFFFF)
        gates.append(Gate(
            f"v14.s{i}",
            V("q_v14") * (V(col) - Const(c0) - V("ca") * Const(c1 - c0))))
    return gates


class Blake2fCircuit:
    """A built circuit (fixed shape: k, instances, rounds) + witness gen on
    `device` (CUDA unless the caller names another)."""

    def __init__(self, k: int = 17, n_inst: int = 1, rounds: int = 12,
                 device=None):
        self.k, self.n_inst, self.rounds = k, n_inst, rounds
        self.device = resolve(device)
        n = 1 << k
        lay = _Layout()
        _schedule(lay, rounds)
        self.rows_per_inst = lay.r
        self.ncells = lay.nidx
        usable = n - BLINDING_ROWS - 1
        assert lay.r * n_inst <= usable, \
            f"{n_inst} instances × {lay.r} rows > usable {usable}"
        assert (1 << 16) <= n, "spread table needs k >= 17"
        self._lay = lay

        fixed: Dict[str, np.ndarray] = {}
        inst_off = lay.r * np.arange(n_inst)
        for q in SELECTORS:
            col = np.zeros((n, 2), np.uint32)
            rows = (np.asarray(lay.sel[q], np.int64)[None, :]
                    + inst_off[:, None]).ravel()
            col[rows, 0] = 1
            fixed[q] = col
        kvals = {r: ks for r, ks in lay.kcoeff}
        for j, kc in enumerate(KCOLS):
            col = np.zeros((n, 2), np.uint32)
            base_rows = np.asarray(sorted(kvals), np.int64)
            vals = u64.from_ints([kvals[r][j] for r in sorted(kvals)])
            rows = (base_rows[None, :] + inst_off[:, None]).ravel()
            col[rows] = np.tile(vals, (n_inst, 1))
            fixed[kc] = col
        cst = np.zeros((n, 2), np.uint32)
        if lay.cst_values:
            cst[: len(lay.cst_values)] = u64.from_ints(lay.cst_values)
        fixed["cst"] = cst
        fixed["t16d"], fixed["t16s"] = table_u64(16, n)
        fixed["t8d"], fixed["t8s"] = table_u64(8, n)
        fixed["t15d"], fixed["t15s"] = table_u64(15, n)

        def _off(col: str) -> np.ndarray:
            if col == "pub":
                return R_PUB * np.arange(n_inst)
            if col == "cst":
                return np.zeros(n_inst, np.int64)
            return inst_off

        groups: Dict[Tuple[str, str], List[Tuple[int, int]]] = \
            defaultdict(list)
        for (ca_, ra), (cb_, rb) in lay.copies:
            groups[(ca_, cb_)].append((ra, rb))
        copies = []
        for (ca_, cb_), prs in groups.items():
            ra = np.asarray([p[0] for p in prs], np.int64)
            rb = np.asarray([p[1] for p in prs], np.int64)
            copies.append(CopyGroup(
                ca_, (ra[None, :] + _off(ca_)[:, None]).ravel(),
                cb_, (rb[None, :] + _off(cb_)[:, None]).ravel()))

        self.circ = CircuitDef(
            k=k, advice_names=list(ADVICE), instance_names=["pub"],
            fixed=fixed, gates=_gates(),
            lookups=[
                Lookup("l16a", ["d0", "s0"], ["t16d", "t16s"]),
                Lookup("l16b", ["d1", "s1"], ["t16d", "t16s"]),
                Lookup("l8", ["d8", "s8"], ["t8d", "t8s"]),
                Lookup("l15", ["d15", "s15"], ["t15d", "t15s"]),
            ],
            copies=copies,
            instance_len={"pub": R_PUB * n_inst})
        self.circ.validate()

        self.plan = _placement(lay, n, self.device)

    def witness(self, h, m, t, f):
        """Batched witness: h (B,8,2), m (B,16,2), t (B,2,2) u64 pairs and
        f (B,) flags (numpy or tensors), B = n_inst. Returns (advice dict,
        instance dict), each column an (n, 2) int64 tensor of u64 pairs on
        the circuit's device: views of one buffer that kernel 13 writes on
        the card (one host-to-device copy of the inputs, one memset, one
        launch) and its plain version fills on the CPU."""
        B = self.n_inst
        words = [np.asarray(x).astype(np.int64).ravel()
                 for x in (h, m, t, np.asarray(f).astype(bool))]
        assert [w.size for w in words] == [16 * B, 32 * B, 4 * B, B], \
            [w.size for w in words]
        flat = upload(torch.from_numpy(np.concatenate(words)), self.device)
        h, m, t, f = (x.view(shape) for x, shape in zip(
            flat.split([w.size for w in words]),
            ((B, 8, 2), (B, 16, 2), (B, 2, 2), (B,))))
        cols = kblake2.blake2f_advice(h, m, t, f, self.rounds, self.plan)
        return ({col: cols[j] for j, col in enumerate(ADVICE)},
                {"pub": cols[-1]})


def _placement(lay: _Layout, n: int, dev) -> kblake2.Placement:
    """Where each cell of one instance's stream goes, from the layout: the
    plain version's scatter by column and the kernel's table by stream
    index (``cuda/csrc/blake2f.cuh``, ``place_cell``)."""
    cols = {col: j for j, col in enumerate(ADVICE)}
    assert len(ADVICE) * n < 1 << 31, "placements are int32 col·n + row"
    targets = [(col, row) for col, row, _ in lay.place] \
        + [(col, row) for col, row, _ in lay.consts]
    assert len(set(targets)) == len(targets), "a cell placed twice"
    by_col: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    per_idx: List[List[int]] = [[] for _ in range(lay.nidx)]
    for col, row, idx in lay.place:
        by_col[col].append((row, idx))
        per_idx[idx].append(cols[col] * n + row)
    slots = np.full((lay.nidx, 4), -1, np.int32)
    more: List[int] = []
    for idx, dsts in enumerate(per_idx):
        if len(dsts) <= 4:
            slots[idx, :len(dsts)] = dsts
        else:
            slots[idx, :3] = dsts[:3]
            slots[idx, 3] = -2 - len(more)
            more += dsts[3:] + [-1]
    cby: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for col, row, val in lay.consts:
        cby[col].append((row, val))

    def tensor(x, dtype=torch.int64):
        return upload(torch.as_tensor(np.asarray(x), dtype=dtype), dev)

    return kblake2.Placement(
        columns=tuple(ADVICE), n=n, rows=lay.r, pub_rows=R_PUB,
        cells=lay.nidx,
        scatter={col: (tensor([p[0] for p in ps]), tensor([p[1] for p in ps]))
                 for col, ps in by_col.items()},
        const_scatter={col: (tensor([p[0] for p in ps]),
                             tensor(u64.from_ints([p[1] for p in ps])
                                    .astype(np.int64)))
                       for col, ps in cby.items()},
        slots=tensor(slots, torch.int32),
        more=tensor(more + [-1], torch.int32),
        const_dst=tensor([cols[col] * n + row for col, row, _ in lay.consts],
                         torch.int32),
        const_val=tensor(u64.from_ints([v for _, _, v in lay.consts])
                         .astype(np.int64).reshape(-1, 2)))
