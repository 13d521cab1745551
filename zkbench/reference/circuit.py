"""The EIP-152 BLAKE2f circuit as a verifier sees it: its columns, gates,
lookups, fixed columns and copy constraints, and the public instance
column of a batch of compressions.

A frozen copy of the spread-XOR arithmetization of the circuit's layout
backend (row allocation, cell placement, copies, selector rows, recompose
coefficients) and its gate list, on numpy and Python ints. Nothing of the
witness is computed here: a verifier needs the circuit and the public
values only.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from .blake2f import G_INDICES, IV, SIGMA, compress
from .expr import Const, Expr, V, variables

# the public column, per instance block of R_PUB rows
ROW_T, ROW_F, ROW_H, ROW_M, ROW_OUT, R_PUB = 0, 2, 3, 11, 27, 35

ADVICE = ["d0", "s0", "d1", "s1", "d8", "s8", "d15", "s15",
          "ca", "cb", "cc", "ce", "cf", "w"]
SELECTORS = ["q_dec", "q_add", "q_xor", "q_rcp", "q_s88", "q_s115", "q_v14"]
KCOLS = ["k1", "k2", "k3", "k4", "k5"]
RCP_CELLS = ["ca", "cb", "cc", "ce", "cf"]
LOOKUPS = [("l16a", ("d0", "s0"), ("t16d", "t16s")),
           ("l16b", ("d1", "s1"), ("t16d", "t16s")),
           ("l8", ("d8", "s8"), ("t8d", "t8s")),
           ("l15", ("d15", "s15"), ("t15d", "t15s"))]
BLINDING_ROWS = 8
PERM_CHUNK = 2          # permutation columns per grand-product chunk
EXT_FACTOR = 4          # the quotient's pieces h0 … h3

_IV = [int(x) for x in IV]


def spread_int(v: int) -> int:
    out, i = 0, 0
    while v:
        out |= (v & 1) << (2 * i)
        v >>= 1
        i += 1
    return out


def _limbs16(v: int) -> List[int]:
    return [(v >> (16 * i)) & 0xFFFF for i in range(4)]


@dataclass
class _Word:
    word: object = None
    dense: object = None
    spread: object = None


@dataclass(frozen=True)
class _Cell:
    col: str
    row: int
    value: Optional[int] = None       # constants in the `cst` column


class _Layout:
    def __init__(self):
        self.r = 0
        self.copies: List[Tuple[Tuple[str, int], Tuple[str, int]]] = []
        self.sel: Dict[str, List[int]] = defaultdict(list)
        self.kcoeff: List[Tuple[int, Tuple[int, ...]]] = []
        self.cst_values: List[int] = []
        self._cst_index: Dict[int, int] = {}

    def _operand(self, col, row, cell):
        self.copies.append(((col, row), (cell.col, cell.row)))

    def _cst(self, value):
        row = self._cst_index.get(value)
        if row is None:
            row = len(self.cst_values)
            self.cst_values.append(value)
            self._cst_index[value] = row
        return _Cell("cst", row, value)

    def input_t(self, j):
        return _Word(word=_Cell("pub", ROW_T + j))

    def input_f(self):
        return _Cell("pub", ROW_F)

    def input_h(self, i):
        return _Word(word=_Cell("pub", ROW_H + i))

    def input_m(self, j):
        return _Word(word=_Cell("pub", ROW_M + j))

    def _limbs(self, r):
        dense, spread = [], []
        for i in range(4):
            rr = r + i // 2
            dense.append(_Cell("d0" if i % 2 == 0 else "d1", rr))
            spread.append(_Cell("s0" if i % 2 == 0 else "s1", rr))
        return dense, spread

    def dec(self, wh):
        r = self.r
        self.r += 2
        self.sel["q_dec"].append(r)
        dense, spread = self._limbs(r)
        self._operand("w", r, wh.word)
        return _Word(word=wh.word, dense=dense, spread=spread)

    def add(self, u, v, x):
        r = self.r
        self.r += 2
        self.sel["q_add"].append(r)
        self._operand("ca", r, u.word)
        self._operand("cb", r, v.word)
        self._operand("cc", r, x.word if x is not None else self._cst(0))
        dense, spread = self._limbs(r)
        return _Word(word=_Cell("w", r + 1), dense=dense, spread=spread)

    def xor(self, u, v):
        dense, spread = [], []
        for i in range(4):
            r = self.r
            self.r += 1
            self.sel["q_xor"].append(r)
            self._operand("ca", r, u.spread[i])
            self._operand("cb", r, v.spread[i])
            dense.append(_Cell("d1", r))
            spread.append(_Cell("s1", r))
        return _Word(dense=dense, spread=spread)

    def rcp(self, pieces, coeffs):
        r = self.r
        self.r += 1
        self.sel["q_rcp"].append(r)
        ks = [0] * 5
        for j, (pc, k) in enumerate(zip(pieces, coeffs)):
            self._operand(RCP_CELLS[j], r, pc)
            ks[j] = k
        self.kcoeff.append((r, tuple(ks)))
        return _Word(word=_Cell("w", r))

    def s88(self, wh, i):
        r = self.r
        self.r += 2
        self.sel["q_s88"].append(r)
        self._operand("ca", r, wh.spread[i])
        return _Cell("d8", r), _Cell("d8", r + 1)

    def s115(self, wh, i):
        r = self.r
        self.r += 1
        self.sel["q_s115"].append(r)
        self._operand("ca", r, wh.spread[i])
        return _Cell("d15", r), _Cell("cb", r)

    def v14(self, f_cell):
        r = self.r
        self.r += 1
        self.sel["q_v14"].append(r)
        self._operand("ca", r, f_cell)
        return _Word(spread=[_Cell(c, r) for c in ("cb", "cc", "ce",
                                                         "cf")])

    def relabel(self, e, o):
        return _Word(dense=[e.dense[(i + o) % 4] for i in range(4)],
                     spread=[e.spread[(i + o) % 4] for i in range(4)])

    def const_word(self, value):
        return _Word(word=self._cst(value),
                     spread=[self._cst(spread_int(x)) for x in _limbs16(value)])

    def const_spread_word(self, value):
        return _Word(spread=[self._cst(spread_int(x))
                             for x in _limbs16(value)])

    def expose(self, wh, i):
        self.copies.append((("pub", ROW_OUT + i), (wh.word.col, wh.word.row)))


_LIN = (1, 1 << 16, 1 << 32, 1 << 48)


def _g(b, a, bw, c, d, x, y):
    a1 = b.add(a, bw, x)
    d1 = b.relabel(b.xor(d, a1), 2)                       # >>> 32
    d1.word = b.rcp(d1.dense, _LIN).word
    c1 = b.add(c, d1, None)
    e2 = b.xor(bw, c1)
    lo8, hi8 = b.s88(e2, 1)                               # >>> 24
    b1 = b.dec(b.rcp([e2.dense[0], lo8, hi8, e2.dense[2], e2.dense[3]],
                     (1 << 40, 1 << 56, 1, 1 << 8, 1 << 24)))
    a2 = b.add(a1, b1, y)
    d2 = b.relabel(b.xor(d1, a2), 1)                      # >>> 16
    d2.word = b.rcp(d2.dense, _LIN).word
    c2 = b.add(c1, d2, None)
    e4 = b.xor(b1, c2)
    lo15, bit = b.s115(e4, 3)                             # >>> 63
    b2 = b.dec(b.rcp([e4.dense[0], e4.dense[1], e4.dense[2], lo15, bit],
                     (2, 1 << 17, 1 << 33, 1 << 49, 1)))
    return a2, b2, c2, d2


def _schedule(b, rounds: int) -> None:
    t0, t1 = b.input_t(0), b.input_t(1)
    f = b.input_f()
    h = [b.input_h(i) for i in range(8)]
    m = [b.input_m(j) for j in range(16)]
    hd = [b.dec(h[i]) for i in range(8)]
    td = [b.dec(t0), b.dec(t1)]
    v = hd[:] + [b.const_word(_IV[i]) for i in range(4)] + [None] * 4
    v[12] = b.xor(td[0], b.const_spread_word(_IV[4]))
    v[13] = b.xor(td[1], b.const_spread_word(_IV[5]))
    v[14] = b.v14(f)
    v[15] = b.const_spread_word(_IV[7])
    for rd in range(rounds):
        s = SIGMA[rd % 10]
        for gi, (ia, ib, ic, idd) in enumerate(G_INDICES):
            v[ia], v[ib], v[ic], v[idd] = _g(
                b, v[ia], v[ib], v[ic], v[idd], m[s[2 * gi]],
                m[s[2 * gi + 1]])
    for i in range(8):
        out = b.xor(b.xor(v[i], v[i + 8]), hd[i])
        b.expose(b.rcp(out.dense, _LIN), i)


def gates() -> List[Tuple[str, Expr]]:
    P16, P32, P48, P64 = 1 << 16, 1 << 32, 1 << 48, 1 << 64

    def word(off=0):
        return (V("d0", off) + V("d1", off) * P16
                + V("d0", off + 1) * P32 + V("d1", off + 1) * P48)

    out = [
        ("dec", V("q_dec") * (V("w") - word())),
        ("add.sum", V("q_add") * (V("ca") + V("cb") + V("cc")
                                  - V("w", 1) - V("ce") * P64)),
        ("add.limbs", V("q_add") * (V("w", 1) - word())),
        ("add.carry", V("q_add") * V("ce") * (V("ce") - 1) * (V("ce") - 2)),
        ("xor", V("q_xor") * (V("ca") + V("cb") - V("s1") - 2 * V("s0"))),
        ("rcp", V("q_rcp") * (
            V("w") - (V("k1") * V("ca") + V("k2") * V("cb")
                      + V("k3") * V("cc") + V("k4") * V("ce")
                      + V("k5") * V("cf")))),
        ("s88", V("q_s88") * (V("ca") - V("s8") - V("s8", 1) * (4 ** 8))),
        ("s115", V("q_s115") * (V("ca") - V("s15") - V("cb") * (4 ** 15))),
        ("s115.bit", V("q_s115") * V("cb") * (V("cb") - 1)),
        ("v14.bit", V("q_v14") * V("ca") * (V("ca") - 1)),
    ]
    for i, col in enumerate(("cb", "cc", "ce", "cf")):
        c0 = spread_int(_limbs16(_IV[6])[i])
        c1 = spread_int(_limbs16(_IV[6])[i] ^ 0xFFFF)
        out.append((f"v14.s{i}", V("q_v14") * (
            V(col) - Const(c0) - V("ca") * Const(c1 - c0))))
    return out


def _spread16(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0xFFFF)
    out = np.zeros_like(x)
    for i in range(16):
        out |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(2 * i)
    return out


def _table(bits: int, n: int):
    size = 1 << bits
    d = np.arange(size, dtype=np.uint64)
    s = _spread16(d)
    pad = n - size
    return (np.concatenate([d, np.full(pad, d[-1], np.uint64)]),
            np.concatenate([s, np.full(pad, s[-1], np.uint64)]))


@dataclass
class Circuit:
    """The circuit at (k, instances, rounds): fixed columns as uint64
    arrays of n values, copies as ((col, row), (col, row)) pairs."""

    k: int
    n_inst: int
    rounds: int
    fixed: Dict[str, np.ndarray]
    copies: List[Tuple[Tuple[str, int], Tuple[str, int]]]
    gates: List[Tuple[str, Expr]] = field(default_factory=gates)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def usable(self) -> int:
        return self.n - BLINDING_ROWS - 1

    @property
    def perm_cols(self) -> List[str]:
        return ADVICE + ["pub", "cst"]

    @property
    def perm_chunks(self) -> List[List[str]]:
        pc = self.perm_cols
        return [pc[i: i + PERM_CHUNK] for i in range(0, len(pc), PERM_CHUNK)]

    def query_schedule(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """[(polynomial, rotations)] in the order the proof carries their
        evaluations."""
        rots: Dict[str, set] = {}
        for _, g in self.gates:
            for col, r in variables(g):
                rots.setdefault(col, set()).add(r)
        out = [(nm, tuple(sorted(rots.get(nm, set()) | {0})))
               for nm in ADVICE]
        out += [(nm, tuple(sorted(rots.get(nm, set()) | {0})))
                for nm in sorted(self.fixed)]
        out += [(f"perm.sigma{i}", (0,)) for i in range(len(self.perm_cols))]
        for name, _, _ in LOOKUPS:
            out += [(f"{name}.a_perm", (-1, 0)), (f"{name}.s_perm", (0,)),
                    (f"{name}.z", (0, 1))]
        nz = len(self.perm_chunks)
        for j in range(nz):
            out.append((f"perm.z{j}",
                        (0, 1) if j == nz - 1 else (0, 1, self.usable)))
        out += [(f"h{i}", (0,)) for i in range(EXT_FACTOR)]
        return out

    def sigma(self) -> Tuple[np.ndarray, np.ndarray]:
        """The copy permutation: (perm columns, n) column and row of each
        position's successor in its cycle (cycles in sorted order)."""
        n = self.n
        cidx = {c: i for i, c in enumerate(self.perm_cols)}
        parent: Dict[int, int] = {}

        def find(a):
            root = a
            while parent.get(root, root) != root:
                root = parent[root]
            while parent.get(a, a) != a:
                parent[a], a = root, parent[a]
            return root

        members = {}
        for (ca, ra), (cb, rb) in self.copies:
            a, b = cidx[ca] * n + ra, cidx[cb] * n + rb
            members[a] = members[b] = True
            ra_, rb_ = find(a), find(b)
            if ra_ != rb_:
                parent[ra_] = rb_
        cycles: Dict[int, List[int]] = {}
        for pos in members:
            cycles.setdefault(find(pos), []).append(pos)
        ncol = len(self.perm_cols)
        colmap = np.repeat(np.arange(ncol, dtype=np.int64)[:, None], n, 1)
        rowmap = np.repeat(np.arange(n, dtype=np.int64)[None, :], ncol, 0)
        for cyc in cycles.values():
            cyc.sort()
            for i, pos in enumerate(cyc):
                nxt = cyc[(i + 1) % len(cyc)]
                colmap[pos // n, pos % n] = nxt // n
                rowmap[pos // n, pos % n] = nxt % n
        return colmap, rowmap


@lru_cache(maxsize=4)
def build(k: int, n_inst: int, rounds: int) -> Circuit:
    n = 1 << k
    lay = _Layout()
    _schedule(lay, rounds)
    if lay.r * n_inst > n - BLINDING_ROWS - 1 or n < 1 << 16:
        raise ValueError(f"{n_inst} instances of {lay.r} rows do not fit "
                         f"k = {k}")
    off = lay.r * np.arange(n_inst)
    fixed: Dict[str, np.ndarray] = {}
    for q in SELECTORS:
        col = np.zeros(n, np.uint64)
        col[(np.asarray(lay.sel[q])[None, :] + off[:, None]).ravel()] = 1
        fixed[q] = col
    kv = dict(lay.kcoeff)
    rows = np.asarray(sorted(kv), np.int64)
    for j, kc in enumerate(KCOLS):
        col = np.zeros(n, np.uint64)
        vals = np.asarray([kv[r][j] for r in sorted(kv)], np.uint64)
        col[(rows[None, :] + off[:, None]).ravel()] = np.tile(vals, n_inst)
        fixed[kc] = col
    cst = np.zeros(n, np.uint64)
    cst[: len(lay.cst_values)] = np.asarray(lay.cst_values, np.uint64)
    fixed["cst"] = cst
    for bits in (16, 8, 15):
        fixed[f"t{bits}d"], fixed[f"t{bits}s"] = _table(bits, n)

    def shift(col: str, b: int) -> int:
        if col == "pub":
            return R_PUB * b
        if col == "cst":
            return 0
        return lay.r * b

    copies = [((ca, ra + shift(ca, b)), (cb, rb + shift(cb, b)))
              for b in range(n_inst) for (ca, ra), (cb, rb) in lay.copies]
    return Circuit(k, n_inst, rounds, fixed, copies)


def instance_column(n: int, h, m, t, f, rounds: int) -> np.ndarray:
    """The public column (n,) uint64 of a batch: per instance t0, t1, f,
    h[0..7], m[0..15] and the compression's output h'[0..7]."""
    h, m, t = (np.asarray(x, np.uint64) for x in (h, m, t))
    f = np.asarray(f, bool)
    out = compress(h, m, t, f, rounds)
    block = np.concatenate([t, f[:, None].astype(np.uint64), h, m, out], 1)
    col = np.zeros(n, np.uint64)
    col[: block.size] = block.ravel()
    return col
