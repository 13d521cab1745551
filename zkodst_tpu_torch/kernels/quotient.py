"""Kernel 15: the quotient's numerator in one launch (CUDA source
``cuda/csrc/quotient.cu``), beside its plain PyTorch twin.

It replaces no Pallas kernel: it is the counterpart of XLA's fusion of
the JAX package's ``_quotient_fn`` (``zkodst_tpu/proof/prover.py``),
which ``jax.jit`` compiles once per proving key. Here the constraint
system is compiled once per key into a :class:`Tape`, a straight-line
program over BN254 Fr (``prover.compile_quotient``), and kernel 15 runs
that program at every row of the extended coset, one thread a row, with
every intermediate on the chip. Its result is h on the coset: the
y-folded numerator times 1/Z_H.

A tape has four kinds of operand, each an int32 ``kind << 12 | index``:

=========  ==========================================================
``SLOT``   a value of the slot file (a step's result)
``INPUT``  column ``inputs[index][0]`` at row (i + ``inputs[index][1]``)
           mod rows: a rotation by r rows of H reads the coset r·4 rows
           on, in place (no rolled copy)
``CONST``  ``consts[index]``: the circuit's constants and the δ^g of
           the permutation's identity columns, fixed per key
``CHAL``   challenge ``index`` of θ, β, γ, y (:data:`CHALLENGES`), given
           anew at each call
=========  ==========================================================

and each step is ``(op, dst, a, b)``: slot ``dst`` takes a·b (Montgomery),
a + b or a − b. After the last step slot ``out`` holds the result. The
plain twin runs the same steps over whole columns with the plain twins of
kernels 1–3 and ``torch.roll``: the eager walk the kernel replaced, on
whichever device its columns lie. Every value is canonical, so the two
agree limb for limb.
"""

from __future__ import annotations

import ctypes
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.field import FR, Field, ints_to_limbs
from ..utils.timing import upload
from .build import call
from .mulmod import _check, addmod_plain, mulmod_plain, submod_plain

SLOT, INPUT, CONST, CHAL = range(4)
KIND_SHIFT = 12
MUL, ADD, SUB = range(3)
CHALLENGES = ("theta", "beta", "gamma", "y")

# the kernel's limits (quotient.cu: kSlots, kMaxCols); an index of a
# kind fits in KIND_SHIFT bits
MAX_SLOTS = 16
MAX_COLS = 192
MAX_INDEX = 1 << KIND_SHIFT


def operand(kind: int, index: int) -> int:
    return kind << KIND_SHIFT | index


@dataclass(eq=False)
class Tape:
    """The straight-line program of one proving key (module docstring)."""

    rows: int                                 # the coset's rows, 4n
    columns: Tuple[str, ...]                  # the columns it reads
    inputs: Tuple[Tuple[int, int], ...]       # (column, row shift)
    consts: Tuple[int, ...]                   # canonical ints
    steps: np.ndarray                         # (S, 4) int32
    slots: int
    out: int
    _program: Dict[str, Tuple[torch.Tensor, ...]] = field(
        default_factory=dict, repr=False)

    def counts(self) -> Dict[str, int]:
        """The sizes a span of its evaluation records."""
        return {"steps": len(self.steps), "inputs": len(self.inputs),
                "rows": self.rows}

    def program(self, device) -> Tuple[torch.Tensor, ...]:
        """(steps, inputs, consts) as int32 tensors on `device`, uploaded
        at the first call there: the consts in Montgomery form."""
        key = str(device)
        if key not in self._program:
            self._program[key] = tuple(
                upload(torch.from_numpy(np.ascontiguousarray(a).view(
                    np.int32)), device)
                for a in (self.steps, np.asarray(self.inputs, np.int32),
                          _mont_limbs(FR, self.consts)))
        return self._program[key]


def assemble(steps: Sequence[Tuple[int, Tuple[int, int], Tuple[int, int]]],
             deferred: int, rows: int, columns: Sequence[str],
             inputs: Sequence[Tuple[int, int]],
             consts: Sequence[int]) -> Tape:
    """A :class:`Tape` from recorded `steps` ``(op, a, b)`` with operands
    ``(kind, index)``, where ``(SLOT, j)`` is the result of recorded step
    j; the last step gives the result.

    Steps that the result does not need are dropped. The steps from
    `deferred` on (the y-fold, a chain) each run as soon as their
    operands are ready, the others in their recorded order, so that each
    term is folded in as it is made and few values are live at once.
    Slots go to values by liveness, a freed slot first. Raises if the
    program needs more than :data:`MAX_SLOTS` slots, more than
    :data:`MAX_COLS` columns, or an index past :data:`MAX_INDEX`."""
    def made(j):
        return [i for kind, i in steps[j][1:] if kind == SLOT]

    last = len(steps) - 1
    live = [False] * len(steps)
    live[last] = True
    for j in range(last, -1, -1):
        if live[j]:
            for i in made(j):
                live[i] = True
    order, done = [], set()
    chain = [j for j in range(deferred, len(steps)) if live[j]]
    c = 0
    for j in [j for j in range(deferred) if live[j]] + [None]:
        while c < len(chain) and done.issuperset(made(chain[c])):
            order.append(chain[c])
            done.add(chain[c])
            c += 1
        if j is not None:
            order.append(j)
            done.add(j)
    if c < len(chain) or order[-1] != last:
        raise ValueError("quotient tape: the fold chain reads a value that "
                         "no step makes")

    last_use = {i: at for at, j in enumerate(order) for i in made(j)}
    slot_of: Dict[int, int] = {}
    free: List[int] = []
    used = 0
    code = np.zeros((len(order), 4), np.int32)
    for at, j in enumerate(order):
        op, a, b = steps[j]
        ab = [operand(SLOT, slot_of[i]) if kind == SLOT else operand(kind, i)
              for kind, i in (a, b)]
        for i in set(made(j)):
            if last_use[i] == at:
                heapq.heappush(free, slot_of.pop(i))
        if free:
            dst = heapq.heappop(free)
        else:
            dst, used = used, used + 1
        slot_of[j] = dst
        code[at] = (op, dst, *ab)
    if used > MAX_SLOTS or len(columns) > MAX_COLS or \
            max(len(inputs), len(consts)) > MAX_INDEX:
        raise ValueError(
            f"quotient tape needs {used} slots, {len(columns)} columns, "
            f"{len(inputs)} inputs and {len(consts)} constants: kernel 15 "
            f"holds {MAX_SLOTS} slots, {MAX_COLS} columns and "
            f"{MAX_INDEX} of each table")
    return Tape(rows, tuple(columns), tuple(inputs), tuple(consts), code,
                used, slot_of[last])


def _mont_limbs(F: Field, xs: Sequence[int]) -> np.ndarray:
    """Ints -> (len, 8) uint32 Montgomery limbs."""
    return ints_to_limbs([x % F.p * F.r % F.p for x in xs])


def _check_call(F: Field, tape: Tape, cols: Sequence[torch.Tensor],
                chal: Sequence[int]) -> None:
    if F is not FR:
        raise ValueError(f"quotient is built for BN254's Fr alone, not "
                         f"{F.name}")
    if len(cols) != len(tape.columns) or len(chal) != len(CHALLENGES):
        raise ValueError(f"quotient takes {len(tape.columns)} columns and "
                         f"{len(CHALLENGES)} challenges, got {len(cols)} "
                         f"and {len(chal)}")
    _check("quotient", *cols)
    for c in cols:
        if c.shape != (tape.rows, 8):
            raise ValueError(f"quotient: columns of ({tape.rows}, 8), got "
                             f"{tuple(c.shape)}")


def quotient_plain(F: Field, tape: Tape, cols: Sequence[torch.Tensor],
                   chal: Sequence[int]) -> torch.Tensor:
    _check_call(F, tape, cols, chal)
    dev = cols[0].device
    _, _, consts = tape.program(dev)
    # the kernel takes the challenges in its launch's parameters: no upload
    chals = torch.from_numpy(_mont_limbs(F, chal).view(np.int32)).to(dev)
    rolled: Dict[int, torch.Tensor] = {}
    slots: List = [None] * tape.slots

    def value(v: int) -> torch.Tensor:
        kind, i = v >> KIND_SHIFT, v & (MAX_INDEX - 1)
        if kind == SLOT:
            return slots[i]
        if kind == CONST:
            return consts[i]
        if kind == CHAL:
            return chals[i]
        if i not in rolled:
            c, shift = tape.inputs[i]
            rolled[i] = torch.roll(cols[c], -shift, 0) if shift else cols[c]
        return rolled[i]

    ops = (mulmod_plain, addmod_plain, submod_plain)
    for op, dst, a, b in tape.steps.tolist():
        slots[dst] = ops[op](F, value(a), value(b))
    return slots[tape.out]


def quotient(F: Field, tape: Tape, cols: Sequence[torch.Tensor],
             chal: Sequence[int]) -> torch.Tensor:
    """The tape at every row: `cols` the (rows, 8) int32 Montgomery
    columns of ``tape.columns``, `chal` the ints θ, β, γ, y. One launch
    of kernel 15 on the card; the plain twin on the CPU."""
    if cols and cols[0].device.type == "cpu":
        return quotient_plain(F, tape, cols, chal)
    _check_call(F, tape, cols, chal)
    for c in cols:
        if not c.is_contiguous() or c.data_ptr() % 16:
            raise ValueError("quotient: columns must be contiguous and "
                             "16-byte aligned")
    dev = cols[0].device
    steps, inputs, consts = tape.program(dev)
    out = torch.empty((tape.rows, 8), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    chal_arr = (ctypes.c_uint32 * (8 * len(chal)))(
        *_mont_limbs(F, chal).ravel().tolist())
    call("quotient", "zk_quotient", steps.data_ptr(), len(tape.steps),
         inputs.data_ptr(), consts.data_ptr(), ptrs, len(cols), chal_arr,
         out.data_ptr(), tape.rows, tape.slots, tape.out)
    return out
