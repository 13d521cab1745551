"""Polynomial-constraint expression AST.

Counterpart of ``zkodst_tpu/circuit/expr.py``. The classes, their field
names and their dataclass ``repr`` are identical to the reference's, because
the proving key's fingerprint (``zkodst_tpu/proof/keygen.py``
``_circuit_fingerprint``) hashes ``repr(gate.poly)``. :func:`eval_expr`
evaluates a tree over whole columns (the mock checker's gates); the
prover's quotient walks the constraints through :mod:`..proof.constraints`
instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


class Expr:
    """Base class; supports +, -, *, unary -, and int mixing."""

    def __add__(self, o):
        return Add(self, _wrap(o))

    def __radd__(self, o):
        return Add(_wrap(o), self)

    def __sub__(self, o):
        return Add(self, Neg(_wrap(o)))

    def __rsub__(self, o):
        return Add(_wrap(o), Neg(self))

    def __mul__(self, o):
        return Mul(self, _wrap(o))

    def __rmul__(self, o):
        return Mul(_wrap(o), self)

    def __neg__(self):
        return Neg(self)

    def degree(self) -> int:
        raise NotImplementedError

    def vars(self) -> set:
        raise NotImplementedError


def _wrap(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Const(x)
    raise TypeError(f"cannot use {type(x)} in an expression")


@dataclass(frozen=True)
class Var(Expr):
    """A column reference at a relative row rotation."""

    col: str
    rot: int = 0

    def degree(self):
        return 1

    def vars(self):
        return {(self.col, self.rot)}


def V(col: str, rot: int = 0) -> Var:
    return Var(col, rot)


@dataclass(frozen=True)
class Const(Expr):
    value: int

    def degree(self):
        return 0

    def vars(self):
        return set()


@dataclass(frozen=True)
class Add(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def vars(self):
        return self.a.vars() | self.b.vars()


@dataclass(frozen=True)
class Mul(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return self.a.degree() + self.b.degree()

    def vars(self):
        return self.a.vars() | self.b.vars()


@dataclass(frozen=True)
class Neg(Expr):
    a: Expr

    def degree(self):
        return self.a.degree()

    def vars(self):
        return self.a.vars()


def eval_expr(e: Expr, F, getcol: Callable[[str, int], torch.Tensor],
              device, cache: Optional[dict] = None) -> torch.Tensor:
    """Evaluate `e` over whole columns.

    F: ops.field.Field; getcol: (col, rot) -> (..., n, 8) Montgomery limb
    tensor on `device`; cache: a dict for shared-subtree memoization, keyed
    by the frozen node, so structurally equal subtrees share work (pass
    the same dict for several trees). A constant is one (8,) element that
    the field operations read broadcast; Neg is 0 − a. On the card every
    node is one launch of kernel 1, 2 or 3. Returns (..., n, 8)."""
    if cache is None:
        cache = {}

    def rec(node):
        hit = cache.get(node)
        if hit is not None:
            return hit
        if isinstance(node, Var):
            out = getcol(node.col, node.rot)
        elif isinstance(node, Const):
            out = F.from_ints(node.value, device)
        elif isinstance(node, Add):
            out = F.add(rec(node.a), rec(node.b))
        elif isinstance(node, Mul):
            out = F.mul(rec(node.a), rec(node.b))
        elif isinstance(node, Neg):
            out = F.neg(rec(node.a))
        else:
            raise TypeError(f"unknown expr node {type(node)}")
        cache[node] = out
        return out

    return rec(e)
