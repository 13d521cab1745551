"""Polynomial-constraint expressions (a frozen copy of the circuit's
expression tree) and their value at one point in Python ints."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .field import R


class Expr:
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


def _wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Const(x)
    raise TypeError(f"cannot use {type(x)} in an expression")


@dataclass(frozen=True)
class Var(Expr):
    col: str
    rot: int = 0


V = Var


@dataclass(frozen=True)
class Const(Expr):
    value: int


@dataclass(frozen=True)
class Add(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Mul(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True)
class Neg(Expr):
    a: Expr


def variables(e: Expr) -> set:
    if isinstance(e, Var):
        return {(e.col, e.rot)}
    if isinstance(e, Const):
        return set()
    if isinstance(e, Neg):
        return variables(e.a)
    return variables(e.a) | variables(e.b)


def evaluate(e: Expr, get: Callable[[str, int], int]) -> int:
    """The expression's value mod r, columns read through get(col, rot)."""
    if isinstance(e, Var):
        return get(e.col, e.rot) % R
    if isinstance(e, Const):
        return e.value % R
    if isinstance(e, Add):
        return (evaluate(e.a, get) + evaluate(e.b, get)) % R
    if isinstance(e, Mul):
        return evaluate(e.a, get) * evaluate(e.b, get) % R
    if isinstance(e, Neg):
        return (-evaluate(e.a, get)) % R
    raise TypeError(type(e))
