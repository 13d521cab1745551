"""The whole constraint system (gates, lookup and permutation arguments),
enumerated once and evaluated through a backend context.

A copy of ``zkodst_tpu/proof/constraints.py`` over the port's
``circuit/expr`` classes. It is the one definition of the quotient's
numerator: the prover evaluates it over extended-coset tensors, the
verifier at the challenge x with Python ints. The same enumeration order
on both sides makes the y-combination agree by construction.

Arguments follow halo2 0.3 (``plonk::{lookup,permutation}::verifier``):

Lookup (per registered lookup; A, S = θ-compressed input/table columns):
  1. l_0·(1 − Z)
  2. l_last·(Z² − Z)
  3. active·(Z(ωX)(A′+β)(S′+γ) − Z(X)(A+β)(S+γ))
  4. active·(A′ − S′)(A′ − A′(ω⁻¹X))
  5. l_0·(A′ − S′)
Permutation (columns in vk.perm_cols order, chunks of PERM_CHUNK):
  1. l_0·(1 − Z_0)
  2. l_last·(Z_last² − Z_last)
  3. l_0·(Z_j − Z_{j−1}(ω^u X))  for j ≥ 1
  4. active·(Z_j(ωX)·∏(a+βσ+γ) − Z_j(X)·∏(a+β·δ^c·X+γ))  per chunk
with active = 1 − l_last − l_blind.
"""

from __future__ import annotations

from typing import List

from ..circuit.expr import Add, Const, Expr, Mul, Neg, Var
from ..circuit.ir import CircuitDef


def eval_expr_ctx(e: Expr, ctx):
    if isinstance(e, Var):
        return ctx.get(e.col, e.rot)
    if isinstance(e, Const):
        return ctx.const(e.value)
    if isinstance(e, Add):
        return ctx.add(eval_expr_ctx(e.a, ctx), eval_expr_ctx(e.b, ctx))
    if isinstance(e, Mul):
        return ctx.mul(eval_expr_ctx(e.a, ctx), eval_expr_ctx(e.b, ctx))
    if isinstance(e, Neg):
        return ctx.sub(ctx.const(0), eval_expr_ctx(e.a, ctx))
    raise TypeError(type(e))


def _compress(ctx, cols, theta_first=True):
    """θ-compression: c_0 + θ·c_1 + θ²·c_2 ... (rot 0 plain columns)."""
    acc = None
    tpow = ctx.const(1)
    for c in cols:
        term = ctx.mul(tpow, ctx.get(c, 0))
        acc = term if acc is None else ctx.add(acc, term)
        tpow = ctx.mul(tpow, ctx.theta)
    return acc


def enumerate_constraints(vk, ctx) -> List:
    """Yield every numerator term in canonical order."""
    circ: CircuitDef = vk.circ
    u = circ.usable_rows
    one = ctx.const(1)
    terms = []

    # --- gates ---------------------------------------------------------
    for g in circ.gates:
        terms.append(eval_expr_ctx(g.poly, ctx))

    # --- lookups ---------------------------------------------------------
    for lk in circ.lookups:
        a = _compress(ctx, lk.input_cols)
        s = _compress(ctx, lk.table_cols)
        ap = ctx.get(f"{lk.name}.a_perm", 0)
        ap_prev = ctx.get(f"{lk.name}.a_perm", -1)
        sp = ctx.get(f"{lk.name}.s_perm", 0)
        z = ctx.get(f"{lk.name}.z", 0)
        zw = ctx.get(f"{lk.name}.z", 1)
        terms.append(ctx.mul(ctx.l0, ctx.sub(one, z)))
        terms.append(ctx.mul(ctx.llast, ctx.sub(ctx.mul(z, z), z)))
        lhs = ctx.mul(zw, ctx.mul(ctx.add(ap, ctx.beta),
                                  ctx.add(sp, ctx.gamma)))
        rhs = ctx.mul(z, ctx.mul(ctx.add(a, ctx.beta),
                                 ctx.add(s, ctx.gamma)))
        terms.append(ctx.mul(ctx.active, ctx.sub(lhs, rhs)))
        terms.append(ctx.mul(ctx.active,
                             ctx.mul(ctx.sub(ap, sp), ctx.sub(ap, ap_prev))))
        terms.append(ctx.mul(ctx.l0, ctx.sub(ap, sp)))

    # --- permutation -------------------------------------------------------
    chunks = vk.perm_chunks
    nz = len(chunks)
    z0 = ctx.get("perm.z0", 0)
    terms.append(ctx.mul(ctx.l0, ctx.sub(one, z0)))
    zlast = ctx.get(f"perm.z{nz - 1}", 0)
    terms.append(ctx.mul(ctx.llast, ctx.sub(ctx.mul(zlast, zlast), zlast)))
    for j in range(1, nz):
        terms.append(ctx.mul(ctx.l0, ctx.sub(
            ctx.get(f"perm.z{j}", 0), ctx.get(f"perm.z{j - 1}", u))))
    col_of = {c: i for i, c in enumerate(vk.perm_cols)}
    for j, chunk in enumerate(chunks):
        zj = ctx.get(f"perm.z{j}", 0)
        zjw = ctx.get(f"perm.z{j}", 1)
        lhs, rhs = zjw, zj
        for c in chunk:
            gi = col_of[c]
            aval = ctx.get(c, 0)
            lhs = ctx.mul(lhs, ctx.add(
                aval, ctx.add(ctx.mul(ctx.beta,
                                      ctx.get(f"perm.sigma{gi}", 0)),
                              ctx.gamma)))
            rhs = ctx.mul(rhs, ctx.add(
                aval, ctx.add(ctx.mul(ctx.beta, ctx.identity(gi)),
                              ctx.gamma)))
        terms.append(ctx.mul(ctx.active, ctx.sub(lhs, rhs)))

    return terms


def fold_y(ctx, terms):
    """Σ y^i · term_i (Horner, matching order on both sides)."""
    acc = None
    for t in terms:
        acc = t if acc is None else ctx.add(ctx.mul(acc, ctx.y), t)
    return acc if acc is not None else ctx.const(0)
