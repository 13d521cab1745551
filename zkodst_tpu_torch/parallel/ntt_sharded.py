"""Sharded NTT: the 4-step (Bailey) decomposition with one all-to-all.

Counterpart of ``zkodst_tpu/parallel/ntt_sharded.py`` (:1-245). The
domain of n = n1·n2 points is a matrix, so that every butterfly stage is
local to a rank and the one exchange between ranks is an all-to-all
transpose. With j = j1·n2 + j2 and k = k1 + n1·k2:

  X[k1 + n1·k2] = NTT_{n2, j2→k2}( w^{j2·k1} · NTT_{n1, j1→k1}(A[j1, j2]) )

with A = a.reshape(n1, n2), inner root w^{n2} and outer root w^{n1}. A
rank takes its block of n2/D columns j2, runs the inner transform over
j1 and the twiddle product, exchanges blocks so that it holds n1/D rows k1
of every column, and runs the outer transform over j2: its rows of
C[k1, k2]. The transforms are the port's ``ops.ntt.ntt`` (kernel 6, its
twiddles and the inverse's 1/n by kernel 1); the transposes around the
exchange are explicit contiguous copies.

The reference's consumers see every result replicated, so each function
ends with an all-gather: :func:`ntt_sharded` and :func:`intt_sharded`
give and take the C[k1, k2] layout flattened row-major (the natural order
is :func:`to_natural` of it); :func:`ntt_sharded_nat` and
:func:`intt_sharded_nat`, the ``create_proof(mesh=...)`` entry points,
take and give natural order, batched over leading dimensions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops import ntt as nttmod
from ..ops.field import Field
from .bootstrap import AxisName, Mesh

# (field, n1, n2, w, device) -> the (n2, n1, 8) table w^(j2·k1), j2-major
_TWIDDLES: dict = {}


def _twiddles(F: Field, n1: int, n2: int, w: int, device) -> torch.Tensor:
    """w^(j2·k1) as an (n2, n1, 8) Montgomery table on `device` (row j2,
    column k1), made once per (field, n1, n2, w, device): a gather of the
    n-entry power table of w (w^n = 1, so the exponent is j2·k1 mod n)."""
    key = (F.name, n1, n2, w, str(device))
    if key not in _TWIDDLES:
        n = n1 * n2
        pw = nttmod.pow_table(F, w, n, device)
        j2 = torch.arange(n2, device=device)[:, None]
        k1 = torch.arange(n1, device=device)[None, :]
        _TWIDDLES[key] = pw[(j2 * k1) % n]
    return _TWIDDLES[key]


def _default_n1(n: int) -> int:
    return 1 << ((n.bit_length() - 1) // 2)


def _factor(n: int, ndev: int, n1: Optional[int] = None) -> Tuple[int, int]:
    """(n1, n2) with n1·n2 = n and D dividing both: n1 from 2^⌊log n / 2⌋
    up (or the caller's). Raises where D divides no such split: a domain
    is never padded."""
    if n1 is None:
        n1 = _default_n1(n)
        while n1 <= n and (n1 % ndev or (n // n1) % ndev):
            n1 <<= 1
    if n1 > n or n % n1 or n1 % ndev or (n // n1) % ndev:
        raise ValueError(f"no 4-step split of n = {n} over {ndev} shards "
                         "(D must divide n1 and n2)")
    return n1, n // n1


def _forward(F: Field, a: torch.Tensor, w: int, mesh: Mesh, axis: AxisName,
             n1: int, n2: int) -> torch.Tensor:
    """(B, n1, n2, 8) natural coefficients, replicated -> this rank's rows
    of C[k1, k2]: (B, n1/D, n2, 8)."""
    D = mesh.size(axis)
    B, m1, m2 = a.shape[0], n1 // D, n2 // D
    # this rank's columns j2, j1 on the transform axis: (B, n2/D, n1, 8)
    x = mesh.shard(a, axis, dim=2).transpose(1, 2).contiguous()
    x = nttmod.ntt(F, x, pow(w, n2, F.p))                       # over j1
    x = F.mul(x, mesh.shard(_twiddles(F, n1, n2, w, a.device), axis))
    # rows k1 in D blocks, block d to rank d: (D, B, n1/D, n2/D, 8)
    send = x.reshape(B, m2, D, m1, 8).permute(2, 0, 3, 1, 4).contiguous()
    got = mesh.all_to_all(send, axis)              # block s: rank s's j2
    y = got.permute(1, 2, 0, 3, 4).reshape(B, m1, n2, 8)
    return nttmod.ntt(F, y, pow(w, n1, F.p))                     # over j2


def _inverse(F: Field, c: torch.Tensor, w: int, mesh: Mesh, axis: AxisName,
             n1: int, n2: int) -> torch.Tensor:
    """This rank's rows of C[k1, k2], (B, n1/D, n2, 8) -> its columns j2
    of the natural coefficients, j1 on axis −2: (B, n2/D, n1, 8). The
    forward pipeline run backwards with inverse roots, then 1/n."""
    D = mesh.size(axis)
    B, m1, m2 = c.shape[0], n1 // D, n2 // D
    winv = pow(w, -1, F.p)
    y = nttmod.ntt(F, c, pow(winv, n1, F.p))                     # over k2
    # columns j2 in D blocks, block d to rank d: (D, B, n2/D, n1/D, 8)
    send = y.reshape(B, m1, D, m2, 8).permute(2, 0, 3, 1, 4).contiguous()
    got = mesh.all_to_all(send, axis)              # block s: rank s's k1
    x = got.permute(1, 2, 0, 3, 4).reshape(B, m2, n1, 8)
    x = F.mul(x, mesh.shard(_twiddles(F, n1, n2, winv, c.device), axis))
    x = nttmod.ntt(F, x, pow(winv, n2, F.p))                     # over k1
    return F.mul(x, F.from_ints(pow(n1 * n2, -1, F.p), c.device))


def _batch(a: torch.Tensor) -> Tuple[int, int]:
    n = a.shape[-2]
    return math.prod(a.shape[:-2]), n


def ntt_sharded(F: Field, a: torch.Tensor, w: int, mesh: Mesh,
                axis: AxisName = "x", n1: Optional[int] = None
                ) -> torch.Tensor:
    """Forward NTT of a replicated (n, 8) column over `axis`. Returns the
    evaluations as C[k1, k2] flattened row-major (replicated):
    ``to_natural(out, n1)`` is the natural order."""
    n = a.shape[0]
    n1, n2 = _factor(n, mesh.size(axis), n1 or _default_n1(n))
    rows = _forward(F, a.reshape(1, n1, n2, 8), w, mesh, axis, n1, n2)
    return mesh.all_gather(rows, axis).reshape(n, 8)


def intt_sharded(F: Field, c: torch.Tensor, w: int, mesh: Mesh,
                 axis: AxisName = "x", n1: Optional[int] = None
                 ) -> torch.Tensor:
    """Inverse of :func:`ntt_sharded`: C[k1, k2] flattened row-major ->
    the natural coefficients (n, 8), replicated."""
    n = c.shape[0]
    n1, n2 = _factor(n, mesh.size(axis), n1 or _default_n1(n))
    rows = mesh.shard(c.reshape(1, n1, n2, 8), axis, dim=1)
    cols = _inverse(F, rows, w, mesh, axis, n1, n2)         # (1, n2/D, n1)
    got = mesh.all_gather(cols, axis)                   # (D, 1, n2/D, n1)
    return got.permute(1, 3, 0, 2, 4).reshape(n, 8)


def to_natural(out: torch.Tensor, n1: int) -> torch.Tensor:
    """:func:`ntt_sharded`'s C[k1, k2] layout -> natural order."""
    n = out.shape[0]
    return out.reshape(n1, n // n1, 8).transpose(0, 1).reshape(n, 8)


def ntt_sharded_nat(F: Field, a: torch.Tensor, w: int, mesh: Mesh,
                    axis: AxisName = "x", n1: Optional[int] = None
                    ) -> torch.Tensor:
    """Batched 4-step NTT, natural order in and out: a (..., n, 8)
    replicated coefficient stacks -> their evaluations, replicated."""
    B, n = _batch(a)
    n1, n2 = _factor(n, mesh.size(axis), n1)
    rows = _forward(F, a.reshape(B, n1, n2, 8), w, mesh, axis, n1, n2)
    got = mesh.all_gather(rows, axis)               # (D, B, n1/D, n2, 8)
    # natural k = k1 + n1·k2: row k2, column k1
    return got.permute(1, 3, 0, 2, 4).reshape(a.shape)


def intt_sharded_nat(F: Field, x: torch.Tensor, w: int, mesh: Mesh,
                     axis: AxisName = "x", n1: Optional[int] = None
                     ) -> torch.Tensor:
    """Inverse of :func:`ntt_sharded_nat` (natural order in and out)."""
    B, n = _batch(x)
    n1, n2 = _factor(n, mesh.size(axis), n1)
    # natural k = k1 + n1·k2 is X[k2, k1]: this rank's k1, k2 on axis −2
    rows = mesh.shard(x.reshape(B, n2, n1, 8), axis, dim=2) \
        .transpose(1, 2).contiguous()
    cols = _inverse(F, rows, w, mesh, axis, n1, n2)         # (B, n2/D, n1)
    got = mesh.all_gather(cols, axis)                   # (D, B, n2/D, n1)
    # natural j = j1·n2 + j2: row j1, column j2
    return got.permute(1, 3, 0, 2, 4).reshape(x.shape)
