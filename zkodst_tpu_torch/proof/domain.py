"""Evaluation domain: the 2^k roots of unity, the transforms between
coefficient and evaluation form, the extended coset of the quotient and
the Lagrange selector tables on it.

Counterpart of ``zkodst_tpu/proof/domain.py``: the multiplicative
generator, the permutation coset generator δ, ``ntt``/``intt`` of
``(..., n, 8)`` Fr columns (:32-116), the extended coset ζ·H′ of 4n points
(``coeff_to_extended``, ``extended_to_coeff``, :40-80, :118-143), each
transform on one device or sharded over a mesh (:81-141), the
host-side evaluations of Z_H and the Lagrange basis at a point (:145-163)
and ``selectors_extended`` (:181-226), which the port computes on the
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import torch

from ..circuit.ir import BLINDING_ROWS
from ..ops import ntt as nttmod
from ..ops.field import FR
from ..ops.pyfield import FR as PFR
from ..parallel.ntt_sharded import intt_sharded_nat, ntt_sharded_nat
from ..utils.device import resolve

# a generator of Fr^* (halo2curves Fr::MULTIPLICATIVE_GENERATOR = 7)
GEN = 7
assert pow(GEN, (PFR.p - 1) // 2, PFR.p) != 1, "GEN must be a non-square"

# generator of the odd-order quotient group: the permutation columns'
# disjoint cosets are δ^col·H
DELTA = pow(GEN, 1 << PFR.two_adicity, PFR.p)

EXT_FACTOR = 4   # extended domain = 4n (max constraint degree 5)


@dataclass(frozen=True)
class Domain:
    k: int

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def usable(self) -> int:
        return self.n - BLINDING_ROWS - 1

    @cached_property
    def omega(self) -> int:
        return PFR.root_of_unity(self.k)

    # -- extended coset domain ζ·H′, |H′| = 4n ----------------------------------
    @property
    def ext_k(self) -> int:
        return self.k + EXT_FACTOR.bit_length() - 1

    @property
    def ext_n(self) -> int:
        return self.n * EXT_FACTOR

    @cached_property
    def ext_omega(self) -> int:
        return PFR.root_of_unity(self.ext_k)

    @property
    def zeta(self) -> int:
        return GEN

    # -- device transforms (columns are (..., n, 8) Montgomery limbs) -----------
    # `mesh`: every rank holds the columns whole and the transform runs as
    # the 4-step NTT with one all-to-all over `mesh_axis`
    # (parallel/ntt_sharded.py), its result replicated, as the
    # reference's mesh path (:98-141).
    def ntt(self, coeffs, mesh=None, mesh_axis="x"):
        """(..., n, 8) coefficients -> evaluations on H (kernels 6–7)."""
        if mesh is not None:
            return ntt_sharded_nat(FR, coeffs, self.omega, mesh, mesh_axis)
        return nttmod.ntt(FR, coeffs, self.omega)

    def intt(self, evals, mesh=None, mesh_axis="x"):
        """(..., n, 8) evaluations on H -> coefficients."""
        if mesh is not None:
            return intt_sharded_nat(FR, evals, self.omega, mesh, mesh_axis)
        return nttmod.intt(FR, evals, self.omega)

    def coeff_to_extended(self, coeffs, mesh=None, mesh_axis="x"):
        """(..., n, 8) coefficients -> evaluations on ζ·H′ (..., 4n, 8):
        zero-padded to 4n, scaled by ζ^i, one NTT of 4n points."""
        pad = torch.zeros(coeffs.shape[:-2] + (self.ext_n - coeffs.shape[-2],
                                               8),
                          dtype=torch.int32, device=coeffs.device)
        wide = torch.cat([coeffs, pad], dim=-2)
        if mesh is not None:
            return ntt_sharded_nat(FR, nttmod.coset_scale(FR, wide, self.zeta),
                                   self.ext_omega, mesh, mesh_axis)
        return nttmod.coset_ntt(FR, wide, self.ext_omega, self.zeta)

    def extended_to_coeff(self, evals, mesh=None, mesh_axis="x"):
        """Evaluations on ζ·H′ -> coefficient form (length 4n)."""
        if mesh is not None:
            return nttmod.coset_scale(
                FR, intt_sharded_nat(FR, evals, self.ext_omega, mesh,
                                     mesh_axis), self.zeta, inverse=True)
        return nttmod.coset_intt(FR, evals, self.ext_omega, self.zeta)

    # -- host-side scalar helpers ------------------------------------------------
    def vanishing_eval(self, x: int) -> int:
        """Z_H(x) = x^n − 1."""
        return (pow(x, self.n, PFR.p) - 1) % PFR.p

    def lagrange_eval(self, i: int, x: int) -> int:
        """L_i(x) = ω^i·(x^n − 1) / (n·(x − ω^i)) for x ∉ H."""
        p = PFR.p
        wi = pow(self.omega, i, p)
        num = wi * self.vanishing_eval(x) % p
        den = self.n * (x - wi) % p
        return num * pow(den, -1, p) % p

    def l0_llast_lblind_eval(self, x: int):
        l0 = self.lagrange_eval(0, x)
        llast = self.lagrange_eval(self.usable, x)
        lblind = sum(self.lagrange_eval(i, x)
                     for i in range(self.usable + 1, self.n)) % PFR.p
        return l0, llast, lblind

    # -- extended-coset selector tables (on the device, once per keygen) -------
    def selectors_extended(self, device=None) -> dict:
        """{l0, llast, lblind, zh_inv} on ζ·H′, (4n, 8) Montgomery limbs.

        L_i(x) = ω^i·Z_H(x)·(n·(x − ω^i))⁻¹ at x_j = ζ·ω′^j: the points
        are one power table times ζ, Z_H(x_j) = ζ^n·(ω′^n)^j − 1 takes 4
        values (ω′^n has order 4), and every (x_j − ω^i) of the 2 +
        BLINDING_ROWS rows is inverted in one ``inv_batch``. lblind sums
        the rows u+1 … n−1. zh_inv = 1/Z_H, nonzero on the coset."""
        dev = resolve(device)
        p = PFR.p
        zn = pow(self.zeta, self.n, p)
        wn = pow(self.ext_omega, self.n, p)
        zh = [(zn * pow(wn, j, p) - 1) % p for j in range(EXT_FACTOR)]
        zh_full = FR.from_ints(zh, dev).repeat(self.n, 1)
        zh_inv = FR.from_ints([pow(v, -1, p) for v in zh],
                              dev).repeat(self.n, 1)
        xs = FR.mul(nttmod.powers_table(FR, self.ext_omega, self.ext_n, dev),
                    FR.from_ints(self.zeta, dev))
        rows = [0, self.usable] + list(range(self.usable + 1, self.n))
        wis = [pow(self.omega, i, p) for i in rows]
        dens = torch.stack([FR.sub(xs, FR.from_ints(wi, dev)) for wi in wis])
        inv = FR.inv_batch(dens.reshape(-1, 8)).reshape(dens.shape)
        ninv = pow(self.n, -1, p)
        scale = FR.from_ints([wi * ninv % p for wi in wis], dev)
        lag = FR.mul(FR.mul(inv, zh_full), scale[:, None, :])
        lblind = lag[2]
        for row in lag[3:]:
            lblind = FR.add(lblind, row)
        return {"l0": lag[0], "llast": lag[1], "lblind": lblind,
                "zh_inv": zh_inv}
