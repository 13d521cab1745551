"""Evaluation domain: the 2^k roots of unity and the transforms between
coefficient and evaluation form.

The part of ``zkodst_tpu/proof/domain.py`` that keygen and the prover up
to the grand products need (:32-38, :98-116): the multiplicative
generator, the permutation coset generator δ, and ``ntt``/``intt`` of
``(..., n, 8)`` Fr columns. The extended coset (``coeff_to_extended``,
``extended_to_coeff``) and the Lagrange selector tables
(``selectors_extended``) come with the quotient.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

from ..circuit.ir import BLINDING_ROWS
from ..ops import ntt as nttmod
from ..ops.field import FR
from ..ops.pyfield import FR as PFR

# a generator of Fr^* (halo2curves Fr::MULTIPLICATIVE_GENERATOR = 7)
GEN = 7
assert pow(GEN, (PFR.p - 1) // 2, PFR.p) != 1, "GEN must be a non-square"

# generator of the odd-order quotient group: the permutation columns'
# disjoint cosets are δ^col·H
DELTA = pow(GEN, 1 << PFR.two_adicity, PFR.p)


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

    def ntt(self, coeffs):
        """(..., n, 8) coefficients -> evaluations on H (kernels 6–7)."""
        return nttmod.ntt(FR, coeffs, self.omega)

    def intt(self, evals):
        """(..., n, 8) evaluations on H -> coefficients."""
        return nttmod.intt(FR, evals, self.omega)
