"""A frozen model of the work of a Pippenger multi-scalar multiplication
over BN254 G1, counted from the scalars a call receives.

Work, for a batch of B scalar vectors over N points:

* window width c = c_of(N), a function of N alone (halo2's
  ``best_multiexp``: 1 below 4 points, 3 below 32, else ⌈ln N⌉), and
  ⌈256 / c⌉ windows of each scalar;
* one complete addition per nonzero c-bit window of each scalar (the
  bucket accumulation: a zero digit adds nothing);
* per window that holds a nonzero digit, 2·(2^c − 1) additions to reduce
  the buckets (running sum and total), c doublings and one addition to
  combine it with the others; a doubling counts as an addition (an empty
  window needs neither).

An addition is the complete formula for a = 0 short Weierstrass curves
(Renes–Costello–Batina, Alg. 7): 12 field multiplications. A field
multiplication of 8 × 32-bit limbs (Montgomery, CIOS) is 2·8·8 limb
products for a·b and 2·8·8 for the reduction, each a 32 × 32 → 64-bit
product worth two 32-bit multiply results (low and high words), plus 8
single-word products for the reduction factors: 264 results.

Bytes: every byte of the points and scalars as the call receives them
read once, and each result point (3 × 8 × 4 bytes) written once.

The model reads the algorithm's work and not the program's launches, so a
redesign of the kernels that leaves the MSMs as they are leaves it
unchanged, and small scalars (most of a KZG advice column's) are not
counted as full width.
"""

from __future__ import annotations

import math

MUL_RESULTS_PER_FIELD_MUL = 2 * 8 * 8 * 2 + 8          # 264
FIELD_MULS_PER_ADD = 12
MUL_RESULTS_PER_ADD = FIELD_MULS_PER_ADD * MUL_RESULTS_PER_FIELD_MUL
SCALAR_BITS = 256
POINT_BYTES_OUT = 3 * 8 * 4


def c_of(n_points: int) -> int:
    if n_points < 4:
        return 1
    if n_points < 32:
        return 3
    return math.ceil(math.log(n_points))


def windows(c: int) -> int:
    return -(-SCALAR_BITS // c)


def nonzero_digits(scalars, c: int):
    """(nonzero c-bit windows, windows with a nonzero digit) over B scalar
    vectors of (B, N, 8) normal-form 32-bit limbs (a torch tensor; counted
    on its device)."""
    import torch

    limbs = scalars.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.nn.functional.pad(limbs, (0, 1))
    digits = torch.zeros((), dtype=torch.int64, device=scalars.device)
    active = torch.zeros((), dtype=torch.int64, device=scalars.device)
    for w in range(windows(c)):
        bit = w * c
        lo, off = bit // 32, bit % 32
        d = limbs[..., lo] >> off
        if off + c > 32:
            d = d | (limbs[..., lo + 1] << (32 - off))
        per_vector = torch.count_nonzero(d & ((1 << c) - 1), dim=-1)
        digits += per_vector.sum()
        active += torch.count_nonzero(per_vector)
    return int(digits), int(active)


def work(n_points: int, nonzero: int, active: int, bytes_in: int,
         batch: int):
    """(32-bit multiply results, bytes) of one call of `batch` MSMs over
    `n_points` points whose scalars have `nonzero` nonzero windows and
    `active` windows that hold one, reading `bytes_in` bytes of points and
    scalars."""
    c = c_of(n_points)
    adds = nonzero + active * (2 * ((1 << c) - 1) + c + 1)
    return adds * MUL_RESULTS_PER_ADD, bytes_in + batch * POINT_BYTES_OUT
