"""SHPLONK multiopen (BDFG20): KZG batch opening at arbitrary point sets.

Counterpart of ``zkodst_tpu/proof/shplonk.py``. One pair of G1 witness
points opens every (polynomial, points, evaluations) claim of the proof.

Protocol (claims (f_i, S_i, r_i), T = ∪S_i, r_i = the interpolant of the
claimed evaluations over S_i):

  y ← FS                     h(X)  = Σ y^i (f_i(X) − r_i(X)) / Z_{S_i}(X)
  W  = [h]₁ → transcript
  z ← FS                     L(X)  = Σ y^i Z_{T∖S_i}(z)(f_i(X) − r_i(z))
                                     − Z_T(z)·h(X)          (L(z) = 0)
                             h′(X) = L(X)/(X − z)
  W′ = [h′]₁ → transcript
  check:  e(L_com + z·W′, G2) == e(W′, [τ]G2)

Both divisions run in evaluation form over H, as the reference's: each
pass is a few broadcast field operations over the (claims, n) stack
(kernels 1–3) and one batched inversion (kernels 4, 5, 1), then one iNTT
and one MSM per witness point. Host work is O(claims · |S_i|²) scalars.
The verifier's MSM over the ~claims commitments and its pairing run in the
host C++ core (:mod:`..native`), as the reference's do, or in Python ints
(:func:`g1_msm`, :mod:`.pairing`) when asked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from .. import native as core
from ..ops import ntt as nttmod
from ..ops import pycurve
from ..ops.field import FR as DFR
from ..ops.pyfield import FR
from ..utils.timing import span, upload
from . import pairing, srs
from .domain import Domain


@dataclass
class Claim:
    """One opening claim. evals_dev is the prover's (n, 8) evaluation form
    on H; commitment is the verifier's affine point."""

    points: Tuple[int, ...]
    evals: Tuple[int, ...]
    evals_dev: object = None
    commitment: object = None


def _interp(points: Sequence[int], evals: Sequence[int]) -> List[int]:
    """Lagrange interpolation -> coefficient list (host, tiny sets)."""
    p = FR.p
    m = len(points)
    coeffs = [0] * m
    for j in range(m):
        # basis poly ∏_{k≠j} (X − x_k) / (x_j − x_k)
        num = [1]
        den = 1
        for kk in range(m):
            if kk == j:
                continue
            num = _polymul(num, [(-points[kk]) % p, 1])
            den = den * (points[j] - points[kk]) % p
        scale = evals[j] * pow(den, -1, p) % p
        for t in range(len(num)):
            coeffs[t] = (coeffs[t] + scale * num[t]) % p
    return coeffs


def _polymul(a: List[int], b: List[int]) -> List[int]:
    p = FR.p
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, yv in enumerate(b):
            out[i + j] = (out[i + j] + x * yv) % p
    return out


def _poly_eval(coeffs: List[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR.p
    return acc


def _h_pass(evs, rcoef, plimbs, pmask, ypows, roots):
    """h(X) in evaluation form: Σ y^i (f_i − r_i)/Z_{S_i}.

    evs (C, n, 8) claim evaluation forms; rcoef (C, S, 8) interpolant
    coefficients (zero-padded); plimbs (C, S, 8) and pmask (C, S) the
    padded point sets; ypows (C, 8) the weights y^i."""
    C, n, _ = evs.shape
    S = rcoef.shape[1]
    acc = torch.zeros_like(evs)
    for j in range(S - 1, -1, -1):                 # Horner; pad coeffs = 0
        acc = DFR.mul(acc, roots[None])
        acc = DFR.add(acc, rcoef[:, j, None, :])
    num = DFR.sub(evs, acc)
    one = DFR.const(DFR.ONE, evs.device)
    zs = None
    for j in range(S):
        diff = DFR.sub(roots[None], plimbs[:, j, None, :])
        diff = torch.where(pmask[:, j, None, None], diff, one)
        zs = diff if zs is None else DFR.mul(zs, diff)
    zinv = DFR.inv_batch(zs.reshape(C * n, 8)).reshape(C, n, 8)
    term = DFR.mul(DFR.mul(num, zinv), ypows[:, None, :])
    return DFR.sum(term)


def _l_pass(evs, cks, constk, ztzk, h_ev, roots, zk):
    """h′(X) in evaluation form: (Σ c_i f_i − const − Z_T(z)·h) / (X − z)."""
    l_ev = DFR.sum(DFR.mul(cks[:, None, :], evs))
    l_ev = DFR.sub(l_ev, constk)
    l_ev = DFR.sub(l_ev, DFR.mul(ztzk, h_ev))
    return DFR.mul(l_ev, DFR.inv_batch(DFR.sub(roots, zk)))


def point_mask(claims: List[Claim], S: int, device) -> torch.Tensor:
    """(C, S) bool: point j of claim i exists (the padded point sets'
    mask), uploaded (:func:`timing.upload`)."""
    return upload(torch.tensor([[j < len(cl.points) for j in range(S)]
                                for cl in claims]), device)


def _weights(claims: List[Claim], ypows: List[int], z: int):
    """Z_T(z), and per claim c_i = y^i·Z_{T∖S_i}(z) and Σ c_i·r_i(z)."""
    p = FR.p
    t_all = sorted({pt for cl in claims for pt in cl.points})
    zt_z = 1
    for s in t_all:
        zt_z = zt_z * (z - s) % p
    cs, const = [], 0
    for cl, yp in zip(claims, ypows):
        zts = 1
        for s in t_all:
            if s not in cl.points:
                zts = zts * (z - s) % p
        c = yp * zts % p
        cs.append(c)
        const = (const + c * _poly_eval(_interp(cl.points, cl.evals), z)) % p
    return zt_z, cs, const


def open_claims(params: srs.ParamsKZG, dom: Domain, claims: List[Claim],
                tw) -> None:
    """Prover: writes W and W′ to the transcript (spans ``h_pass`` and
    ``l_pass``: each up to its polynomial's coefficients)."""
    p = FR.p
    with span("h_pass"):
        dev = claims[0].evals_dev.device
        roots = nttmod.pow_table(DFR, dom.omega, dom.n, dev)      # ω^j
        S = max(len(cl.points) for cl in claims)

        y = tw.squeeze_challenge()
        ypows = [1] * len(claims)
        for i in range(1, len(claims)):
            ypows[i] = ypows[i - 1] * y % p

        evs = torch.stack([cl.evals_dev for cl in claims])
        rs = [_interp(cl.points, cl.evals) for cl in claims]
        rcoef = DFR.from_ints(
            [[r[j] if j < len(r) else 0 for j in range(S)] for r in rs], dev)
        plimbs = DFR.from_ints(
            [[cl.points[j] if j < len(cl.points) else 0 for j in range(S)]
             for cl in claims], dev)
        pmask = point_mask(claims, S, dev)
        h_ev = _h_pass(evs, rcoef, plimbs, pmask, DFR.from_ints(ypows, dev),
                       roots)
        h_coeffs = dom.intt(h_ev)
    tw.write_point(srs.commit_coeff(params, h_coeffs))

    z = tw.squeeze_challenge()
    with span("l_pass"):
        zt_z, cs, const = _weights(claims, ypows, z)
        hp_ev = _l_pass(evs, DFR.from_ints(cs, dev),
                        DFR.from_ints(const, dev), DFR.from_ints(zt_z, dev),
                        h_ev, roots, DFR.from_ints(z, dev))
        hp_coeffs = dom.intt(hp_ev)
    tw.write_point(srs.commit_coeff(params, hp_coeffs))


def g1_msm(points: Sequence[object], scalars: Sequence[int]):
    """Σ k_i·P_i on the host by double-and-add (affine int tuples, None =
    the identity)."""
    acc = None
    for pt, k in zip(points, scalars):
        acc = pycurve.G1.add(acc, pycurve.G1.mul(pt, k))
    return acc


def verify_claims(params: srs.ParamsKZG, dom: Domain, claims: List[Claim],
                  tr, native: bool = True) -> bool:
    """Verifier: reads W and W′ and runs the pairing check, the MSM and
    the pairing in the host C++ core (:mod:`..native`), or in Python ints
    with native=False."""
    p = FR.p
    y = tr.squeeze_challenge()
    w_pt = tr.read_point()
    z = tr.squeeze_challenge()
    wp_pt = tr.read_point()
    ypows = [1] * len(claims)
    for i in range(1, len(claims)):
        ypows[i] = ypows[i - 1] * y % p
    zt_z, cs, const = _weights(claims, ypows, z)
    if native:
        msm, pairing_check = core.g1_msm, core.pairing_check
    else:
        msm, pairing_check = g1_msm, pairing.pairing_check
    # L_com = Σ c_i·C_i − [const]·G − Z_T(z)·W, plus z·W′
    lhs = msm([cl.commitment for cl in claims]
              + [pycurve.G1_GEN, w_pt, wp_pt],
              cs + [(-const) % p, (-zt_z) % p, z])
    # e(L_com + z·W′, G2) == e(W′, [τ]G2)
    return pairing_check(
        [(lhs, params.g2), (pycurve.G1.neg(wp_pt), params.s_g2)])
