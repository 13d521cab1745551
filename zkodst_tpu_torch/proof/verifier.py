"""verify_proof: transcript replay, the quotient identity at x and the
multiopen check.

Counterpart of ``zkodst_tpu/proof/verifier.py`` (:31-167). It replays the
Blake2b transcript (v1 or halo2ce), evaluates the same constraint
enumeration as the prover at the challenge x with Python ints
(:mod:`.constraints`), checks numerator(x) == h(x)·(x^n − 1), and hands
the batched opening to the params' scheme (:func:`.pcs.verify_all`):
SHPLONK's pairing check on the host (the native C++ core, or Python ints
with ``native=False``), or the IPA opening check, whose one n-point MSM
⟨s, G⟩ runs on the params' device. The instance columns are not
committed: the verifier evaluates them at x from the public values (the
Lagrange closed form over their nonzero rows).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops import u64
from ..ops.pyfield import FR as PFR
from . import constraints, pcs, shplonk
from .domain import DELTA, EXT_FACTOR, Domain
from .keygen import VerifyingKey
from .prover import absorb_instances, query_schedule, rotation_point
from .transcript import Blake2bRead


def _instance_eval(dom: Domain, pub_u64: np.ndarray, x: int) -> int:
    """pub(x) = Σ_r pub_r·L_r(x) over the nonzero rows."""
    p = PFR.p
    rows = np.nonzero(pub_u64.any(axis=-1))[0]
    vals = [int(u64.to_ints(pub_u64[r])) for r in rows]
    zh = dom.vanishing_eval(x)
    ninv = pow(dom.n, -1, p)
    dens = [(x - pow(dom.omega, int(r), p)) % p for r in rows]
    pref = [1] * (len(dens) + 1)            # one batched inversion
    for i, d in enumerate(dens):
        pref[i + 1] = pref[i] * d % p
    inv = pow(pref[-1], -1, p) if dens else 1
    acc = 0
    for i in range(len(dens) - 1, -1, -1):
        di = pref[i] * inv % p
        inv = inv * dens[i] % p
        wi = pow(dom.omega, int(rows[i]), p)
        acc = (acc + vals[i] * wi % p * zh % p * di % p * ninv) % p
    return acc


class _PointCtx:
    """Host-int constraint evaluation at the challenge point x."""

    def __init__(self, ev: Dict, x: int, chal: Dict[str, int],
                 l0: int, llast: int, lblind: int):
        self.ev = ev
        self.x = x
        self.l0 = l0
        self.llast = llast
        self.active = (1 - llast - lblind) % PFR.p
        for name in ("theta", "beta", "gamma", "y"):
            setattr(self, name, chal[name] % PFR.p)

    def const(self, v: int) -> int:
        return v % PFR.p

    def get(self, name: str, rot: int) -> int:
        return self.ev[(name, rot)]

    def identity(self, gi: int) -> int:
        return pow(DELTA, gi, PFR.p) * self.x % PFR.p

    def add(self, a, b):
        return (a + b) % PFR.p

    def sub(self, a, b):
        return (a - b) % PFR.p

    def mul(self, a, b):
        return a * b % PFR.p


def verify_proof(params: pcs.Params, vk: VerifyingKey,
                 instance_u64: Dict[str, object], proof: bytes,
                 transcript_mode: str = "v1", native: bool = True) -> bool:
    """True if `proof` proves `vk`'s circuit on these instance columns
    ((n, 2) u64 pairs, tensors or numpy) in `transcript_mode`, the
    prover's. A malformed proof is rejected, never raised on; a native
    core that cannot be built raises. native=False runs the pairing and
    the MSM in Python ints."""
    circ = vk.circ
    dom = Domain(circ.k)
    n = dom.n
    tr = Blake2bRead(proof, transcript_mode)
    vk.hash_into(tr)
    try:
        inst = {name: u64.to_u32(instance_u64[name])
                for name in circ.instance_names}
        absorb_instances(tr, circ, inst)
        coms: Dict[str, tuple] = {}
        for name in circ.advice_names:
            coms[name] = tr.read_point()
        theta = tr.squeeze_challenge()
        for lk in circ.lookups:
            coms[f"{lk.name}.a_perm"] = tr.read_point()
            coms[f"{lk.name}.s_perm"] = tr.read_point()
        beta = tr.squeeze_challenge()
        gamma = tr.squeeze_challenge()
        for j in range(len(vk.perm_chunks)):
            coms[f"perm.z{j}"] = tr.read_point()
        for lk in circ.lookups:
            coms[f"{lk.name}.z"] = tr.read_point()
        y = tr.squeeze_challenge()
        for i in range(EXT_FACTOR):
            coms[f"h{i}"] = tr.read_point()
        x = tr.squeeze_challenge()

        ev: Dict = {}
        claims = []
        for name, rots in query_schedule(vk):
            pts, evs = [], []
            for r in rots:
                e = tr.read_scalar()
                ev[(name, r)] = e
                pts.append(rotation_point(dom, x, r))
                evs.append(e)
            com = vk.fixed_commitments.get(name)
            if com is None and name.startswith("perm.sigma"):
                com = vk.sigma_commitments[int(name[len("perm.sigma"):])]
            if com is None:
                com = coms[name]
            claims.append(shplonk.Claim(tuple(pts), tuple(evs),
                                        commitment=com))
        for name in circ.instance_names:
            ev[(name, 0)] = _instance_eval(dom, inst[name], x)

        # the quotient identity at x
        l0, llast, lblind = dom.l0_llast_lblind_eval(x)
        ctx = _PointCtx(ev, x, dict(theta=theta, beta=beta, gamma=gamma,
                                    y=y), l0, llast, lblind)
        numer = constraints.fold_y(
            ctx, constraints.enumerate_constraints(vk, ctx))
        xn = pow(x, n, PFR.p)
        h_at_x = 0
        for i in range(EXT_FACTOR):
            h_at_x = (h_at_x + pow(xn, i, PFR.p) * ev[(f"h{i}", 0)]) % PFR.p
        if numer % PFR.p != h_at_x * dom.vanishing_eval(x) % PFR.p:
            return False

        if not pcs.verify_all(params, dom, claims, tr, native):
            return False
        return tr.done()
    except (AssertionError, ValueError, KeyError, IndexError,
            OverflowError, ZeroDivisionError):
        # a malformed proof rejects, whatever the decoding or bookkeeping
        # raises (bad point encodings, a truncated stream, a denominator
        # that an adversarial challenge makes zero)
        return False
