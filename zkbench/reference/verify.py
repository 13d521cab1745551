"""The plain verifier of the BLAKE2f proofs, for both commitment schemes.

It replays the proof's transcript against a verifying key and a public
column that it worked out itself, checks the quotient identity at the
challenge x (the constraint enumeration of halo2 0.3: gates, lookups,
permutation chunks), and checks the batched opening (SHPLONK's reduction
of every claim to one point, then KZG or the inner-product argument).

* KZG: the SRS of a seed is a test setup whose τ the seed gives away, so
  the verifying key is worked out from τ (a commitment to a column is
  [Σ v_i·L_i(τ)]·G), and the pairing check e(A, G2) = e(W′, [τ]G2) is the
  equivalent A = τ·W′ in G1.
* IPA: the generators are hashed here; the one n-point MSM ⟨s, G⟩ of
  each opening and a check of the program's fixed and σ commitments (one
  random combination of them against the combined coefficients) are
  batched into a single Pippenger MSM over a process pool.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import curve
from .circuit import ADVICE, EXT_FACTOR, LOOKUPS, Circuit
from .expr import evaluate
from .field import DELTA, R, Q, batch_inv, intt, powers, root_of_unity, \
    sqrt_q
from .transcript import Transcript


class Rejected(Exception):
    """The proof does not verify (the message says at which step)."""


# ---------------------------------------------------------------------------
# the columns a verifying key commits to
# ---------------------------------------------------------------------------

def key_columns(circ: Circuit) -> Tuple[List[str], List[List[int]]]:
    """The names (fixed columns sorted, then perm.sigma0 …) and the
    evaluation forms on H of every column the verifying key commits to."""
    n = circ.n
    omega = root_of_unity(circ.k)
    wpow = powers(omega, n)
    dpow = powers(DELTA, len(circ.perm_cols))
    names, cols = [], []
    for nm in sorted(circ.fixed):
        names.append(nm)
        cols.append([int(v) for v in circ.fixed[nm].tolist()])
    colmap, rowmap = circ.sigma()
    for c in range(len(circ.perm_cols)):
        names.append(f"perm.sigma{c}")
        cols.append([dpow[a] * wpow[b] % R
                     for a, b in zip(colmap[c].tolist(), rowmap[c].tolist())])
    return names, cols


def kzg_tau(k: int, srs_seed: int) -> int:
    """τ of the deterministic test SRS of (k, seed)."""
    rng = random.Random(("zkodst-srs", srs_seed, k).__repr__())
    return rng.randrange(1, R)


@dataclass
class Key:
    """A verifying key: k, the fixed commitments by name and σ's."""

    k: int
    fixed: Dict[str, tuple]
    sigma: List[tuple]

    def hash_into(self, tr: Transcript) -> None:
        tr.common_scalar(self.k)
        for nm in sorted(self.fixed):
            tr.common_point(self.fixed[nm])
        for c in self.sigma:
            tr.common_point(c)

    def digest(self) -> int:
        tr = Transcript()
        self.hash_into(tr)
        return tr.squeeze()

    def points(self) -> List[tuple]:
        return [self.fixed[nm] for nm in sorted(self.fixed)] + self.sigma


def kzg_key(circ: Circuit, tau: int) -> Key:
    """The verifying key under the SRS of τ: each column's commitment is
    its value at τ (Σ v_i·L_i(τ)) times the generator."""
    n = circ.n
    omega = root_of_unity(circ.k)
    wpow = powers(omega, n)
    zh = (pow(tau, n, R) - 1) % R
    dinv = batch_inv([n * (tau - w) % R for w in wpow])
    lag = [w * zh % R * d % R for w, d in zip(wpow, dinv)]
    names, cols = key_columns(circ)
    pts = {}
    for nm, col in zip(names, cols):
        s = sum(v * l for v, l in zip(col, lag) if v) % R
        pts[nm] = curve.mul(curve.GEN, s)
    nf = len(circ.fixed)
    return Key(circ.k, {nm: pts[nm] for nm in names[:nf]},
               [pts[nm] for nm in names[nf:]])


# ---------------------------------------------------------------------------
# IPA generators and the pooled MSM
# ---------------------------------------------------------------------------

IPA_TAG = b"zkodst-ipa-g"
MSM_C = 13


def _hash_to_curve(msg: bytes) -> Tuple[int, int]:
    """Try-and-increment: x = blake2b-256(msg ∥ ctr) mod q, y the even
    root of x³ + 3."""
    ctr = 0
    while True:
        d = hashlib.blake2b(msg + ctr.to_bytes(4, "little"),
                            digest_size=32).digest()
        x = int.from_bytes(d, "little") % Q
        y = sqrt_q(x * x * x + curve.B)
        if y is not None:
            return (x, Q - y if y & 1 else y)
        ctr += 1


def _generators_bytes(lo: int, hi: int) -> bytes:
    """G_lo … G_{hi−1}, 64 bytes each (x, y little-endian)."""
    out = bytearray()
    for i in range(lo, hi):
        x, y = _hash_to_curve(IPA_TAG + i.to_bytes(8, "little"))
        out += x.to_bytes(32, "little") + y.to_bytes(32, "little")
    return bytes(out)


def _points_of(raw: bytes) -> List[Tuple[int, int]]:
    return [(int.from_bytes(raw[i: i + 32], "little"),
             int.from_bytes(raw[i + 32: i + 64], "little"))
            for i in range(0, len(raw), 64)]


def _ints_of(raw: bytes) -> List[int]:
    return [int.from_bytes(raw[i: i + 32], "little")
            for i in range(0, len(raw), 32)]


def _msm_windows(args):
    points_raw, scalars_raw, c, windows = args
    pts = _points_of(points_raw)
    ks = _ints_of(scalars_raw)
    return [(w, curve.msm_window(pts, ks, c, w)) for w in windows]


@dataclass
class IpaParams:
    k: int
    g_raw: bytes                 # the n generators, 64 bytes each
    h: Tuple[int, int]
    u: Tuple[int, int]

    @property
    def g0(self) -> Tuple[int, int]:
        return _points_of(self.g_raw[:64])[0]


def ipa_params(k: int, pool) -> IpaParams:
    n = 1 << k
    step = -(-n // 64)
    parts = pool.starmap(_generators_bytes,
                         [(lo, min(n, lo + step)) for lo in range(0, n, step)])
    base = IPA_TAG[:-1]
    h = _hash_to_curve(base + b"h" + bytes(8))
    u = _hash_to_curve(base + b"u" + bytes(8))
    return IpaParams(k, b"".join(parts), h, u)


def pooled_msm(pool, points_raw: bytes, scalars: Sequence[int],
               c: int = MSM_C, nproc: int = 8):
    """Σ k_i·G_i over the pool, windows shared out among `nproc` tasks."""
    raw = b"".join((k % R).to_bytes(32, "little") for k in scalars)
    nwin = -(-256 // c)
    groups = [list(range(w, nwin, nproc)) for w in range(min(nproc, nwin))]
    sums = [None] * nwin
    for part in pool.map(_msm_windows,
                         [(points_raw, raw, c, g) for g in groups]):
        for w, s in part:
            sums[w] = s
    return curve.combine_windows(sums, c)


def s_vector(us: Sequence[int]) -> List[int]:
    """s_i = ∏ u_j⁻¹ over the bits of i (rounds consume the top bit
    first, so they are unfolded in reverse)."""
    s = [1]
    for u in reversed(us):
        ui = pow(u, -1, R)
        s = s + [t * ui % R for t in s]
    return s


# ---------------------------------------------------------------------------
# the proof
# ---------------------------------------------------------------------------

def _instance_eval(n: int, omega: int, pub: np.ndarray, x: int) -> int:
    """pub(x) = Σ_r pub_r·L_r(x) over the nonzero rows."""
    rows = np.nonzero(pub)[0].tolist()
    if not rows:
        return 0
    zh = (pow(x, n, R) - 1) % R
    ninv = pow(n, -1, R)
    wis = [pow(omega, r, R) for r in rows]
    inv = batch_inv([(x - w) % R for w in wis])
    return sum(int(pub[r]) * w % R * zh % R * d % R * ninv
               for r, w, d in zip(rows, wis, inv)) % R


def _compress_cols(ev, cols, theta):
    acc, tp = 0, 1
    for c in cols:
        acc = (acc + tp * ev[(c, 0)]) % R
        tp = tp * theta % R
    return acc


def _numerator(circ: Circuit, ev, chal, x, l0, llast, lblind) -> int:
    """Σ y^i·term_i over every constraint, in the prover's order."""
    theta, beta, gamma, y = (chal[k] for k in ("theta", "beta", "gamma",
                                               "y"))
    active = (1 - llast - lblind) % R
    terms = [evaluate(g, lambda c, r: ev[(c, r)]) for _, g in circ.gates]
    for name, inp, tab in LOOKUPS:
        a = _compress_cols(ev, inp, theta)
        s = _compress_cols(ev, tab, theta)
        ap, ap_prev = ev[(f"{name}.a_perm", 0)], ev[(f"{name}.a_perm", -1)]
        sp = ev[(f"{name}.s_perm", 0)]
        z, zw = ev[(f"{name}.z", 0)], ev[(f"{name}.z", 1)]
        terms += [l0 * (1 - z), llast * (z * z - z),
                  active * (zw * (ap + beta) * (sp + gamma)
                            - z * (a + beta) * (s + gamma)),
                  active * (ap - sp) * (ap - ap_prev), l0 * (ap - sp)]
    chunks = circ.perm_chunks
    nz = len(chunks)
    z0 = ev[("perm.z0", 0)]
    zl = ev[(f"perm.z{nz - 1}", 0)]
    terms += [l0 * (1 - z0), llast * (zl * zl - zl)]
    for j in range(1, nz):
        terms.append(l0 * (ev[(f"perm.z{j}", 0)]
                           - ev[(f"perm.z{j - 1}", circ.usable)]))
    col_of = {c: i for i, c in enumerate(circ.perm_cols)}
    for j, chunk in enumerate(chunks):
        lhs, rhs = ev[(f"perm.z{j}", 1)], ev[(f"perm.z{j}", 0)]
        for c in chunk:
            gi = col_of[c]
            a = ev[(c, 0)]
            lhs = lhs * (a + beta * ev[(f"perm.sigma{gi}", 0)] + gamma) % R
            rhs = rhs * (a + beta * pow(DELTA, gi, R) * x + gamma) % R
        terms.append(active * (lhs - rhs))
    acc = 0
    for t in terms:
        acc = (acc * y + t) % R
    return acc


def _interp(points, evals) -> List[int]:
    m = len(points)
    coeffs = [0] * m
    for j in range(m):
        num, den = [1], 1
        for kk in range(m):
            if kk == j:
                continue
            nxt = [0] * (len(num) + 1)
            for t, a in enumerate(num):
                nxt[t] = (nxt[t] - points[kk] * a) % R
                nxt[t + 1] = (nxt[t + 1] + a) % R
            num = nxt
            den = den * (points[j] - points[kk]) % R
        sc = evals[j] * pow(den, -1, R) % R
        for t in range(len(num)):
            coeffs[t] = (coeffs[t] + sc * num[t]) % R
    return coeffs


def _weights(claims, ypows, z):
    """Z_T(z), per claim y^i·Z_{T∖S_i}(z), and Σ c_i·r_i(z)."""
    t_all = sorted({p for pts, _, _ in claims for p in pts})
    zt = 1
    for s in t_all:
        zt = zt * (z - s) % R
    cs, const = [], 0
    for (pts, evs, _), yp in zip(claims, ypows):
        c = yp
        for s in t_all:
            if s not in pts:
                c = c * (z - s) % R
        cs.append(c)
        r = 0
        for co in reversed(_interp(pts, evs)):
            r = (r * z + co) % R
        const = (const + c * r) % R
    return zt, cs, const


def _replay(circ: Circuit, key: Key, pub: np.ndarray, proof: bytes):
    """Transcript, evaluations and the quotient identity; returns the
    transcript and the claims [(points, evaluations, commitment)]."""
    n = circ.n
    omega = root_of_unity(circ.k)
    tr = Transcript(proof)
    key.hash_into(tr)
    col = np.zeros((n, 2), np.uint32)
    col[:, 0] = (pub & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    col[:, 1] = (pub >> np.uint64(32)).astype(np.uint32)
    tr.common_scalar(int.from_bytes(
        hashlib.blake2b(col.tobytes(), digest_size=64).digest(),
        "little") % R)
    coms = {nm: tr.read_point() for nm in ADVICE}
    chal = {"theta": tr.squeeze()}
    for name, _, _ in LOOKUPS:
        coms[f"{name}.a_perm"] = tr.read_point()
        coms[f"{name}.s_perm"] = tr.read_point()
    chal["beta"] = tr.squeeze()
    chal["gamma"] = tr.squeeze()
    for j in range(len(circ.perm_chunks)):
        coms[f"perm.z{j}"] = tr.read_point()
    for name, _, _ in LOOKUPS:
        coms[f"{name}.z"] = tr.read_point()
    chal["y"] = tr.squeeze()
    for i in range(EXT_FACTOR):
        coms[f"h{i}"] = tr.read_point()
    x = tr.squeeze()

    ev, claims = {}, []
    for name, rots in circ.query_schedule():
        evs = []
        for r in rots:
            ev[(name, r)] = tr.read_scalar()
            evs.append(ev[(name, r)])
        if name in key.fixed:
            com = key.fixed[name]
        elif name.startswith("perm.sigma"):
            com = key.sigma[int(name[len("perm.sigma"):])]
        else:
            com = coms[name]
        claims.append((tuple(x * pow(omega, r, R) % R for r in rots),
                       tuple(evs), com))
    ev[("pub", 0)] = _instance_eval(n, omega, pub, x)

    def lag(i):
        w = pow(omega, i, R)
        return w * ((pow(x, n, R) - 1) % R) % R * pow(n * (x - w) % R, -1,
                                                       R) % R

    l0, llast = lag(0), lag(circ.usable)
    lblind = sum(lag(i) for i in range(circ.usable + 1, n)) % R
    numer = _numerator(circ, ev, chal, x, l0, llast, lblind)
    xn = pow(x, n, R)
    h_x = sum(pow(xn, i, R) * ev[(f"h{i}", 0)] for i in range(EXT_FACTOR)) % R
    if numer != h_x * ((xn - 1) % R) % R:
        raise Rejected("the quotient identity fails at x")
    return tr, claims


def _reduce(tr, claims):
    y = tr.squeeze()
    w = tr.read_point()
    z = tr.squeeze()
    ypows = powers(y, len(claims))
    zt, cs, const = _weights(claims, ypows, z)
    return w, z, zt, cs, const


def verify_kzg(circ: Circuit, key: Key, tau: int, pub: np.ndarray,
               proof: bytes) -> None:
    """Raises Rejected unless the proof verifies (KZG + SHPLONK)."""
    try:
        tr, claims = _replay(circ, key, pub, proof)
        w, z, zt, cs, const = _reduce(tr, claims)
        wp = tr.read_point()
    except (ValueError, KeyError, IndexError, ZeroDivisionError) as ex:
        raise Rejected(f"malformed: {ex}") from ex
    lhs = curve.lin_comb([c for _, _, c in claims] + [curve.GEN, w, wp],
                         cs + [(-const) % R, (-zt) % R, z])
    if lhs != curve.mul(wp, tau):
        raise Rejected("the opening check fails")
    if not tr.done():
        raise Rejected("bytes left over")


@dataclass
class IpaPending:
    """What is left of an IPA check after the host part: it holds iff
    a0·⟨s, G⟩ + rest = 0."""

    a0: int
    s: List[int]
    rest: tuple


def verify_ipa_host(circ: Circuit, key: Key, params: IpaParams,
                    pub: np.ndarray, proof: bytes) -> IpaPending:
    """The host part of the IPA check (raises Rejected)."""
    n = circ.n
    try:
        tr, claims = _replay(circ, key, pub, proof)
        w, z, zt, cs, const = _reduce(tr, claims)
        c_l = curve.lin_comb([c for _, _, c in claims] + [params.g0, w],
                             cs + [(-const) % R, (-zt) % R])
        us, lrs = [], []
        for _ in range(circ.k):
            lrs.append((tr.read_point(), tr.read_point()))
            us.append(tr.squeeze())
        a0, rho = tr.read_scalar(), tr.read_scalar()
    except (ValueError, KeyError, IndexError, ZeroDivisionError) as ex:
        raise Rejected(f"malformed: {ex}") from ex
    if not tr.done():
        raise Rejected("bytes left over")
    b0 = 1
    for j, u in enumerate(us):
        b0 = b0 * (1 + pow(u, -1, R) * pow(z, n >> (j + 1), R)) % R
    rhs = c_l
    for (L, Rp), u in zip(lrs, us):
        rhs = curve.add(rhs, curve.lin_comb([L, Rp], [pow(u, -1, R), u]))
    rest = curve.add(curve.lin_comb([params.u, params.h], [a0 * b0 % R, rho]),
                     curve.neg(rhs))
    return IpaPending(a0, s_vector(us), rest)


def ipa_batch_holds(pool, params: IpaParams, pendings: Sequence[IpaPending],
                    key: Key, key_cols: Optional[List[List[int]]],
                    rng: random.Random) -> bool:
    """One MSM for all: Σ_p ρ_p·(a0_p·⟨s_p, G⟩ + rest_p) and, with
    key_cols (the key's columns in evaluation form, in the order of
    :meth:`Key.points`), Σ_j r_j·C_j − ⟨coeffs(Σ_j r_j·col_j), G⟩, at
    random weights; True iff the sum is the identity."""
    n = 1 << params.k
    scal = [0] * n
    small = None
    for p in pendings:
        rho = rng.randrange(1, R)
        f = rho * p.a0 % R
        scal = [(a + f * s) % R for a, s in zip(scal, p.s)]
        small = curve.add(small, curve.mul(p.rest, rho))
    if key_cols is not None:
        comb = [0] * n
        for pt, col in zip(key.points(), key_cols):
            r = rng.randrange(1, R)
            comb = [(a + r * v) % R if v else a for a, v in zip(comb, col)]
            small = curve.add(small, curve.mul(pt, r))
        coeffs = intt(comb, root_of_unity(params.k))
        scal = [(a - c) % R for a, c in zip(scal, coeffs)]
    return curve.add(pooled_msm(pool, params.g_raw, scal), small) is None
