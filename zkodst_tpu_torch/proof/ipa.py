"""IPA (inner-product argument) polynomial commitment: the transparent
second scheme, over BN254 (the whole pipeline, beside KZG) and over the
Pasta pallas curve (commit, open and verify of one polynomial, and the
per-point multiopen).

Counterpart of ``zkodst_tpu/proof/ipa.py``; the proof bytes are the
reference's. A Pedersen vector commitment with a log-size
Bulletproofs-style opening, in coefficient form with b = (1, x, x², …):

  commit(a, r)        P_a = ⟨a, G⟩ + r·H
  open at x, v=a(x):  P   = P_a + v·U
  per round j:        L_j = ⟨a_lo, G_hi⟩ + ⟨a_lo, b_hi⟩·U + l_j·H
                      R_j = ⟨a_hi, G_lo⟩ + ⟨a_hi, b_lo⟩·U + m_j·H
                      u_j ← FS;  a ← a_lo + u_j·a_hi
                      b ← b_lo + u_j⁻¹·b_hi;  G ← G_lo + u_j⁻¹·G_hi
                      ρ ← ρ + u_j⁻¹·l_j + u_j·m_j
  final:              send a₀, ρ_f; the verifier checks
                      a₀·G₀ + (a₀·b₀)·U + ρ_f·H
                        == P + Σ_j (u_j⁻¹·L_j + u_j·R_j)
  with G₀ = ⟨s, G⟩ (one n-point MSM on the card),
  s_i = ∏_{j: bit_{k-j}(i)=1} u_j⁻¹, b₀ = ∏_j (1 + u_j⁻¹ x^{n/2^j}).

The opening is the reference's fixed-shape form
(``_open_poly_fixed_shape`` :275-338): the folded generators stay linear
in the original ones, G^(j)[i] = Σ_{t ≡ i mod 2^(k−j+1)} w_t·G_t, so each
round's L and R main terms are one two-row MSM over all n generators with
per-generator scalars w_t·a[t mod half] on one side of bit k−j of t. On
an H100 the whole opening takes less time than the device work alone of
the reference's folding form (two MSMs over the surviving half and a
~380-launch shared-scalar ladder on kernel 8 each round; PERF.md); both
give the same group elements, so the same bytes. The rest of L and R, ⟨a, b⟩·U and the
blind's multiple of H, is made on the card from window tables of U and H
(one gather and a pairwise fold on kernel 8, :func:`_bases_mul`), where
the reference multiplies on the host. The MSMs are the Pippenger of
:mod:`..ops.msm` on both curves (kernels 9–12, BN254's or pallas's
instances), where the reference runs pallas's as a per-lane
double-and-add and a pairwise fold: the same group elements, so the same
bytes.

Generators are the reference's try-and-increment hash to the curve
(:func:`_hash_to_curve`): the candidates x are hashed on the host, and
x³ + b, the square root and the check y² = x³ + b run over all candidates
at once on the card (:func:`generators`); the BN254 root is
(x³ + 3)^((q+1)/4) on kernel 1 (q ≡ 3 mod 4), the pallas root a
Tonelli–Shanks over all candidates at once on kernel 1 (p ≡ 1 mod 2^32),
where the reference runs it on the host point by point. Either root is
made even, as the reference does, so the points are the same.
"""

from __future__ import annotations

import hashlib
import os
import secrets
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import curve, msm, pycurve
from ..ops.field import FR, MASK32, PASTA_FR, Field, from_limbs16, \
    ints_to_limbs, to_limbs16
from ..ops.ntt import pow_table, powers_table
from ..ops.pyfield import FQ as PFQ
from ..ops.pyfield import FR as PFR
from ..ops.pyfield import PALLAS_BASE, PF, VESTA_BASE
from ..utils.device import resolve
from ..utils.timing import span, upload
from . import shplonk

# Pippenger window of the MSMs, on either curve (the group elements do not
# depend on it)
MSM_C = 13
# counters hashed per generator in one pass of generators(); each passes
# with probability ~1/2, and the indices left are hashed again
HASH_CTRS = 2


@dataclass(frozen=True)
class _CurveCfg:
    """One curve of the backend (``ipa.py:73-124``)."""

    name: str
    dev: curve.Curve     # device group ops
    SF: Field            # device scalar field
    sp: int              # host scalar modulus
    pg: pycurve.Group    # host group
    base_pf: PF          # host base field (hash to curve)
    tag: bytes           # hash domain of the generators


_CFGS = {
    "bn254": _CurveCfg("bn254", curve.BN254, FR, PFR.p, pycurve.G1, PFQ,
                       b"zkodst-ipa-g"),
    "pasta": _CurveCfg("pasta", curve.PASTA, PASTA_FR, VESTA_BASE,
                       pycurve.PASTA_G1, PF(PALLAS_BASE, "pallas_base"),
                       b"zkodst-ipa-pasta-g"),
}


@dataclass
class ParamsIPA:
    k: int
    g: torch.Tensor          # (n, 3, 8) generators (Montgomery limbs)
    h: Tuple[int, int]       # blinding base (affine ints)
    u: Tuple[int, int]       # inner-product base (affine ints)
    curve: str = "bn254"     # "bn254" or "pasta"
    # fixed-base window tables of U and H (_bases_table), made at first use
    bases: Optional[torch.Tensor] = field(default=None, repr=False,
                                          compare=False)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def device(self) -> torch.device:
        return self.g.device


def _cfg(params: ParamsIPA) -> _CurveCfg:
    return _CFGS[params.curve]


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def _hash_to_curve(tag: bytes, i: int, pf: PF = PFQ,
                   b: int = 3) -> Tuple[int, int]:
    """Try-and-increment on the host, a copy of the reference's: x from a
    hash, y the even root. Sound for cofactor-1 curves (BN254 G1 and
    pallas): every curve point is in the prime-order group."""
    p = pf.p
    ctr = 0
    while True:
        d = hashlib.blake2b(tag + i.to_bytes(8, "little")
                            + ctr.to_bytes(4, "little"),
                            digest_size=32).digest()
        x = int.from_bytes(d, "little") % p
        y = pf.sqrt((x * x % p * x + b) % p)
        if y is not None:
            if y & 1:
                y = p - y
            return (x, y)
        ctr += 1


def _messages(cfg: _CurveCfg, n: int) -> List[bytes]:
    """The hash inputs (before the counter) of G_0 … G_{n−1}, H and U."""
    tag = cfg.tag
    return ([tag + i.to_bytes(8, "little") for i in range(n)]
            + [tag[:-1] + name + (0).to_bytes(8, "little")
               for name in (b"h", b"u")])


def _candidates(msgs: Sequence[bytes], ctr: int, count: int,
                p: int) -> np.ndarray:
    """x = blake2b(msg ∥ ctr) mod p for each message and `count` counters
    from `ctr`: (len(msgs)·count, 8) uint32 normal-form limbs."""
    ctrs = [c.to_bytes(4, "little") for c in range(ctr, ctr + count)]
    raw = b"".join(
        (int.from_bytes(hashlib.blake2b(m + c, digest_size=32).digest(),
                        "little") % p).to_bytes(32, "little")
        for m in msgs for c in ctrs)
    return np.frombuffer(raw, "<u4").reshape(-1, 8)


def _pow(F: Field, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise (e ≥ 1), square and multiply from the top bit:
    one kernel-1 launch a bit and one a set bit."""
    acc = a
    for bit in bin(e)[3:]:
        acc = F.mul(acc, acc)
        if bit == "1":
            acc = F.mul(acc, a)
    return acc


def _tonelli_shanks(F: Field, pf: PF, a: torch.Tensor) -> torch.Tensor:
    """A square root of each element of `a` where it has one, all at once
    on kernel 1, for p − 1 = 2^s·t (t odd, s = 32 on pallas): r =
    a^((t+1)/2) and e = a^t, so r² = a·e, with e of order dividing 2^(s−1)
    where a is a square; from j = s − 1 down to 1, where e^(2^(j−1)) ≠ 1,
    e takes a factor g^(2^(s−j)) and r its root g^(2^(s−j−1)) (g of order
    2^s), which keeps r² = a·e and halves e's order, so e ends at 1. The
    ~s²/2 squarings run over every element, whether it needs them or
    not."""
    p, s = F.p, pf.two_adicity
    t = (p - 1) >> s
    g = pow(pf.smallest_qnr(), t, p)
    gs = F.from_ints([pow(g, 1 << k, p) for k in range(s)], a.device)
    one = F.const(F.ONE, a.device)
    x = _pow(F, a, (t - 1) // 2)
    r = F.mul(x, a)                         # a^((t+1)/2)
    e = F.mul(r, x)                         # a^t
    for j in range(s - 1, 0, -1):
        sq = e
        for _ in range(j - 1):
            sq = F.mul(sq, sq)
        flip = ~torch.eq(sq, one).all(dim=-1, keepdim=True)
        e = torch.where(flip, F.mul(e, gs[s - j]), e)
        r = torch.where(flip, F.mul(r, gs[s - j - 1]), r)
    return r


def _sqrt(cfg: _CurveCfg, rhs: torch.Tensor) -> torch.Tensor:
    """A square root of each element where it has one (anything where it
    has none), on the card. BN254: rhs^((q+1)/4) (q ≡ 3 mod 4). Pallas
    (p ≡ 1 mod 2^32): :func:`_tonelli_shanks`."""
    F = cfg.dev.F
    if F.p % 4 == 3:
        return _pow(F, rhs, (F.p + 1) // 4)
    return _tonelli_shanks(F, cfg.base_pf, rhs)


def generators(cfg: _CurveCfg, msgs: Sequence[bytes],
               device) -> torch.Tensor:
    """The point :func:`_hash_to_curve` gives for each message (tag ∥ i),
    as (len(msgs), 3, 8) projective Montgomery limbs with Z = 1, made over
    all messages at once: HASH_CTRS counters each a pass, x to Montgomery
    form, x³ + b and its root on the card (kernels 1 and 2), y² = x³ + b
    checked there, the first counter that passes taken and its root made
    even (kernel 3); the messages with no passing counter go again with
    the next counters."""
    F = cfg.dev.F
    m = len(msgs)
    out = torch.empty((m, 3, 8), dtype=torch.int32, device=device)
    r2, one = F.const(F.R2, device), F.const(F.ONE, device)
    raw1 = torch.zeros(8, dtype=torch.int32, device=device)
    raw1[:1].fill_(1)
    bk = F.from_ints(cfg.dev.b, device)
    todo = np.arange(m)
    ctr = 0
    C = HASH_CTRS
    while todo.size:
        x = F.mul(F.const(_candidates([msgs[i] for i in todo], ctr, C, F.p),
                          device), r2)
        rhs = F.add(F.mul(F.mul(x, x), x), bk)
        y = _sqrt(cfg, rhs)
        ok = torch.eq(F.mul(y, y), rhs).all(dim=-1).reshape(-1, C).cpu()
        has = ok.any(dim=1).numpy()
        pick = upload((torch.arange(ok.shape[0]) * C + ok.to(torch.int8)
                       .argmax(dim=1))[torch.from_numpy(has)], device)
        xs, ys = x[pick], y[pick]
        odd = (F.mul(ys, raw1)[:, 0] & 1).bool()
        ys = torch.where(odd[:, None], F.neg(ys), ys)
        out[upload(torch.from_numpy(todo[has]), device)] = torch.stack(
            [xs, ys, one.expand_as(xs)], dim=1)
        todo = todo[~has]
        ctr += C
    return out


# ---------------------------------------------------------------------------
# setup and its cache
# ---------------------------------------------------------------------------

def _enc(pt) -> np.ndarray:
    return np.frombuffer(pt[0].to_bytes(32, "little")
                         + pt[1].to_bytes(32, "little"), np.uint8)


def _dec(raw: np.ndarray) -> Tuple[int, int]:
    b = raw.tobytes()
    if len(b) != 64:
        raise ValueError(f"a cached point takes 64 bytes, not {len(b)}")
    return (int.from_bytes(b[:32], "little"), int.from_bytes(b[32:],
                                                             "little"))


def save(params: ParamsIPA, path: str) -> None:
    """Write the reference's cache file (``ipa.py:181-195``): ``g`` as
    (n, 3, 16) 16-bit limbs, ``h`` and ``u`` as 64 bytes of LE x ∥ y,
    through a temporary file that replaces `path` whole."""
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, g=to_limbs16(params.g), h=_enc(params.h),
             u=_enc(params.u))
    os.replace(tmp, path)


def load(path: str, k: int, curve_name: str = "bn254",
         device=None) -> ParamsIPA:
    """Read a cache file written by :func:`save` or by the reference."""
    dev = resolve(device)
    with np.load(path, allow_pickle=False) as d:
        g = from_limbs16(d["g"], dev)
        h, u = _dec(d["h"]), _dec(d["u"])
    if g.shape != (1 << k, 3, 8):
        raise ValueError(f"cached generators {tuple(g.shape)} for k={k}")
    return ParamsIPA(k=k, g=g, h=h, u=u, curve=curve_name)


def setup(k: int, cache_dir: Optional[str] = None,
          curve_name: str = "bn254", device=None) -> ParamsIPA:
    """Transparent setup on `device` (CUDA by default): n + 2 hashed
    generators (:func:`generators`), read from and written to
    ``ipa_<curve>_k<k>.npz`` in `cache_dir` where given (either package
    reads the other's file); a file that cannot be read is made again
    and overwritten."""
    dev = resolve(device)
    cfg = _CFGS[curve_name]
    path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"ipa_{curve_name}_k{k}.npz")
        if os.path.exists(path):
            try:
                return load(path, k, curve_name, dev)
            except (KeyError, ValueError, OSError) as ex:
                print(f"# stale IPA cache {path} ({type(ex).__name__}): "
                      "regenerating", flush=True)
    n = 1 << k
    pts = generators(cfg, _messages(cfg, n), dev)
    h, u = cfg.dev.to_affine_ints(pts[n:])
    params = ParamsIPA(k=k, g=pts[:n], h=h, u=u, curve=curve_name)
    if path:
        save(params, path)
    return params


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def _rand_scalar(rng=None, p: int = PFR.p) -> int:
    return rng.randrange(p) if rng is not None else secrets.randbelow(p)


def _normal(F: Field, mont: torch.Tensor) -> torch.Tensor:
    """Montgomery limbs -> normal form (a product with raw 1, kernel 1)."""
    raw1 = torch.zeros(8, dtype=torch.int32, device=mont.device)
    raw1[:1].fill_(1)                       # a fill on the device
    return F.mul(mont, raw1)


def _sum_points(cfg: _CurveCfg, pts: torch.Tensor) -> torch.Tensor:
    """Σ over dim 1 of (B, m, 3, 8) points -> (B, 3, 8): a pairwise fold,
    one launch of kernel 8 a level."""
    while pts.shape[1] > 1:
        if pts.shape[1] % 2:
            pts = torch.cat([pts, cfg.dev.identity((pts.shape[0], 1),
                                                   pts.device)], 1)
        pts = cfg.dev.add(pts[:, 0::2], pts[:, 1::2])
    return pts[:, 0]


def _msm(cfg: _CurveCfg, points: torch.Tensor, scalars: torch.Tensor,
         c: int = MSM_C) -> torch.Tensor:
    """⟨scalars[b], points⟩ for (B, m, 8) NORMAL-form scalars -> (B, 3, 8):
    the Pippenger MSM of window c on the curve's instances of kernels
    9–12, on either curve."""
    return msm.msm_many(points, scalars, c, curve=cfg.dev)


# fixed-base windows of U and H: BASE_W windows of BASE_C bits cover a
# 256-bit scalar
BASE_C, BASE_W = 4, 64


def _bases_table(params: ParamsIPA) -> torch.Tensor:
    """(BASE_W, 2^(BASE_C+1), 3, 8) on the params' device: in window w,
    entries d·16^w·U, then d·16^w·H; made once per params and kept. The
    window bases 16^w·U and 16^w·H are doublings on the host, the entries
    2^BASE_C − 2 launches of kernel 8 over all windows at once."""
    if params.bases is None:
        cfg = _cfg(params)
        pws = []
        for pt in (params.u, params.h):
            for _ in range(BASE_W):
                pws.append(pt)
                for _ in range(BASE_C):
                    pt = cfg.pg.add(pt, pt)
        base = cfg.dev.from_affine_ints(pws, params.device)
        rows = [cfg.dev.identity((2 * BASE_W,), params.device), base]
        for _ in range(2, 1 << BASE_C):
            rows.append(cfg.dev.add(rows[-1], base))
        tbl = torch.stack(rows, dim=1)                  # (2·BASE_W, 16, …)
        params.bases = torch.cat([tbl[:BASE_W], tbl[BASE_W:]], dim=1)
    return params.bases


def _bases_mul(params: ParamsIPA, ips: torch.Tensor,
               blinds: Sequence[int]) -> torch.Tensor:
    """ips[i]·U + blinds[i]·H for (m, 8) NORMAL-form scalars on the card
    and m host ints -> (m, 3, 8): each scalar's BASE_W window entries
    gathered from the table of :func:`_bases_table` at once, then each
    row's U and H entries summed by a pairwise fold (kernel 8)."""
    cfg = _cfg(params)
    tbl = _bases_table(params)
    dev = params.device
    m = ips.shape[0]
    limbs = torch.cat([ips.to(torch.int64) & MASK32, upload(torch.from_numpy(
        ints_to_limbs(list(blinds)).astype(np.int64)), dev)])
    w = torch.arange(BASE_W, device=dev)
    per = 32 // BASE_C
    digits = (limbs[:, w // per] >> ((w % per) * BASE_C)) & ((1 << BASE_C)
                                                             - 1)
    digits[m:] += 1 << BASE_C                # H's entries follow U's
    ent = tbl[w, digits]                     # (2m, BASE_W, 3, 8)
    return _sum_points(cfg, torch.cat([ent[:m], ent[m:]], dim=1))


def _fold(F: Field, v: torch.Tensor, w: int) -> torch.Tensor:
    """v_lo + w·v_hi of an (m, 8) Montgomery vector."""
    m = v.shape[0] // 2
    return F.add(v[:m], F.mul(F.from_ints(w, v.device), v[m:]))


# ---------------------------------------------------------------------------
# commit / open / verify (one polynomial, one point)
# ---------------------------------------------------------------------------

# Columns per MSM of commit_many: 4 full-width columns at n = 2^17 are 80
# window rows of 2^17 gathered points (~1 GB each for the gather and the
# chain scan)
COMMIT_BATCH = 4


def commit_many(params: ParamsIPA, coeffs: torch.Tensor,
                c: int = MSM_C) -> list:
    """⟨coeffs[b], G⟩ of (B, m, 8) Montgomery coefficients -> B affine
    points (blind 0), full-width MSMs of COMMIT_BATCH columns each."""
    cfg = _cfg(params)
    g = params.g[: coeffs.shape[1]]
    out = []
    for i in range(0, coeffs.shape[0], COMMIT_BATCH):
        scal = _normal(cfg.SF, coeffs[i: i + COMMIT_BATCH])
        out += cfg.dev.to_affine_ints(_msm(cfg, g, scal, c))
    return out


def commit(params: ParamsIPA, coeffs_mont: torch.Tensor, blind: int):
    """P_a = ⟨a, G⟩ + blind·H -> affine ints (host)."""
    cfg = _cfg(params)
    base = commit_many(params, coeffs_mont[None])[0]
    return cfg.pg.add(base, cfg.pg.mul(params.h, blind))


def open_poly(params: ParamsIPA, coeffs_mont: torch.Tensor, blind: int,
              x: int, v: int, tw, rng=None) -> None:
    """Write the log-size opening of a(x) = v to the transcript: per round
    L and R, then a₀ and ρ_f. The blinds l_j, m_j are drawn from `rng`
    (OS entropy when None) in the reference's order. Each round: the
    generators' scalars w_t·a_lo[t mod half] where bit k−j of t is set
    (L) and w_t·a_hi[t mod half] where it is clear (R), one two-row MSM
    over all n generators, ⟨a_lo, b_hi⟩·U + l_j·H and ⟨a_hi, b_lo⟩·U +
    m_j·H on the card, one read-back of L and R; then a, b and w fold on
    the card (w_t takes u_j⁻¹ where the bit is set)."""
    cfg = _cfg(params)
    F, sp = cfg.SF, cfg.sp
    a = coeffs_mont
    n = int(a.shape[0])
    if n & (n - 1):
        raise ValueError(f"open_poly takes a power-of-two length, not {n}")
    k = n.bit_length() - 1
    dev = a.device
    g = params.g[:n]
    b = powers_table(F, x, n, dev)
    wv = F.const(F.ONE, dev).expand(n, 8)          # w_t = 1
    pos = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    rho = blind
    for j in range(1, k + 1):
        half = n >> j
        hi = ((pos >> (k - j)) & 1).bool()[:, None]
        l_b, m_b = _rand_scalar(rng, sp), _rand_scalar(rng, sp)
        ws = wv.reshape(n // half, half, 8)
        s_l = F.mul(ws, a[:half].expand(n // half, half, 8)).reshape(n, 8)
        s_r = F.mul(ws, a[half:].expand(n // half, half, 8)).reshape(n, 8)
        scal = torch.stack([torch.where(hi, s_l, zero),
                            torch.where(hi, zero, s_r)])
        ips = F.sum(F.mul(torch.stack([a[:half], a[half:]]),
                          torch.stack([b[half:], b[:half]])), dim=1)
        lr = cfg.dev.add(_msm(cfg, g, _normal(F, scal)),
                         _bases_mul(params, _normal(F, ips), (l_b, m_b)))
        L, R = cfg.dev.to_affine_ints(lr)
        tw.write_point(L)
        tw.write_point(R)
        u_j = tw.squeeze_challenge()
        u_inv = pow(u_j, -1, sp)
        a, b = _fold(F, a, u_j), _fold(F, b, u_inv)
        wv = torch.where(hi, F.mul(wv, F.from_ints(u_inv, dev)), wv)
        rho = (rho + u_inv * l_b + u_j * m_b) % sp
    tw.write_scalar(int(F.to_ints(a)[0]))
    tw.write_scalar(rho)


def _read_opening(tr, n: int):
    """Read one opening off the transcript -> (us, lrs, a0, rho_f)."""
    k = n.bit_length() - 1
    us: List[int] = []
    lrs: List[Tuple] = []
    for _ in range(k):
        L = tr.read_point()
        R = tr.read_point()
        lrs.append((L, R))
        us.append(tr.squeeze_challenge())
    return us, lrs, tr.read_scalar(), tr.read_scalar()


def _s_vector(us: Sequence[int], p: int = PFR.p) -> List[int]:
    """The s vector by fold expansion, a copy of the reference's: round j
    consumes original-index bit k−1−j, so the rounds go in reverse. O(n)
    host products."""
    s = [1]
    for u_j in reversed(us):
        ui = pow(u_j, -1, p)
        s = s + [t * ui % p for t in s]
    return s


def _g0s(params: ParamsIPA, cfg: _CurveCfg, uss, n: int) -> list:
    """G₀ = ⟨s, G⟩ of each opening's challenges, as affine ints: the s
    vectors on the host, one batched MSM on the params' device."""
    svs = torch.from_numpy(np.stack([
        ints_to_limbs(_s_vector(us, cfg.sp)).view(np.int32)
        for us in uss])).to(params.device)
    return cfg.dev.to_affine_ints(_msm(cfg, params.g[:n], svs))


def _check_opening(params: ParamsIPA, commitment, x: int, v: int, n: int,
                   us, lrs, a0: int, rho_f: int, g0) -> bool:
    """The O(log n) host-side tail of one opening check (g0 = ⟨s, G⟩)."""
    cfg = _cfg(params)
    p = cfg.sp
    b0 = 1
    for j, u_j in enumerate(us):
        b0 = b0 * (1 + pow(u_j, -1, p) * pow(x, n >> (j + 1), p)) % p
    g1 = cfg.pg
    lhs = g1.add(g1.add(g1.mul(g0, a0), g1.mul(params.u, a0 * b0 % p)),
                 g1.mul(params.h, rho_f))
    rhs = g1.add(commitment, g1.mul(params.u, v % p))
    for (L, R), u_j in zip(lrs, us):
        rhs = g1.add(rhs, g1.mul(L, pow(u_j, -1, p)))
        rhs = g1.add(rhs, g1.mul(R, u_j))
    return lhs == rhs


def verify_poly(params: ParamsIPA, commitment, x: int, v: int, tr,
                n: Optional[int] = None) -> bool:
    """Replay one opening: one n-point MSM and O(log n) group operations.
    A malformed opening is rejected (False), never raised on."""
    cfg = _cfg(params)
    n = n or params.n
    try:
        us, lrs, a0, rho_f = _read_opening(tr, n)
    except ValueError:
        return False
    g0 = _g0s(params, cfg, [us], n)[0]
    return _check_opening(params, commitment, x, v, n, us, lrs, a0, rho_f,
                          g0)


# ---------------------------------------------------------------------------
# multiopen: batch (poly, point, eval) claims, one opening per point
# ---------------------------------------------------------------------------

@dataclass
class IPAClaim:
    """One opening claim against a committed polynomial."""

    point: int
    value: int
    coeffs_mont: object = None          # prover: (n, 8) tensor
    blind: int = 0                      # prover
    commitment: object = None           # verifier: affine ints


def _by_point(claims) -> dict:
    by_pt: dict = {}
    for cl in claims:
        by_pt.setdefault(cl.point, []).append(cl)
    return by_pt


def open_claims(params: ParamsIPA, claims: Sequence[IPAClaim], tw,
                rng=None) -> None:
    """Group the claims by point, combine each group with powers of one
    Fiat–Shamir challenge q and write one opening per distinct point
    (``ipa.py:453-485``)."""
    cfg = _cfg(params)
    F, sp = cfg.SF, cfg.sp
    q = tw.squeeze_challenge()
    by_pt = _by_point(claims)
    for x in sorted(by_pt):
        group = by_pt[x]
        acc = group[0].coeffs_mont
        vv, rr, qp = group[0].value, group[0].blind, 1
        for cl in group[1:]:
            qp = qp * q % sp
            acc = F.add(acc, F.mul(F.from_ints(qp, acc.device),
                                   cl.coeffs_mont))
            vv = (vv + qp * cl.value) % sp
            rr = (rr + qp * cl.blind) % sp
        open_poly(params, acc, rr, x, vv, tw, rng=rng)


def verify_claims(params: ParamsIPA, claims: Sequence[IPAClaim], tr,
                  n: Optional[int] = None) -> bool:
    """All per-point openings replayed, then their ⟨s, G⟩ in one batched
    MSM (``ipa.py:488-541``). A malformed proof is rejected."""
    cfg = _cfg(params)
    n = n or params.n
    g1 = cfg.pg
    try:
        q = tr.squeeze_challenge()
        by_pt = _by_point(claims)
        groups = []
        for x in sorted(by_pt):
            group = by_pt[x]
            com, vv, qp = group[0].commitment, group[0].value, 1
            for cl in group[1:]:
                qp = qp * q % cfg.sp
                com = g1.add(com, g1.mul(cl.commitment, qp))
                vv = (vv + qp * cl.value) % cfg.sp
            groups.append((x, com, vv, *_read_opening(tr, n)))
    except ValueError:
        return False
    g0s = _g0s(params, cfg, [grp[3] for grp in groups], n)
    return all(_check_opening(params, com, x, vv, n, us, lrs, a0, rho_f, g0)
               for (x, com, vv, us, lrs, a0, rho_f), g0 in zip(groups, g0s))


# ---------------------------------------------------------------------------
# compressed multiopen: every claim in one opening (the pipeline's, BN254)
# ---------------------------------------------------------------------------

def open_claims_compressed(params: ParamsIPA, dom, claims: List[
        shplonk.Claim], tw, rng=None) -> None:
    """Every (polynomial, points, evaluations) claim in ONE opening, by the
    SHPLONK reduction that the KZG path runs (``ipa.py:544-636``):

      y ← FS    h(X) = Σ y^i (f_i(X) − r_i(X)) / Z_{S_i}(X)
      W = ⟨h, G⟩ + r_h·H → transcript
      z ← FS    L(X) = Σ c_i f_i(X) − const − Z_T(z)·h(X)   (L(z) = 0)
      one opening of L at z with value 0 and blind −Z_T(z)·r_h.

    claims carry their (n, 8) evaluation forms on H (``evals_dev``); h and
    L are made in evaluation form (kernels 1–5) and moved to coefficients
    by one iNTT each (kernels 6, 7). r_h is drawn from `rng` after the
    h-pass, as the reference draws it."""
    cfg = _cfg(params)
    if cfg.name != "bn254":
        raise ValueError("the pipeline's multiopen is BN254's")
    F, p = cfg.SF, cfg.sp
    with span("h_pass"):
        dev = claims[0].evals_dev.device
        roots = pow_table(F, dom.omega, dom.n, dev)
        C = len(claims)
        S = max(len(cl.points) for cl in claims)

        y = tw.squeeze_challenge()
        evs = torch.stack([cl.evals_dev for cl in claims])
        rs = [shplonk._interp(cl.points, cl.evals) for cl in claims]
        rcoef = F.from_ints(
            [[r[j] if j < len(r) else 0 for j in range(S)] for r in rs], dev)
        plimbs = F.from_ints(
            [[cl.points[j] if j < len(cl.points) else 0 for j in range(S)]
             for cl in claims], dev)
        pmask = shplonk.point_mask(claims, S, dev)
        ypows = [1] * C
        for i in range(1, C):
            ypows[i] = ypows[i - 1] * y % p
        h_ev = shplonk._h_pass(evs, rcoef, plimbs, pmask,
                               F.from_ints(ypows, dev), roots)
        h_coeffs = dom.intt(h_ev)
    r_h = _rand_scalar(rng, p)
    tw.write_point(commit(params, h_coeffs, r_h))

    z = tw.squeeze_challenge()
    with span("l_pass"):
        zt_z, cs, const = shplonk._weights(claims, ypows, z)
        l_ev = F.sum(F.mul(F.from_ints(cs, dev)[:, None, :], evs))
        l_ev = F.sub(l_ev, F.from_ints(const, dev))
        l_ev = F.sub(l_ev, F.mul(F.from_ints(zt_z, dev), h_ev))
        l_coeffs = dom.intt(l_ev)
    with span("rounds"):
        open_poly(params, l_coeffs, (-zt_z * r_h) % p, z, 0, tw, rng=rng)


def verify_claims_compressed(params: ParamsIPA, dom,
                             claims: List[shplonk.Claim], tr) -> bool:
    """The verifier of :func:`open_claims_compressed`: C_L from the
    commitments' linearity (host group operations), then one opening
    check (one n-point MSM on the params' device)."""
    cfg = _cfg(params)
    p, g1 = cfg.sp, cfg.pg
    try:
        y = tr.squeeze_challenge()
        w_pt = tr.read_point()
    except ValueError:
        return False
    z = tr.squeeze_challenge()
    ypows = [1] * len(claims)
    for i in range(1, len(claims)):
        ypows[i] = ypows[i - 1] * y % p
    zt_z, cs, const = shplonk._weights(claims, ypows, z)
    acc = None
    for cl, c in zip(claims, cs):
        acc = g1.add(acc, g1.mul(cl.commitment, c))
    g0_pt = cfg.dev.to_affine_ints(params.g[:1])[0]
    c_l = g1.add(acc, g1.neg(g1.mul(g0_pt, const)))
    c_l = g1.add(c_l, g1.neg(g1.mul(w_pt, zt_z)))
    return verify_poly(params, c_l, z, 0, tr, n=dom.n)
