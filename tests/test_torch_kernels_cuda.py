"""Each CUDA kernel of the port against its plain twin, on the card, at
small shapes with edge cases (identity points, doubling, P + (−P), segment
starts across runs, warps, blocks and chains, ragged runs and slabs,
broadcast operands). Skips without a CUDA device. On a card
machine without JAX, run it without the suite's conftest:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from zkodst_tpu_torch.kernels import ec, mulmod, ntt
from zkodst_tpu_torch.ops import curve, pycurve
from zkodst_tpu_torch.ops import ntt as ontt
from zkodst_tpu_torch.ops.field import FQ, FR, PASTA_FP, PASTA_FR
from zkodst_tpu_torch.ops.pyfield import FR as PFR

# several test workers share the host's cores: one intra-op thread each
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda
G, GEN = pycurve.G1, pycurve.G1_GEN


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pts():
    r = np.random.default_rng(71)
    a = [G.mul(GEN, int(k)) for k in r.integers(1, 1 << 30, 1024)]
    a[::97] = [None] * len(a[::97])
    b = [G.mul(GEN, int(k)) for k in r.integers(1, 1 << 30, 1024)]
    b[3], b[4] = a[3], G.neg(a[4])
    flags = r.integers(0, 6, 1024) == 0
    flags[300:700] = False
    P = curve.pack(curve.from_affine_ints(a))
    Q = curve.pack(curve.from_affine_ints(b))
    return P, Q, torch.from_numpy(flags)[None]


def _same(kernel_out, plain_out):
    assert torch.equal(kernel_out.cpu(), plain_out.cpu())


@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_mulmod(dev, F):
    r = np.random.default_rng(72)
    xs = [int.from_bytes(r.bytes(40), "little") % F.p for _ in range(4099)]
    ys = xs[::-1]
    a, b = F.from_ints(xs), F.from_ints(ys)
    _same(mulmod.mulmod(F, a.to(dev), b.to(dev)), mulmod.mulmod_plain(F, a, b))
    c = F.const(F.R2)                           # one broadcast constant
    _same(mulmod.mulmod(F, a.to(dev), c.to(dev)), mulmod.mulmod_plain(F, a, c))


@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_mulmod_edge_values(dev, F):
    """Every pair of 0, 1, p − 1 (and 2, p − 2, R mod p) through the PTX
    carry chains of the product, the sum and the difference."""
    edges = [0, 1, 2, F.p - 2, F.p - 1, F.r % F.p]
    a = F.from_ints([x for x in edges for _ in edges])
    b = F.from_ints([y for _ in edges for y in edges])
    for op in ("mulmod", "addmod", "submod"):
        fn, plain = getattr(mulmod, op), getattr(mulmod, op + "_plain")
        _same(fn(F, a.to(dev), b.to(dev)), plain(F, a, b))


def _elements(F, n, seed):
    r = np.random.default_rng(seed)
    xs = [int.from_bytes(r.bytes(40), "little") % F.p for _ in range(n)]
    xs[:4] = [0, 1, F.p - 1, F.r % F.p]
    return F.from_ints(xs)


@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_addmod(dev, F):
    a, b = _elements(F, 4099, 73), _elements(F, 4099, 74)
    _same(mulmod.addmod(F, a.to(dev), b.to(dev)), mulmod.addmod_plain(F, a, b))
    c = b[5]                                    # one broadcast constant
    _same(mulmod.addmod(F, a.to(dev), c.to(dev)), mulmod.addmod_plain(F, a, c))


@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
def test_submod(dev, F):
    a, b = _elements(F, 4099, 78), _elements(F, 4099, 79)
    _same(mulmod.submod(F, a.to(dev), b.to(dev)), mulmod.submod_plain(F, a, b))
    c = b[5]                                    # a broadcast constant b
    _same(mulmod.submod(F, a.to(dev), c.to(dev)), mulmod.submod_plain(F, a, c))
    one = F.const(F.ONE)                        # a broadcast constant a
    _same(mulmod.submod(F, one.to(dev), a.to(dev)),
          mulmod.submod_plain(F, one, a))
    _same(F.neg(a.to(dev)), F.neg(a))


@pytest.mark.parametrize("op", ["mulmod", "addmod", "submod"])
@pytest.mark.parametrize("layout", ["column", "per_row", "per_run",
                                    "both_const"])
def test_binop_broadcast_layouts(dev, op, layout):
    """A column broadcast over a leading dimension is read with its period;
    a value per row of the leading dimension (taken from a wider table, or
    the carry of each run of S = 257 elements) with a divisor; two
    constants give one element. None of them is copied whole."""
    x = _elements(FR, 3 * 257, 80).reshape(3, 257, 8)
    col = x[0]
    carry = _elements(FR, 6, 82)[:3]
    a, b = {"column": (x, col[None]),
            "per_row": (col[None], x[:, :1]),
            "per_run": (x, carry[:, None, :]),
            "both_const": (x[1, 5], x[2, 7])}[layout]
    fn, plain = getattr(mulmod, op), getattr(mulmod, op + "_plain")
    before = dict(mulmod.OPERAND_COPIES)
    _same(fn(FR, a.to(dev), b.to(dev)), plain(FR, a, b))
    _same(fn(FR, b.to(dev), a.to(dev)), plain(FR, b, a))
    assert mulmod.OPERAND_COPIES == before


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("F", [FR, FQ], ids=["fr", "fq"])
@pytest.mark.parametrize("W,S", [
    (2048, 4), (96, 7), (1, 5),
    (2048, 64),                 # the grand products at 2^17: 16 runs a block
    (4, 2560), (3, 4672),       # keygen's selectors, SHPLONK's inversion
    (5, 1000), (7, 1500),       # a chunk not filled; one and a half chunks
    (2048, 1), (3, 1024)])      # a run an element; exactly one chunk a run
def test_chain_cumprod(dev, F, W, S, reverse):
    x = _elements(F, W * S, 75)
    want = mulmod.chain_cumprod_plain(F, x, W, reverse)
    _same(mulmod.chain_cumprod(F, x.to(dev), W, reverse=reverse), want)
    _same(mulmod.chain_cumprod_plain(F, x.to(dev), W, reverse), want)


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("exclusive", [False, True], ids=["incl", "excl"])
@pytest.mark.parametrize("m,stride,offset", [
    (1, 1, 0), (7, 1, 0), (256, 1, 0), (1000, 1, 0), (2048, 1, 0),
    (2048, 7, 6), (2048, 7, 0),  # run totals of a chain of S = 7, both ways
    (7, 3, 2), (1000, 5, 4), (65, 2, 1)])
def test_cumprod_tile(dev, m, stride, offset, reverse, exclusive):
    x = _elements(FQ, offset + (m - 1) * stride + 1 + stride // 2, 76)
    kw = dict(m=m, stride=stride, offset=offset, reverse=reverse,
              exclusive=exclusive)
    want = mulmod.cumprod_tile_plain(FQ, x, **kw)
    _same(mulmod.cumprod_tile(FQ, x.to(dev), **kw), want)
    _same(mulmod.cumprod_tile_plain(FQ, x.to(dev), **kw), want)  # the twin


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cumprod_tile_cluster_sizes(dev, monkeypatch, cluster):
    """Every cluster size the layout can pick, at the path's m = 2048 (16
    blocks is a non-portable size) and at a ragged m."""
    monkeypatch.setattr(mulmod, "TILE_CLUSTER", cluster)
    assert mulmod.tile_layout(2048)[0] == cluster
    for m in (2048, 1500):
        x = _elements(FR, 3 * m, 77)
        for reverse in (False, True):
            kw = dict(m=m, stride=3, offset=2, reverse=reverse,
                      exclusive=True)
            _same(mulmod.cumprod_tile(FR, x.to(dev), **kw),
                  mulmod.cumprod_tile_plain(FR, x, **kw))


@pytest.mark.parametrize("n", [2048 * 5, 2048 * 5 + 3, 1000])
def test_inv_batch_and_cumprod_incl(dev, n):
    """The prefix and suffix products and inv_batch on the card (kernels
    4, 5 and 1 writing into their buffers) against the plain path."""
    x = _elements(FR, n, 78)
    x[0] = FR.from_ints(5)                      # inv_batch needs nonzero
    xd = x.to(dev)
    for reverse in (False, True):
        _same(FR.cumprod_incl(xd, reverse=reverse),
              FR.cumprod_incl(x, reverse=reverse))
    _same(FR.inv_batch(xd), FR.inv_batch(x))
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    assert FR.mul(xd, xd, out=out) is out
    _same(out, FR.mul(x, x))


@pytest.mark.parametrize("n,T", [(2, 2), (64, 16), (4096, 2048), (4096, 4096)])
def test_ntt_tail_and_head(dev, n, T):
    w = PFR.root_of_unity(n.bit_length() - 1)
    x = _elements(FR, 3 * n, 77).reshape(3, n, 8)
    pw = ontt.powers_table(FR, w, n // 2)
    _same(ntt.ntt_tail(FR, x.to(dev), pw.to(dev), T),
          ntt.ntt_tail_plain(FR, x, pw, T))
    h = T // 2 if T < n else n // 2
    _same(ntt.ntt_head(FR, x.to(dev), pw.to(dev), h),
          ntt.ntt_head_plain(FR, x, pw, h))
    assert torch.equal(ontt.ntt(FR, x.to(dev), w).cpu(),
                       ontt.ntt(FR, x, w))


def test_ec_add(dev, pts):
    P, Q, _ = pts
    _same(ec.ec_add(P.to(dev), Q.to(dev)), ec.ec_add_plain(P, Q))


def test_seg_step(dev, pts):
    P, Q, f = pts
    _same(ec.seg_step(P.to(dev), Q.to(dev), f.to(dev)),
          ec.seg_step_plain(P, Q, f))


# kernel 9's forms on patterns that stress its compaction: the needing
# elements of each 32-element word balloted into a block's list and added
# on all its lanes, kept ones left alone (in place) or moved (out of
# place)
STEP_PATTERNS = ["none", "all", "one_per_word", "word_boundary",
                 "alternate", "quarter", "added_at_24", "listed_at_23"]
STEP_FORMS = ["natural", "natural_in_place", "gathered",
              "gathered_in_place", "chains"]


def _step_needs(pattern, n, rows=2, seed=0):
    """(rows, n) bool: the elements that add."""
    need = torch.zeros((rows, n), dtype=torch.bool)
    if pattern == "all":
        need[:] = True
    elif pattern == "one_per_word":
        for e0 in range(0, n, 32):
            need[:, min(n - 1, e0 + (7 * e0 // 32) % 32)] = True
    elif pattern == "word_boundary":           # and the rows' ends
        for e in (0, 31, 32, 63, 64, n - 1):
            need[:, e] = True
    elif pattern == "alternate":
        need[:, 1::2] = True
    elif pattern in ("added_at_24", "listed_at_23"):
        # kStepDirect = 24 needing lanes of a word add at once; 23 are
        # listed
        k = 24 if pattern == "added_at_24" else 23
        for e0 in range(0, n, 32):
            need[:, e0 + 32 - k:e0 + 32] = True
    elif pattern == "quarter":
        r = np.random.default_rng(seed)
        need = torch.from_numpy(r.random((rows, n)) < 0.25)
    return need


def _step_call(dev, form, pattern, P, Q, C, n=None):
    """(kernel output on `dev`, its twin's on the host) of one form of
    kernel 9 over two rows made of P and Q."""
    n = n or P.shape[2]
    p = torch.cat([P, Q])[:, :, :n].contiguous()
    q = torch.cat([Q, P])[:, :, :n].contiguous()
    if form == "chains":                 # in place, chain-major
        W = 64 if n % 64 == 0 else 8
        S = n // W
        fs = {"none": torch.zeros((2, W), dtype=torch.int64),
              "all": torch.full((2, W), S, dtype=torch.int64),
              "one_per_word": torch.ones((2, W), dtype=torch.int64),
              "word_boundary": torch.tensor([[S, 0] * (W // 2)] * 2),
              "alternate": torch.tensor([[S - 1, 1] * (W // 2)] * 2),
              "quarter": torch.from_numpy(np.random.default_rng(5)
                                          .integers(0, S // 2 + 1, (2, W))),
              # chain-major words of 32 chains at one s: 24 or 23 chains
              # of each 32 still before their first start
              "added_at_24": torch.tensor(([S // 2] * 24 + [0] * 8)
                                          * W)[:2 * W].reshape(2, W),
              "listed_at_23": torch.tensor(([S // 2] * 23 + [0] * 9)
                                           * W)[:2 * W].reshape(2, W),
              }[pattern]
        carry = q[:, :, :W].contiguous()
        pd, pp = p.to(dev).clone(), p.clone()
        out = ec.seg_step(pd, carry.to(dev), fs=fs.to(dev), curve=C, out=pd)
        ref = ec.seg_step_plain(pp, carry, curve=C, fs=fs, out=pp)
        assert out is pd and ref is pp
        return out, ref
    keep = ~_step_needs(pattern, n)
    kw, kwp = {}, {}
    if form.startswith("gathered"):
        m = 96
        idx = torch.from_numpy(np.random.default_rng(6).integers(0, m,
                                                                 (2, n)))
        q = q[:, :, :m].contiguous()
        kw["q_index"], kwp["q_index"] = idx.to(dev), idx
    pd, pp = p.to(dev), p.clone()
    if form.endswith("in_place"):
        kw["out"], kwp["out"] = pd, pp
    out = ec.seg_step(pd, q.to(dev), keep.to(dev), C, **kw)
    ref = ec.seg_step_plain(pp, q, keep, C, **kwp)
    if form.endswith("in_place"):
        assert out is pd and ref is pp
    return out, ref


@pytest.mark.parametrize("pattern", STEP_PATTERNS)
@pytest.mark.parametrize("form", STEP_FORMS)
@pytest.mark.parametrize("on", ["bn254", "pallas"])
def test_seg_step_forms(dev, pts, pallas_pts, form, pattern, on):
    """Each form of kernel 9 on each pattern and curve, equal to its twin
    limb for limb, one launch counted on its curve."""
    from zkodst_tpu_torch import kernels

    C = curve.PASTA if on == "pallas" else curve.BN254
    P, Q, _ = pallas_pts if on == "pallas" else pts
    kernels.reset_counts()
    out, ref = _step_call(dev, form, pattern, P, Q, C)
    _same(out, ref)
    counted = (kernels.pasta_counts()["seg_step[pallas]"] if on == "pallas"
               else kernels.counts()["seg_step"])
    assert counted == 1


@pytest.mark.parametrize("form", STEP_FORMS)
@pytest.mark.parametrize("n,tile", [(1000, 0), (998, 0), (1024, 32),
                                    (998, 96), (1000, 2048), (1024, 64)])
def test_seg_step_ragged_and_tiles(dev, pts, monkeypatch, form, n, tile):
    """Rows that end inside a word and inside a tile (n % 32 ≠ 0; tiles
    run across rows), the least and the largest tile and a few between,
    besides the one-wave tile the wrapper leaves to the kernel: each form
    on a quarter of adds."""
    monkeypatch.setattr(ec, "SEG_TILE", tile)
    P, Q, _ = pts
    if form == "chains" and n % 8:
        n = 1000                      # chains need n % W == 0 (W = 8)
    out, ref = _step_call(dev, form, "quarter", P, Q, curve.BN254, n)
    _same(out, ref)


@pytest.mark.parametrize("W", [128, 512])
def test_chain_scan_local(dev, pts, W):
    P, _, f = pts
    _same(ec.chain_scan_local(P.to(dev), f.to(dev), W),
          ec.chain_scan_local_plain(P, f, W))


def _chain_aggregates(P):
    """The MSM's largest call, (80, 24, 2048): sparse starts, long stretches
    with none, and starts at multiples of 8, 256 and 512 lanes (thread,
    warp and block boundaries of the kernel's layouts)."""
    r = np.random.default_rng(83)
    idx = torch.from_numpy(r.integers(0, 1024, (80, 2048)))
    Pn = P[0][:, idx].permute(1, 0, 2).contiguous()
    fn = torch.from_numpy(r.integers(0, 9, (80, 2048)) == 0)
    fn[:, 300:900] = False
    fn[::3, 512::512] = True
    fn[1::3, 256::256] = True
    thr = fn[2::3, 8::8]
    fn[2::3, 8::8] = thr | torch.from_numpy(r.integers(0, 2, thr.shape) == 0)
    return Pn, fn


@pytest.mark.parametrize("n", [8, 16, 256, 1024, 2048])
def test_seg_scan_tiles(dev, pts, n):
    P, _, f = pts
    if n == 2048:
        P, f = _chain_aggregates(P)
    else:
        P, f = P[:, :, :n].contiguous(), f[:, :n]
    _same(ec.seg_scan_tiles(P.to(dev), f.to(dev)),
          ec.seg_scan_tiles_plain(P, f))


def test_scale_reduce(dev, pts):
    P, _, _ = pts
    ws = P[:, :, :6].contiguous()
    _same(ec.scale_reduce(ws.to(dev), 13), ec.scale_reduce_plain(ws, 13))


@pytest.mark.parametrize("batch,nlive,c", [(14, 64, 4), (4, 20, 13)])
def test_scale_reduce_path_shapes(dev, pts, batch, nlive, c):
    """The MSM's two combine shapes on the flagship path, with identity
    windows (P[:, :, ::97] are identities; window 0 of row 0 is one)."""
    P, _, _ = pts
    ws = P[0, :, :batch * nlive].reshape(24, batch, nlive) \
        .transpose(0, 1).contiguous()
    assert bool((ws[:, 16:] == 0).all(dim=1).any())
    _same(ec.scale_reduce(ws.to(dev), c), ec.scale_reduce_plain(ws, c))


def test_chain_scan_local_w2048(dev, pts):
    """W = 2048 chains of S = 4 elements, as on the flagship path: flags at
    some chain heads, none at the others (a run that began in the chain
    before: the kernel restarts there all the same), and 500 chains whose
    last two elements carry no flag."""
    P, _, f = pts
    n, W = 8192, 2048
    perm = torch.from_numpy(np.random.default_rng(81).permutation(n) % 1024)
    Pn = P[:, :, perm].contiguous()
    fn = f[:, perm].clone()
    fn[:, :W:7] = True                          # flags at chain heads
    fn[:, 2 * W + 100:2 * W + 600] = False
    fn[:, 3 * W + 100:3 * W + 600] = False
    _same(ec.chain_scan_local(Pn.to(dev), fn.to(dev), W),
          ec.chain_scan_local_plain(Pn, fn, W))


def _table(P, Q, n, dev):
    """(n, 3, 8) distinct points on the card: P[i % m] + Q[i // m % m] of
    two packed (1, 24, m) rows (kernel 8)."""
    m = P.shape[2]
    i = torch.arange(n)
    s = ec.ec_add(P[:, :, i % m].contiguous().to(dev),
                  Q[:, :, i // m % m].contiguous().to(dev))
    return curve.unpack(s)[0]


def _sorted_rows(n, rows, c, dev, seed, zero=slice(0, 0)):
    """Digits of random scalars drawn as c-bit windows and sorted as
    msm_many sorts them: the given window rows' (sidx, starts). The
    scalars at `zero` are 0."""
    from zkodst_tpu_torch.ops import msm

    r = np.random.default_rng(seed)
    sc = torch.from_numpy(r.integers(0, 1 << 32, (1, n, 8), dtype=np.uint64)
                          .astype(np.int64))
    sc[..., 7] &= (1 << 29) - 1                 # 253 bits
    sc[:, zero] = 0
    nwin = -(-254 // c)
    skeys, sidx = msm._sort_windows(sc.to(dev), c, nwin)
    skeys, sidx = skeys[rows].contiguous(), sidx[rows].contiguous()
    return sidx, msm._starts(skeys)


GATHER_CASES = ["bn254_w2048", "small_w", "ragged", "pallas"]


@pytest.mark.parametrize("case", GATHER_CASES)
def test_chain_scan_gathered(dev, pts, pallas_pts, case):
    """Kernel 11's gathered form against its twin limb for limb, one launch
    counted among its wrapper's:
    - BN254 at W = 2048 over 2^17 points, four c = 13 windows (the top one
      among them: 7 bits, long segments across chains) sorted as msm_many
      sorts them, a tenth of the scalars zero;
    - a small W (8 chains of 128) over a random permutation;
    - a ragged N = 1000 padded with identities to 1024 as msm_many pads
      it, c = 9 windows, W = 512 chains of 2;
    - the pallas instance over a random permutation (W = 128)."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.ops import msm

    C = curve.PASTA if case == "pallas" else curve.BN254
    P, Q, f = pallas_pts if case == "pallas" else pts
    if case == "bn254_w2048":
        n, W = 1 << 17, 2048
        table = _table(P, Q, n, dev)
        index, f = _sorted_rows(n, [0, 1, 10, 19], 13, dev, 87,
                                zero=slice(0, n // 10))
    elif case == "ragged":
        N, n = 1000, 1024
        table = torch.cat([_table(P, Q, N, dev), C.identity((n - N,), dev)])
        W = msm._chain_w(n)
        index, f = _sorted_rows(n, [0, 5, 28], 9, dev, 88,
                                zero=slice(N, n))
        assert (W, n // W) == (512, 2)
    else:
        n = P.shape[2]
        W = 8 if case == "small_w" else 128
        table = curve.unpack(P)[0].to(dev)
        index = torch.from_numpy(np.random.default_rng(86).permutation(n))
        index, f = index[None].to(dev), f.to(dev)
    kernels.reset_counts()
    got = ec.chain_scan_local(table, f, W, curve=C, index=index)
    launched = (kernels.pasta_counts()["chain_scan_local[pallas]"]
                if case == "pallas" else kernels.counts()["chain_scan_local"])
    assert launched == 1
    _same(got, ec.chain_scan_local_plain(table, f, W, C, index=index))


def test_msm_windows_take_the_gathered_form(dev, pts, monkeypatch):
    """Every window pass of a BN254 msm_many on the card runs kernel 11
    gathered (a call with an index, seen by a spy where the MSM looks the
    wrapper up); the dense form runs only in the Σ d·B_d scans. Every call
    is one launch. The MSM equals the same call on the twins."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.ops import msm

    P, Q, _ = pts
    n = 4096
    table = _table(P, Q, n, dev)
    r = np.random.default_rng(89)
    sc = torch.from_numpy(r.integers(0, 1 << 32, (1, n, 8), dtype=np.uint64)
                          .astype(np.int64))
    sc[..., 7] &= (1 << 29) - 1
    sc = sc.to(torch.int32)
    calls, scans = [], []
    windows, scan = msm._windows, msm.chain_scan_local
    monkeypatch.setattr(msm, "_windows",
                        lambda *a: calls.append(1) or windows(*a))

    def spy(*a, index=None, **kw):
        scans.append(index is not None)
        return scan(*a, index=index, **kw)
    monkeypatch.setattr(msm, "chain_scan_local", spy)
    kernels.reset_counts()
    got = msm.msm_many(table, sc.to(dev), 13)
    assert sum(scans) == len(calls) == 1
    assert len(scans) > sum(scans)                          # Σ d·B_d
    assert kernels.counts()["chain_scan_local"] == len(scans)
    _same(got, msm.msm_many(table.cpu(), sc, 13))


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        ec.ec_add(torch.zeros((1, 24, 4), dtype=torch.int64, device=dev),
                  torch.zeros((1, 24, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        mulmod.mulmod(FR, torch.zeros((4, 7), dtype=torch.int32, device=dev),
                      torch.zeros((4, 7), dtype=torch.int32, device=dev))
    x = torch.zeros((48, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):              # a stride past the tensor
        mulmod.cumprod_tile(FR, x, 7, stride=8, offset=0)
    with pytest.raises(ValueError):              # more than one call holds
        mulmod.cumprod_tile(FR, torch.zeros((4096, 8), dtype=torch.int32,
                                            device=dev))
    with pytest.raises(ValueError):              # an out of the wrong shape
        mulmod.mulmod(FR, x, x, out=torch.empty((47, 8), dtype=torch.int32,
                                                device=dev))


# -- the Pasta instantiations (kernels 1–3 on both Pasta fields, kernel 8 on
# pallas) --------------------------------------------------------------------

@pytest.mark.parametrize("op", ["mulmod", "addmod", "submod"])
@pytest.mark.parametrize("F", [PASTA_FP, PASTA_FR],
                         ids=["pasta_fp", "pasta_fr"])
def test_pasta_binops(dev, F, op):
    """Random values and the edges 0, 1, p − 1, p − 2, 2^255 mod p and R
    mod p, elementwise and against a broadcast constant; each launch is
    counted as its Pasta instantiation."""
    from zkodst_tpu_torch import kernels

    r = np.random.default_rng(81)
    edges = [0, 1, F.p - 1, F.p - 2, (1 << 255) % F.p, F.r]
    xs = [int.from_bytes(r.bytes(40), "little") % F.p for _ in range(2051)]
    xs += [e for e in edges for _ in edges]
    ys = xs[::-1][:2051] + edges * len(edges)
    a, b = F.from_ints(xs), F.from_ints(ys)
    fn, plain = getattr(mulmod, op), getattr(mulmod, op + "_plain")
    kernels.reset_counts()
    _same(fn(F, a.to(dev), b.to(dev)), plain(F, a, b))
    c = F.const(F.R2)
    _same(fn(F, a.to(dev), c.to(dev)), plain(F, a, c))
    assert kernels.pasta_counts()[f"{op}[{F.name}]"] == 2
    assert kernels.counts()[op] == 0


def test_pasta_ec_add(dev):
    """pallas points with the identity on either side, P + P and
    P + (−P), with Z ≠ 1, against the twin limb for limb."""
    from zkodst_tpu_torch import kernels

    G, GEN = pycurve.PASTA_G1, pycurve.PASTA_G1_GEN
    C = curve.PASTA
    r = np.random.default_rng(82)
    a = [G.mul(GEN, int(k)) for k in r.integers(1, 1 << 30, 300)]
    b = [G.mul(GEN, int(k)) for k in r.integers(1, 1 << 30, 300)]
    a[::37] = [None] * len(a[::37])
    b[5], b[6], b[7] = a[5], G.neg(a[6]), None
    P = curve.pack(C.add(C.from_affine_ints(a),
                         C.from_affine_ints([GEN] * len(a))))
    Q = curve.pack(C.from_affine_ints(b))
    kernels.reset_counts()
    _same(ec.ec_add(P.to(dev), Q.to(dev), C), ec.ec_add_plain(P, Q, C))
    assert kernels.pasta_counts()["ec_add[pallas]"] == 1
    assert kernels.counts()["ec_add"] == 0


@pytest.fixture(scope="module")
def pallas_pts():
    """pallas points with Z ≠ 1 and identities, a second row with P + P and
    P + (−P) against the first, and sparse starts with a stretch of none."""
    G, GEN = pycurve.PASTA_G1, pycurve.PASTA_G1_GEN
    C = curve.PASTA
    r = np.random.default_rng(84)
    a = [G.mul(GEN, int(k)) for k in r.integers(1, 1 << 30, 1024)]
    a[::41] = [None] * len(a[::41])
    b = [G.mul(GEN, int(k)) for k in r.integers(1, 1 << 30, 1024)]
    b[3], b[4] = a[3], G.neg(a[4])
    flags = r.integers(0, 6, 1024) == 0
    flags[300:700] = False
    P = curve.pack(C.add(C.from_affine_ints(a),
                         C.from_affine_ints([GEN] * len(a))))
    Q = curve.pack(C.from_affine_ints(b))
    return P, Q, torch.from_numpy(flags)[None]


@pytest.mark.parametrize("kernel", ["seg_step", "chain_scan_local",
                                    "seg_scan_tiles", "scale_reduce"])
def test_pallas_scan_kernels(dev, pallas_pts, kernel):
    """Kernels 9–12 on pallas against their twins limb for limb (the
    tile scan at the path's widest row, 2048 lanes, too); each launch is
    counted as its Pasta instantiation, none as BN254's."""
    from zkodst_tpu_torch import kernels

    P, Q, f = pallas_pts
    C = curve.PASTA
    kernels.reset_counts()
    if kernel == "seg_step":
        _same(ec.seg_step(P.to(dev), Q.to(dev), f.to(dev), curve=C),
              ec.seg_step_plain(P, Q, f, C))
    elif kernel == "chain_scan_local":
        _same(ec.chain_scan_local(P.to(dev), f.to(dev), 128, curve=C),
              ec.chain_scan_local_plain(P, f, 128, C))
    elif kernel == "seg_scan_tiles":
        for Pn, fn in ((P[:, :, :256].contiguous(), f[:, :256]),
                       _chain_aggregates(P)):
            _same(ec.seg_scan_tiles(Pn.to(dev), fn.to(dev), curve=C),
                  ec.seg_scan_tiles_plain(Pn, fn, C))
    else:
        ws = P[0, :, :4 * 20].reshape(24, 4, 20).transpose(0, 1).contiguous()
        _same(ec.scale_reduce(ws.to(dev), 13, curve=C),
              ec.scale_reduce_plain(ws, 13, C))
    pasta = kernels.pasta_counts()
    assert pasta[f"{kernel}[pallas]"] == (2 if kernel == "seg_scan_tiles"
                                          else 1)
    assert kernels.counts()[kernel] == 0


def test_pallas_msm_on_the_card(dev):
    """msm_many on pallas (255-bit scalars, p − 1 and 2^254 among them) on
    the card against the same call on the twins, limb for limb, and
    against the host sum."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.ops import msm
    from zkodst_tpu_torch.ops.field import ints_to_limbs
    from zkodst_tpu_torch.ops.pyfield import VESTA_BASE

    G, GEN = pycurve.PASTA_G1, pycurve.PASTA_G1_GEN
    C = curve.PASTA
    r = np.random.default_rng(85)
    pts = [G.mul(GEN, int(k)) for k in r.integers(1, 1 << 30, 300)]
    rows = [[int.from_bytes(r.bytes(32), "little") % VESTA_BASE
             for _ in pts], [[0, 1, 1 << 254, VESTA_BASE - 1][i % 4]
                             for i in range(len(pts))]]
    P = C.from_affine_ints(pts)
    S = PASTA_FR.const(ints_to_limbs(rows))
    kernels.reset_counts()
    got = msm.msm_many(P.to(dev), S.to(dev), 13, curve=C)
    launched = kernels.pasta_counts()
    assert all(launched[f"{k}[pallas]"] for k in (
        "seg_step", "chain_scan_local", "seg_scan_tiles", "scale_reduce"))
    assert not any(kernels.counts().values())
    _same(got, msm.msm_many(P, S, 13, curve=C))
    want = [None, None]
    for b, row in enumerate(rows):
        for p, k in zip(pts, row):
            want[b] = G.add(want[b], G.mul(p, k))
    assert C.to_affine_ints(got.cpu()) == want


def test_ec_kernels_refuse_an_unknown_curve(dev):
    from zkodst_tpu_torch.kernels.build import call

    x = torch.zeros((1, 24, 4), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="cudaError"):
        call("ec", "zk_seg_step", x.data_ptr(), x.data_ptr(), x.data_ptr(),
             None, None, x.data_ptr(), 1, 4, 4, 0, 0, 2)


def test_bn254_kernels_refuse_pasta_fields(dev):
    x = torch.zeros((4096, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="BN254"):
        mulmod.chain_cumprod(PASTA_FR, x, 2048)
    with pytest.raises(ValueError, match="BN254"):
        mulmod.cumprod_tile(PASTA_FR, x[:64])
    with pytest.raises(RuntimeError, match="cudaError"):
        ntt.ntt_head(PASTA_FR, x[None], x[:2048], 1024)


# -- kernels 13 and 14: the BLAKE2f witness stream and compression -----------

def _b2_words(r, shape):
    return torch.from_numpy(r.integers(0, 1 << 32, shape + (2,),
                                       dtype=np.int64))


@pytest.mark.parametrize("rounds", [0, 1, 2, 12])
@pytest.mark.parametrize("B", [1, 5, 37])
def test_blake2f_witness(dev, B, rounds):
    """Every cell and h' against the plain stream: a block's four warps
    partly filled (B = 1, 5) and the flagship's 37 instances, f mixed."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.kernels import blake2 as kb

    r = np.random.default_rng(90 + B + rounds)
    h, m, t = (_b2_words(r, (B, n)) for n in (8, 16, 2))
    f = torch.from_numpy(r.integers(0, 2, B).astype(np.int64))
    kernels.reset_counts()
    stream, out = kb.blake2f_witness(h.to(dev), m.to(dev), t.to(dev),
                                     f.to(dev), rounds)
    assert kernels.blake2f_counts()["blake2f_witness"] == 1
    want, wout = kb.blake2f_witness_plain(h, m, t, f, rounds)
    _same(stream, want)
    _same(out, wout)


def _b2_plan(rounds, device):
    from zkodst_tpu_torch.circuit import blake2f as bc

    lay = bc._Layout()
    bc._schedule(lay, rounds)
    return bc._placement(lay, 1 << 17, device)


@pytest.mark.parametrize("B,rounds", [(1, 0), (2, 1), (5, 2), (37, 12)])
def test_blake2f_advice(dev, B, rounds):
    """The whole advice and instance columns against the plain stream and
    scatter on the card, f mixed: one launch."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.kernels import blake2 as kb

    r = np.random.default_rng(140 + B + rounds)
    h, m, t = (_b2_words(r, (B, n)).to(dev) for n in (8, 16, 2))
    f = torch.from_numpy(r.integers(0, 2, B).astype(np.int64)).to(dev)
    plan = _b2_plan(rounds, dev)
    kernels.reset_counts()
    cols = kb.blake2f_advice(h, m, t, f, rounds, plan)
    assert kernels.blake2f_counts()["blake2f_advice"] == 1
    _same(cols, kb.blake2f_advice_plain(h, m, t, f, rounds, plan))


def test_blake2f_circuit_witness_on_the_card(dev):
    """Blake2fCircuit.witness on the card equals it on the CPU, column for
    column, through one launch of the advice kernel."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.circuit import blake2f as bc

    r = np.random.default_rng(150)
    h, m, t = (r.integers(0, 1 << 32, (3, n, 2), dtype=np.uint32)
               for n in (8, 16, 2))
    f = np.array([True, False, True])
    kernels.reset_counts()
    adv, inst = bc.Blake2fCircuit(k=17, n_inst=3, rounds=2,
                                  device=dev).witness(h, m, t, f)
    assert kernels.blake2f_counts()["blake2f_advice"] == 1
    want, winst = bc.Blake2fCircuit(k=17, n_inst=3, rounds=2,
                                    device="cpu").witness(h, m, t, f)
    assert list(adv) == list(want)
    for col in want:
        _same(adv[col], want[col])
    _same(inst["pub"], winst["pub"])


@pytest.mark.parametrize("rounds", [0, 1, 10, 12, 21])
@pytest.mark.parametrize("n", [1, 129, 8192])
def test_blake2f_compress(dev, n, rounds):
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.kernels import blake2 as kb

    r = np.random.default_rng(120 + n + rounds)
    h, m, t = (_b2_words(r, (n, k)) for k in (8, 16, 2))
    f = torch.from_numpy(r.integers(0, 2, n).astype(bool))
    kernels.reset_counts()
    got = kb.blake2f_compress(h.to(dev), m.to(dev), t.to(dev), f.to(dev),
                              rounds)
    assert kernels.blake2f_counts()["blake2f_compress"] == 1
    _same(got, kb.blake2f_compress_plain(h, m, t, f, rounds))


def test_blake2f_compress_broadcast_and_types(dev):
    """Leading axes broadcast (h a stride-0 view, one t for a (3, 4) batch
    of messages), int32 halves and int64 flags, as the plain version takes
    them."""
    from zkodst_tpu_torch.kernels import blake2 as kb
    from zkodst_tpu_torch.ops import blake2 as ob
    from zkodst_tpu_torch.ops import u64

    r = np.random.default_rng(130)
    v = ob.EIP152_VECTOR
    h = torch.from_numpy(u64.from_ints(v["h"]).astype(np.int64)).expand(
        3, 4, 8, 2)
    m = torch.from_numpy(r.integers(0, 1 << 31, (3, 4, 16, 2),
                                    dtype=np.int32))    # int32 holds < 2^31
    t = torch.from_numpy(u64.from_ints(v["t"]).astype(np.int64))
    f = torch.tensor([[0, 1, 2, 0]] * 3)
    got = kb.blake2f_compress(h.to(dev), m.to(dev), t.to(dev), f.to(dev))
    assert got.shape == (3, 4, 8, 2) and got.dtype == torch.int64
    _same(got, kb.blake2f_compress_plain(h, m, t, f))


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int32,
                                   torch.int64, torch.float32])
def test_blake2f_compress_flag_types(dev, dtype):
    """Flags of each type go to the kernel as they are (a float is cast to
    bool first)."""
    from zkodst_tpu_torch.kernels import blake2 as kb

    r = np.random.default_rng(160)
    h, m, t = (_b2_words(r, (70, k)) for k in (8, 16, 2))
    f = torch.from_numpy(r.integers(0, 3, 70)).to(dtype)
    got = kb.blake2f_compress(h.to(dev), m.to(dev), t.to(dev), f.to(dev))
    _same(got, kb.blake2f_compress_plain(h, m, t, f))


def test_blake2f_wrappers_reject_bad_input(dev):
    from zkodst_tpu_torch.kernels import blake2 as kb

    z = {n: torch.zeros((2, n, 2), dtype=torch.int64, device=dev)
         for n in (8, 16, 2)}
    f = torch.zeros((2,), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        kb.blake2f_witness(z[8], z[16], z[2], f.cpu(), 12)
    with pytest.raises(ValueError):
        kb.blake2f_witness(z[8].to(torch.int32), z[16], z[2], f, 12)
    with pytest.raises(ValueError):
        kb.blake2f_compress(z[8], z[16], z[2], f, -1)
    with pytest.raises(ValueError):       # the placement on the host
        kb.blake2f_advice(z[8], z[16], z[2], f, 1, _b2_plan(1, "cpu"))


# -- kernel 15: the quotient's tape at every row of the coset -----------------

@pytest.fixture(scope="module")
def blake2f_vk():
    from zkodst_tpu_torch.circuit.blake2f import Blake2fCircuit
    from zkodst_tpu_torch.proof import keygen

    circ = Blake2fCircuit(k=17, device="cpu").circ
    return keygen.VerifyingKey(circ.k, {}, [], keygen.perm_columns(circ),
                               circ)


@pytest.mark.parametrize("n", [64, 1024])
def test_quotient(dev, blake2f_vk, n):
    """The BLAKE2f circuit's tape over a coset of 4n rows, at random
    columns with 0, 1, p − 1 and R mod p in their first rows, equals the
    plain twin bit for bit. Its rotations −1, +1 and usable_rows read
    across the end of the coset (at 4n rows usable_rows·4 wraps too); one
    launch a call."""
    from zkodst_tpu_torch import kernels
    from zkodst_tpu_torch.kernels import quotient as kq
    from zkodst_tpu_torch.proof import prover

    tape = prover.compile_quotient(blake2f_vk, n)
    rows = 4 * n
    u = blake2f_vk.circ.usable_rows
    shifts = {s for _, s in tape.inputs}
    assert {rows - 4, 4, 4 * u % rows} <= shifts and 4 * u > rows
    cols = [_elements(FR, rows, 300 + i) for i in range(len(tape.columns))]
    r = np.random.default_rng(301)
    chal = [int.from_bytes(r.bytes(40), "little") % FR.p for _ in range(4)]
    kernels.reset_counts()
    got = kq.quotient(FR, tape, [c.to(dev) for c in cols], chal)
    torch.cuda.synchronize()
    assert kernels.quotient_counts() == {"quotient": 1}
    assert sum(kernels.counts().values()) == 0
    _same(got, kq.quotient_plain(FR, tape, cols, chal))
