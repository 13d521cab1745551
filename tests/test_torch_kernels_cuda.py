"""Each CUDA kernel of the port against its plain twin, on the card, at
small shapes with edge cases (identity points, doubling, P + (−P), segment
starts across runs and chains, ragged runs and slabs, broadcast
constants). Skips without a CUDA device. On a card
machine without JAX, run it without the suite's conftest:
``PYTHONPATH=. python -m pytest --noconftest tests/test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from zkodst_tpu_torch.kernels import ec, mulmod, ntt
from zkodst_tpu_torch.ops import curve, pycurve
from zkodst_tpu_torch.ops import ntt as ontt
from zkodst_tpu_torch.ops.field import FQ, FR
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


@pytest.mark.parametrize("W,S", [(2048, 4), (96, 7), (1, 5)])
def test_chain_cumprod(dev, W, S):
    x = _elements(FR, W * S, 75)
    _same(mulmod.chain_cumprod(FR, x.to(dev), W),
          mulmod.chain_cumprod_plain(FR, x, W))


@pytest.mark.parametrize("m", [1, 7, 256, 1000, 2048])
def test_cumprod_tile(dev, m):
    x = _elements(FQ, m, 76)
    _same(mulmod.cumprod_tile(FQ, x.to(dev)), mulmod.cumprod_tile_plain(FQ, x))


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


@pytest.mark.parametrize("W", [128, 512])
def test_chain_scan_local(dev, pts, W):
    P, _, f = pts
    _same(ec.chain_scan_local(P.to(dev), f.to(dev), W),
          ec.chain_scan_local_plain(P, f, W))


@pytest.mark.parametrize("n", [8, 256, 1024])
def test_seg_scan_tiles(dev, pts, n):
    P, _, f = pts
    P, f = P[:, :, :n].contiguous(), f[:, :n]
    _same(ec.seg_scan_tiles(P.to(dev), f.to(dev)),
          ec.seg_scan_tiles_plain(P, f))


def test_scale_reduce(dev, pts):
    P, _, _ = pts
    ws = P[:, :, :6].contiguous()
    _same(ec.scale_reduce(ws.to(dev), 13), ec.scale_reduce_plain(ws, 13))


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        ec.ec_add(torch.zeros((1, 24, 4), dtype=torch.int64, device=dev),
                  torch.zeros((1, 24, 4), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        mulmod.mulmod(FR, torch.zeros((4, 7), dtype=torch.int32, device=dev),
                      torch.zeros((4, 7), dtype=torch.int32, device=dev))
