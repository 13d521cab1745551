"""Kernels 8–12: G1 kernels on packed points (CUDA source
``cuda/csrc/ec.cu``), each beside its plain PyTorch twin. Each takes
``curve``: BN254 (the default) or the Pasta pallas curve, whose launches
count apart as ``zk_ec_add[pallas]``, ``zk_seg_step[pallas]``,
``zk_chain_scan[pallas]``, ``zk_seg_scan_tiles[pallas]`` and
``zk_scale_reduce[pallas]``.

Packed points are ``(batch, 24, n)`` int32 (see :mod:`..ops.curve`), flags
``(batch, n)`` bool. The twins repeat the kernels' association of
additions and doublings, so kernel and twin agree limb for limb.

=====================  ===============================================
wrapper                replaces (``zkodst_tpu/pallas/ec.py``)
=====================  ===============================================
``ec_add``             ``_ec_add_kernel`` (via ``ec_add_t``)
``seg_step``           ``_seg_step_kernel`` (via ``seg_step_t``)
``seg_scan_tiles``     ``_seg_scan_tile_kernel`` (via ``seg_scan_tiles``)
``chain_scan_local``   ``_chain_scan_kernel`` (via ``chain_scan_local``)
``scale_reduce``       ``_scale_reduce_kernel`` (via ``scale_reduce``)
=====================  ===============================================

Two outputs of the TPU kernels have no consumer on the MSM path and are
not produced here: the saturated flag rows of ``_seg_step_kernel`` and
``_seg_scan_tile_kernel`` (the MSM derives its own segment flags).
``scale_reduce`` takes the ``nlive`` window sums directly instead of a
128-lane block padded with identities, and combines them by Horner with
the complete doubling (``dbl_limbs``), the JAX msm's own association.
``seg_step`` takes its callers' indexing (a carry a chain read through an
index, or a chain's first start; chain-major elements) and may write in
place, so that its callers make nothing at full size to call it; its
twin materialises those inputs and computes the reference's step.
``chain_scan_local`` likewise takes the MSM windows' points as a table
read through each row's sorted point indices (its gathered form); its
twin gathers them explicitly and runs the dense form's association.
"""

from __future__ import annotations

import torch

from ..ops.curve import BN254, Curve, add_limbs, dbl_limbs, lanes64, pack
from ..ops.field import to_i32
from .build import call

# seg_scan_tiles: each thread of the scan owns `run` consecutive lanes of a
# row and SCAN_LANES lanes of the card (which split each add's products:
# the kernel's kScanLanes), so 32 / SCAN_LANES threads of the scan make a
# warp. run is the least power of two that leaves a row at most
# SCAN_ROW_THREADS threads and the call at most SCAN_CALL_THREADS (about
# what the card keeps resident), capped at SCAN_MAX_RUN; the twin repeats
# the kernel's association for that run and warp width. A row's warps are
# spread over a cluster of blocks of at most SCAN_BLOCK threads.
SCAN_ROW_THREADS = 256
SCAN_CALL_THREADS = 16384
SCAN_MAX_RUN = 16
SCAN_LANES = 2
SCAN_BLOCK = 128
# seg_step: a block lists the elements of its tile that need an add and
# runs those adds on all its lanes; SEG_TILE elements a block (a multiple
# of 32, ≤ 2048), or 0: the kernel's choice for the form (a block a round
# in the chains form, one wave of blocks in the others)
SEG_TILE = 0


def _packed(y: torch.Tensor) -> torch.Tensor:
    """(batch, n, 3, 8) int64 limb values -> (batch, 24, n) int32."""
    return to_i32(y.reshape(y.shape[0], y.shape[1], 24)
                  .transpose(1, 2)).contiguous()


def _check_points(*xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.int32 or x.dim() != 3 or x.shape[1] != 24:
            raise ValueError(f"packed points must be (batch, 24, n) int32, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != xs[0].device:
            raise ValueError("operands on different devices")


def _flags(f: torch.Tensor, B: int, n: int, device) -> torch.Tensor:
    """(B, n) flags as a byte of 0 or 1 each on `device`."""
    if f.shape != (B, n):
        raise ValueError(f"flags {tuple(f.shape)} do not match ({B}, {n})")
    if f.dtype == torch.bool and f.device == device:
        return f.contiguous()           # a byte of 0 or 1 a flag as it is
    return f.to(device=device, dtype=torch.uint8).contiguous()


def _tag(curve: Curve):
    """The launch count's tag of a curve's instance (None for BN254's)."""
    return None if curve.kernel_id == 0 else curve.name


# -- kernel 8: o = p + q ----------------------------------------------------

def ec_add_plain(p, q, curve: Curve = BN254):
    return _packed(add_limbs(lanes64(p), lanes64(q), curve))


def ec_add(p: torch.Tensor, q: torch.Tensor,
           curve: Curve = BN254) -> torch.Tensor:
    """p + q on `curve` (BN254 G1 or Pasta pallas)."""
    _check_points(p, q)
    if p.shape != q.shape:
        raise ValueError(f"ec_add shapes {tuple(p.shape)} {tuple(q.shape)}")
    if p.device.type == "cpu":
        return ec_add_plain(p, q, curve)
    p, q = p.contiguous(), q.contiguous()
    out = torch.empty_like(p)
    call("ec", "zk_ec_add", p.data_ptr(), q.data_ptr(), out.data_ptr(),
         p.shape[0], p.shape[2], curve.kernel_id, tag=_tag(curve))
    return out


# -- kernel 9: o = keep ? p : p + q -------------------------------------------

def _step_form(p, q, keep, q_index, fs, out):
    """Check a seg_step call's operands; returns (keep as bytes or None,
    the chain count W of the chains form or 0)."""
    _check_points(p, q)
    B, _, n = p.shape
    if out is not None:
        _check_points(p, out)
        if out.shape != p.shape:
            raise ValueError(f"out {tuple(out.shape)} is not p's "
                             f"{tuple(p.shape)}")
    if fs is not None:
        W = fs.shape[-1]
        if keep is not None or q_index is not None:
            raise ValueError("the chains form (fs) takes no keep and no "
                             "q_index")
        if fs.shape != (B, W) or n % W or q.shape != (B, 24, W):
            raise ValueError(f"chains form: fs {tuple(fs.shape)}, q "
                             f"{tuple(q.shape)} for p {tuple(p.shape)}")
        return None, W
    if keep is None:
        raise ValueError("seg_step needs keep or fs")
    keep = _flags(keep, B, n, p.device)
    if q_index is not None:
        if q_index.shape != (B, n) or q.shape[0] != B:
            raise ValueError(f"q_index {tuple(q_index.shape)}, q "
                             f"{tuple(q.shape)} for p {tuple(p.shape)}")
    elif q.shape != p.shape:
        raise ValueError(f"seg_step shapes {tuple(p.shape)} "
                         f"{tuple(q.shape)}")
    return keep, 0


def seg_step_plain(p, q, keep=None, curve: Curve = BN254, *, out=None,
                   q_index=None, fs=None):
    B, _, n = p.shape
    pl = lanes64(p)
    ql = lanes64(q)
    if fs is not None:                   # chains: (l, s) at s·W + l
        W = fs.shape[1]
        l_of = torch.arange(n, device=p.device) % W
        ql = ql[:, l_of]
        need = torch.arange(n, device=p.device) // W < fs[:, l_of]
    else:
        if q_index is not None:
            rows = torch.arange(B, device=p.device)[:, None]
            ql = ql[rows, q_index]
        need = ~keep.bool()
    res = pl.clone()
    if bool(need.any()):
        res[need] = add_limbs(pl[need], ql[need], curve)
    res = _packed(res)
    if out is None:
        return res
    out.copy_(res)
    return out


def seg_step(p: torch.Tensor, q: torch.Tensor, keep=None,
             curve: Curve = BN254, *, out=None, q_index=None,
             fs=None) -> torch.Tensor:
    """o = keep ? p : p + q on `curve`, in one of three forms:

    - natural: q of p's shape, `keep` a (batch, n) flag row;
    - gathered (`q_index`, (batch, n) int): element e adds
      q[:, :, q_index[:, e]] of a (batch, 24, m) q;
    - chains (`fs`, (batch, W) int): p chain-major with W chains of
      S = n / W (element s·W + l is chain l's s-th), q one carry a chain
      (batch, 24, W); (l, s) adds its chain's carry iff s < fs[:, l], in
      place of its element.

    The result goes into `out` where given; `out` may be p itself, and
    then kept elements are not touched. q_index must index within q."""
    keep, W = _step_form(p, q, keep, q_index, fs, out)
    if p.device.type == "cpu":
        return seg_step_plain(p, q, keep, curve, out=out, q_index=q_index,
                              fs=fs)
    if out is not None and not out.is_contiguous():
        raise ValueError("seg_step writes into a contiguous out only")
    if out is not p:
        p = p.contiguous()
    q = q.contiguous()
    if out is None:
        out = torch.empty_like(p)
    idx = None if q_index is None else q_index.to(torch.int64).contiguous()
    first = None if fs is None else fs.to(torch.int64).contiguous()
    call("ec", "zk_seg_step", p.data_ptr(), q.data_ptr(),
         None if keep is None else keep.data_ptr(),
         None if idx is None else idx.data_ptr(),
         None if first is None else first.data_ptr(), out.data_ptr(),
         p.shape[0], p.shape[2], q.shape[2], W, SEG_TILE, curve.kernel_id,
         tag=_tag(curve))
    return out


# -- kernel 11: per-chain segmented scan ----------------------------------------

def chain_scan_local_plain(p, f, W: int, curve: Curve = BN254, *,
                           index=None):
    if index is None:
        B, _, n = p.shape
        pts = lanes64(p).reshape(B, n // W, W, 3, 8)
        fl = f.bool().reshape(B, n // W, W)
    else:                     # gathered: the points of `index`, chain-major
        B, n = index.shape
        pts = lanes64(pack(p[index])).reshape(B, W, n // W, 3, 8) \
            .transpose(1, 2)
        fl = f.bool().reshape(B, W, n // W).transpose(1, 2)
    S = n // W
    out = torch.empty((B, S, W, 3, 8), dtype=torch.int64, device=p.device)
    acc = pts[:, 0]
    out[:, 0] = acc
    for k in range(1, S):
        x = pts[:, k]
        acc = torch.where(fl[:, k, :, None, None], x,
                          add_limbs(acc, x, curve))
        out[:, k] = acc
    return _packed(out.reshape(B, n, 3, 8))


def chain_scan_local(p: torch.Tensor, f: torch.Tensor, W: int,
                     curve: Curve = BN254, *,
                     index=None) -> torch.Tensor:
    """Segmented inclusive scan of W chains a row of n elements, S = n / W
    a chain, each chain's head a segment start (f: the start flags), into
    a (batch, 24, n) chain-major result (chain l's k-th sum at k·W + l).

    - dense: p (batch, 24, n) packed points, chain l the lanes l, W + l,
      2W + l, ... of p and f;
    - gathered (`index`, (batch, n) int): p the (m, 3, 8) table of points,
      chain l's k-th element the row's (l·S + k)-th: the point
      p[index[b, l·S + k]] with the flag f[b, l·S + k]. Nothing is
      gathered: the kernel reads each point through the index.
    index must index within p."""
    if index is None:
        _check_points(p)
        B, _, n = p.shape
    else:
        if p.dtype != torch.int32 or p.dim() != 3 or p.shape[1:] != (3, 8):
            raise ValueError(f"gathered chain scan: points must be (m, 3, "
                             f"8) int32, got {p.dtype} {tuple(p.shape)}")
        if index.dim() != 2 or index.device != p.device:
            raise ValueError(f"index {tuple(index.shape)} on {index.device} "
                             f"for points on {p.device}")
        B, n = index.shape
    f = _flags(f, B, n, p.device)
    if n % W:
        raise ValueError(f"n={n} is not a multiple of W={W}")
    if p.device.type == "cpu":
        return chain_scan_local_plain(p, f, W, curve, index=index)
    p = p.contiguous()
    if index is not None:
        index = index.to(torch.int64).contiguous()
        if p.data_ptr() % 16:            # the kernel's 16-byte loads
            p = p.clone()
    out = torch.empty((B, 24, n), dtype=torch.int32, device=p.device)
    call("ec", "zk_chain_scan", p.data_ptr(),
         None if index is None else index.data_ptr(), f.data_ptr(),
         out.data_ptr(), B, n, W, curve.kernel_id, tag=_tag(curve))
    return out


# -- kernel 10: segmented scan of a row, spread over a cluster of blocks ------

def _scan_run(batch: int, n: int) -> int:
    run = 1
    while run < SCAN_MAX_RUN and (run * SCAN_ROW_THREADS < n or
                                  batch * -(-n // run) > SCAN_CALL_THREADS):
        run *= 2
    return run


def _scan_layout(batch: int, n: int):
    """(run, threads a block, blocks a cluster) of rows of n lanes:
    ceil(n / run) threads of the scan a row, rounded up to whole warps."""
    run = _scan_run(batch, n)
    warps = -(-n // (32 // SCAN_LANES * run))
    threads = min(SCAN_BLOCK, 32 * warps)
    return run, threads, -(-32 * warps // threads)


def _where_add(a, b, need, curve: Curve):
    """b with ec_add(a, b) at the positions `need`: (…, 3, 8) points."""
    out = b.clone()
    if bool(need.any()):
        out[need] = add_limbs(a[need], b[need], curve)
    return out


def _combine(a, b, curve: Curve):
    """b <- a ∘ b on pairs (points, has a start, exists), a earlier: a
    missing pair (past the row's end) neither changes one nor takes one;
    b with a start keeps its sum, else the sum is ec_add(a, b) — the
    kernel's rule."""
    av, ah, ao = a
    bv, bh, bo = b
    both = ao & bo
    return _where_add(av, bv, both & ~bh, curve), bh | (both & ah), bo


def _shift_up(pair, d: int):
    """Each pair takes the one d places before it along the last axis of
    its flags (a shuffle up); the first d take a missing pair."""
    v, h, o = pair
    m = o.shape[-1]
    return (torch.cat([v[..., :d, :, :], v[..., :m - d, :, :]], -3),
            torch.cat([h[..., :d], h[..., :m - d]], -1),
            torch.cat([torch.zeros_like(o[..., :d]), o[..., :m - d]], -1))


def seg_scan_tiles_plain(p, f, curve: Curve = BN254):
    B, _, n = p.shape
    run, G = _scan_run(B, n), 32 // SCAN_LANES   # G threads a warp
    T = -(-n // (G * run)) * G                   # threads of the row
    nw = T // G
    pad = T * run - n
    pts = lanes64(p)
    pts = torch.cat([pts, pts.new_zeros((B, pad, 3, 8))], dim=1) \
        .reshape(B, T, run, 3, 8)
    st = f.bool().clone()
    st[:, 0] = True
    st = torch.cat([st, st.new_zeros((B, pad))], dim=1).reshape(B, T, run)
    ek = (torch.arange(T * run, device=p.device) < n).reshape(T, run) \
        .expand(B, T, run)
    # 1. each thread's run: its sum since its last start
    v, h, o = pts[:, :, 0], st[:, :, 0] & ek[:, :, 0], ek[:, :, 0].clone()
    for k in range(1, run):
        x, sk, e = pts[:, :, k], st[:, :, k], ek[:, :, k]
        v = torch.where(sk[..., None, None], x,
                        _where_add(v, x, e & ~sk, curve))
        h = h | (sk & e)
    # 2. inclusive scan of each warp's G pairs
    pair = (v.reshape(B, nw, G, 3, 8), h.reshape(B, nw, G),
            o.reshape(B, nw, G))
    d = 1
    while d < G:
        pair = _combine(_shift_up(pair, d), pair, curve)
        d <<= 1
    before = _shift_up(pair, 1)
    # 3. the warp totals, scanned; each warp takes the one before it
    w = tuple(x[:, :, G - 1] for x in pair)
    d = 1
    while d < nw:
        w = _combine(_shift_up(w, d), w, curve)
        d <<= 1
    wp = _shift_up(w, 1)
    wp = tuple(x[:, :, None].expand((B, nw, G) + x.shape[2:]) for x in wp)
    # 4. each thread's exclusive prefix (the warps' alone at lane 0), then
    #    its run again
    ex = _combine(wp, before, curve)
    lead = ~before[2]
    ex = (torch.where(lead[..., None, None], wp[0], ex[0]), ex[1],
          torch.where(lead, wp[2], ex[2]))
    av, _, ao = (x.reshape((B, T) + x.shape[3:]) for x in ex)
    out = torch.empty_like(pts)
    for k in range(run):
        x, sk, e = pts[:, :, k], st[:, :, k] | ~ao, ek[:, :, k]
        av = torch.where(sk[..., None, None], x,
                         _where_add(av, x, e & ~sk, curve))
        ao = ao | e
        out[:, :, k] = av
    return _packed(out.reshape(B, T * run, 3, 8)[:, :n])


def seg_scan_tiles(p: torch.Tensor, f: torch.Tensor,
                   curve: Curve = BN254) -> torch.Tensor:
    """Segmented inclusive scan of each row (one cluster of blocks a row);
    a row's first lane starts a segment."""
    _check_points(p)
    B, _, n = p.shape
    f = _flags(f, B, n, p.device)
    run, threads, cluster = _scan_layout(B, n)
    if threads // 32 * cluster > 32 // SCAN_LANES:
        raise ValueError(f"a row of {n} lanes needs {cluster} blocks of "
                         f"{threads} threads, more than the scan spreads")
    if p.device.type == "cpu":
        return seg_scan_tiles_plain(p, f, curve)
    p = p.contiguous()
    out = torch.empty_like(p)
    call("ec", "zk_seg_scan_tiles", p.data_ptr(), f.data_ptr(),
         out.data_ptr(), B, n, run, threads, cluster, curve.kernel_id,
         tag=_tag(curve))
    return out


# -- kernel 12: Σ_w 2^(c·w)·P_w ---------------------------------------------------

def scale_reduce_plain(ws, c: int, curve: Curve = BN254):
    pts = lanes64(ws)                    # (B, nlive, 3, 8)
    acc = pts[:, -1]
    for w in range(pts.shape[1] - 2, -1, -1):
        for _ in range(c):
            acc = dbl_limbs(acc, curve)
        acc = add_limbs(acc, pts[:, w], curve)
    return _packed(acc[:, None])[:, :, 0]


def scale_reduce(ws: torch.Tensor, c: int,
                 curve: Curve = BN254) -> torch.Tensor:
    """ws (batch, 24, nlive) window sums -> (batch, 24) Σ_w 2^(c·w)·ws_w."""
    _check_points(ws)
    if ws.device.type == "cpu":
        return scale_reduce_plain(ws, c, curve)
    ws = ws.contiguous()
    out = torch.empty(ws.shape[:2], dtype=torch.int32, device=ws.device)
    call("ec", "zk_scale_reduce", ws.data_ptr(), out.data_ptr(),
         ws.shape[0], ws.shape[2], c, curve.kernel_id, tag=_tag(curve))
    return out

