"""Wrappers of the hand-written CUDA kernels, each beside its plain twin.

Every wrapper takes int32 limb tensors. On a tensor that lies on the CPU
it runs the kernel's plain PyTorch version (the CPU path, which the tests
use); on a CUDA tensor it launches the kernel and raises if the build or
the launch fails — there is no fallback from a kernel to its twin. Every
accepted launch adds one to its entry point's count (``build.call``);
:func:`reset_counts` clears them (and the host-wait counters of
``utils/timing.py``) and :func:`counts` reads them per wrapper;
:func:`copies` reads the binop operands copied whole since the reset.
The Pasta instantiations of kernels 1–3 (on both Pasta fields) and 8–12
(on the pallas curve: the addition and the Pippenger MSM's kernels; the
IPA backend's second curve) are counted apart (:data:`PASTA_WRAPPERS`,
:func:`pasta_counts`; ``mulmod[pasta_fp]``, ``seg_step[pallas]``, …),
and so are kernels 13 and 14, the BLAKE2f witness (into the circuit's
columns, or as a stream) and compression, which replace no Pallas kernel
(:data:`BLAKE2F_WRAPPERS`, :func:`blake2f_counts`; they take int64 word
pairs). Kernel 11's two forms, dense and gathered (the MSM's windows),
count as one wrapper's launches.
"""

from __future__ import annotations

from ..utils import timing
from . import blake2, build, ec, mulmod, ntt

# wrapper -> (wrapper function, its C entry point)
WRAPPERS = {
    "mulmod": (mulmod.mulmod, "zk_mulmod"),
    "addmod": (mulmod.addmod, "zk_addmod"),
    "submod": (mulmod.submod, "zk_submod"),
    "chain_cumprod": (mulmod.chain_cumprod, "zk_chain_cumprod"),
    "cumprod_tile": (mulmod.cumprod_tile, "zk_cumprod_tile"),
    "ntt_tail": (ntt.ntt_tail, "zk_ntt_tail"),
    "ntt_head": (ntt.ntt_head, "zk_ntt_head"),
    "ec_add": (ec.ec_add, "zk_ec_add"),
    "seg_step": (ec.seg_step, "zk_seg_step"),
    "seg_scan_tiles": (ec.seg_scan_tiles, "zk_seg_scan_tiles"),
    "chain_scan_local": (ec.chain_scan_local, "zk_chain_scan"),
    "scale_reduce": (ec.scale_reduce, "zk_scale_reduce"),
}

# the Pasta instantiations: wrapper[field or curve] -> (wrapper, the count's
# key); their launches are not among the twelve's
PASTA_WRAPPERS = {
    f"{name}[{tag}]": (fn, f"{entry}[{tag}]")
    for tag in ("pasta_fp", "pasta_fr")
    for name, (fn, entry) in WRAPPERS.items()
    if name in ("mulmod", "addmod", "submod")}
PASTA_WRAPPERS.update({
    f"{name}[pallas]": (fn, f"{entry}[pallas]")
    for name, (fn, entry) in WRAPPERS.items()
    if name in ("ec_add", "seg_step", "seg_scan_tiles", "chain_scan_local",
                "scale_reduce")})

# kernels 13 (its two entry points: the circuit's columns, the stream) and
# 14: the round loops the JAX package compiles with XLA
BLAKE2F_WRAPPERS = {
    "blake2f_advice": (blake2.blake2f_advice, "zk_blake2f_advice"),
    "blake2f_witness": (blake2.blake2f_witness, "zk_blake2f_witness"),
    "blake2f_compress": (blake2.blake2f_compress, "zk_blake2f_compress"),
}


def reset_counts() -> None:
    """Clear the launch counts, the operand copies and the host-wait
    counters (``utils.timing.COUNTERS``)."""
    build.LAUNCHES.clear()
    timing.reset_counters()
    for kind in mulmod.OPERAND_COPIES:
        mulmod.OPERAND_COPIES[kind] = 0


def counts() -> dict:
    return {name: build.LAUNCHES.get(entry, 0)
            for name, (_, entry) in WRAPPERS.items()}


def pasta_counts() -> dict:
    return {name: build.LAUNCHES.get(entry, 0)
            for name, (_, entry) in PASTA_WRAPPERS.items()}


def blake2f_counts() -> dict:
    return {name: build.LAUNCHES.get(entry, 0)
            for name, (_, entry) in BLAKE2F_WRAPPERS.items()}


def copies() -> dict:
    return dict(mulmod.OPERAND_COPIES)
