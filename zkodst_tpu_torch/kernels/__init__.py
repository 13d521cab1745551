"""Wrappers of the hand-written CUDA kernels, each beside its plain twin.

Every wrapper takes int32 limb tensors. On a tensor that lies on the CPU
it runs the kernel's plain PyTorch version (the CPU path, which the tests
use); on a CUDA tensor it launches the kernel and raises if the build or
the launch fails — there is no fallback from a kernel to its twin. Every
accepted launch adds one to its entry point's count (``build.call``);
:func:`reset_counts` and :func:`counts` read them per wrapper.
"""

from __future__ import annotations

from . import build, ec, mulmod, ntt

# wrapper -> (wrapper function, its C entry point)
WRAPPERS = {
    "mulmod": (mulmod.mulmod, "zk_mulmod"),
    "addmod": (mulmod.addmod, "zk_addmod"),
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


def reset_counts() -> None:
    build.LAUNCHES.clear()


def counts() -> dict:
    return {name: build.LAUNCHES.get(entry, 0)
            for name, (_, entry) in WRAPPERS.items()}
