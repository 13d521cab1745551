"""Build the CUDA sources with nvcc and bind them with ctypes.

Each ``cuda/csrc/<name>.cu`` becomes ``cuda/build/lib<name>.so`` (a plain C
interface; no PyTorch headers, so a build takes seconds). All sources are
compiled in parallel, once per process, at the first launch; the build
directory is ignored by git. ``ptxas -v`` output is kept per source so a
caller can report registers and spills.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "cuda" / "csrc"
BUILD_DIR = _PKG / "cuda" / "build"
SOURCES = ("mulmod", "ec", "ntt")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry points and their argument types (every one returns cudaError_t)
SIGNATURES = {
    "mulmod": {
        "zk_mulmod": [_P, _P, _P, _LL, _LL, _I, _P],
        "zk_addmod": [_P, _P, _P, _LL, _LL, _I, _P],
        "zk_chain_cumprod": [_P, _P, _LL, _LL, _I, _P],
        "zk_cumprod_tile": [_P, _P, _LL, _I, _P],
    },
    "ec": {
        "zk_ec_add": [_P, _P, _P, _LL, _LL, _P],
        "zk_seg_step": [_P, _P, _P, _P, _LL, _LL, _P],
        "zk_chain_scan": [_P, _P, _P, _LL, _LL, _LL, _P],
        "zk_seg_scan_tiles": [_P, _P, _P, _LL, _LL, _I, _P],
        "zk_scale_reduce": [_P, _P, _LL, _LL, _I, _P],
    },
    "ntt": {
        "zk_ntt_tail": [_P, _P, _P, _LL, _LL, _LL, _I, _P],
        "zk_ntt_head": [_P, _P, _P, _LL, _LL, _LL, _I, _P],
    },
}


@dataclass
class Built:
    libs: Dict[str, ctypes.CDLL]
    ptxas: Dict[str, str]        # source name -> ptxas -v report
    seconds: float               # wall time of the parallel nvcc build


_BUILT: Built | None = None

# Launches per C entry point since the last reset: incremented in call(),
# right after a launch that the runtime accepted, and nowhere else.
LAUNCHES: Dict[str, int] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build() -> Built:
    """Compile every source (in parallel) and load the libraries; cached
    for the life of the process. Raises on any compiler error."""
    global _BUILT
    if _BUILT is not None:
        return _BUILT
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
        cmd = [compiler, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(out), str(CSRC / f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    reports, failed = {}, []
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        reports[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{stdout}{stderr}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    seconds = time.perf_counter() - t0
    libs = {}
    for name, (out, _) in procs.items():
        final = BUILD_DIR / f"lib{name}.so"
        os.replace(out, final)
        lib = ctypes.CDLL(str(final))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    _BUILT = Built(libs=libs, ptxas=reports, seconds=seconds)
    return _BUILT


def call(lib: str, fn: str, *args) -> None:
    """Launch `fn` of source `lib` on the current stream; raise if the
    launch was refused (cudaGetLastError after the launch)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(build().libs[lib], fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    LAUNCHES[fn] = LAUNCHES.get(fn, 0) + 1
