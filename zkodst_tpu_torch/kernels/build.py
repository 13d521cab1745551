"""Build the CUDA sources with nvcc and bind them with ctypes.

Each ``cuda/csrc/<name>.cu`` becomes ``cuda/build/lib<name>.<key>.so`` (a
plain C interface; no PyTorch headers, so a build takes seconds), where
the key hashes every file of ``cuda/csrc``, the compiler's path and the
flags. All sources are compiled in parallel, once per process, at the
first launch, unless libraries of the same key are there already: then
they are loaded (a process started after a build, such as a rank of a
sharded prover, skips nvcc). The build directory is ignored by git.
``ptxas -v`` output is kept per source, beside its library, so a caller
can report registers and spills.
"""

from __future__ import annotations

import ctypes
import hashlib
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
SOURCES = ("mulmod", "ec", "ntt", "blake2f", "quotient")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C entry points and their argument types (every one returns cudaError_t)
SIGNATURES = {
    "mulmod": {
        "zk_mulmod": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _P],
        "zk_addmod": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _P],
        "zk_submod": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _I, _P],
        "zk_chain_cumprod": [_P, _P, _LL, _LL, _I, _I, _P],
        "zk_cumprod_tile": [_P, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _P],
    },
    "ec": {
        "zk_ec_add": [_P, _P, _P, _LL, _LL, _I, _P],
        "zk_seg_step": [_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _I, _I,
                        _P],
        "zk_chain_scan": [_P, _P, _P, _P, _LL, _LL, _LL, _I, _P],
        "zk_seg_scan_tiles": [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P],
        "zk_scale_reduce": [_P, _P, _LL, _LL, _I, _I, _P],
    },
    "ntt": {
        "zk_ntt_tail": [_P, _P, _P, _LL, _LL, _LL, _I, _P],
        "zk_ntt_head": [_P, _P, _P, _LL, _LL, _LL, _I, _P],
    },
    "blake2f": {
        "zk_blake2f_advice": [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _P, _LL,
                              _P, _LL, _LL, _I, _P],
        "zk_blake2f_witness": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P],
        "zk_blake2f_compress": [_P, _P, _P, _P, _I, _P, _LL, _LL, _P],
    },
    "quotient": {
        "zk_quotient": [_P, _I, _P, _P, _P, _I, _P, _P, _LL, _I, _I, _P],
    },
}


@dataclass
class Built:
    libs: Dict[str, ctypes.CDLL]
    ptxas: Dict[str, str]        # source name -> ptxas -v report
    seconds: float               # wall time of the parallel nvcc build
    compiled: bool               # False: loaded from an earlier build


_BUILT: Built | None = None

# Launches per C entry point since the last reset: incremented in call(),
# right after a launch that the runtime accepted, and nowhere else. A
# launch of a Pasta instantiation counts under "<entry>[<field or curve>]"
# (call's `tag`), apart from the BN254 launches of the same entry.
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


def _flags(compiler: str, name: str, out: Path) -> list:
    return [compiler, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def _key(compiler: str) -> str:
    """A hash of every file of ``cuda/csrc``, the compiler's path and the
    flags: the name of a build of these sources."""
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(_flags(compiler, "", Path())).encode())
    return h.hexdigest()[:16]


def build(fresh: bool = False) -> Built:
    """Load the libraries, compiling every source (in parallel) unless a
    build of the same key is there and `fresh` is False; cached for the
    life of the process. Raises on any compiler error."""
    global _BUILT
    if _BUILT is not None:
        return _BUILT
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    key = _key(compiler)
    final = {name: BUILD_DIR / f"lib{name}.{key}.so" for name in SOURCES}
    report = {name: BUILD_DIR / f"lib{name}.{key}.ptxas.txt"
              for name in SOURCES}
    t0 = time.perf_counter()
    compiled = fresh or not all(final[n].exists() and report[n].exists()
                                for n in SOURCES)
    if compiled:
        procs = {}
        for name in SOURCES:
            out = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
            procs[name] = (out, subprocess.Popen(
                _flags(compiler, name, out), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        reports, failed = {}, []
        for name, (out, proc) in procs.items():
            stdout, stderr = proc.communicate()
            reports[name] = stdout + stderr
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{stdout}{stderr}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for name, (out, _) in procs.items():
            tmp = report[name].with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(reports[name])
            os.replace(tmp, report[name])
            os.replace(out, final[name])
    else:
        reports = {name: report[name].read_text() for name in SOURCES}
    seconds = time.perf_counter() - t0
    libs = {}
    for name in SOURCES:
        lib = ctypes.CDLL(str(final[name]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    _BUILT = Built(libs=libs, ptxas=reports, seconds=seconds,
                   compiled=compiled)
    return _BUILT


def call(lib: str, fn: str, *args, tag=None) -> None:
    """Launch `fn` of source `lib` on the current stream; raise if the
    launch was refused (cudaGetLastError after the launch). A `tag` counts
    the launch under ``fn[tag]``."""
    import torch

    # the handle of torch.cuda.current_stream() without building its
    # Stream object (a few µs of a launch's host time)
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    err = getattr(build().libs[lib], fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    key = fn if tag is None else f"{fn}[{tag}]"
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
