"""The host C++ core of the verifier: the BN254 pairing check and small G1
MSMs, bound with ctypes.

Counterpart of ``zkodst_tpu/native.py``; ``zkcore.cpp`` beside this file is
a verbatim copy of the reference's ``native/zkcore.cpp``. It is built with
``g++ -O3 -shared -fPIC`` at first use into ``build/`` (ignored by git):
under a temporary name that then replaces the library whole, so several
processes may build at once. It is host code, not a device kernel. There
is no fallback: if g++ is missing, the build fails or the library's self
test fails, the call raises. The pure-Python pairing (:mod:`..proof.pairing`)
and MSM (:func:`..proof.shplonk.g1_msm`) are the explicit alternative
(``verify_proof(..., native=False)``) that the tests compare against.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

from ..ops.pycurve import R_ORDER
from ..ops.pyfield import FQ

SRC = Path(__file__).resolve().parent / "zkcore.cpp"
LIB = SRC.parent / "build" / "libzkcore.so"
_lock = threading.Lock()
_lib = None

_FINAL_EXP = (FQ.p ** 12 - 1) // R_ORDER
_EXP_BYTES = _FINAL_EXP.to_bytes((_FINAL_EXP.bit_length() + 7) // 8,
                                 "little")


def _build() -> None:
    """Compile SRC into LIB with g++; raises RuntimeError naming g++."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_name(f"libzkcore.{os.getpid()}.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=600)
    except FileNotFoundError as ex:
        raise RuntimeError("g++ not found: the native verifier core "
                           f"({SRC.name}) cannot be built") from ex
    except subprocess.CalledProcessError as ex:
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n"
                           f"{ex.stderr}") from ex
    os.replace(tmp, LIB)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at the first call of the process (and
    again when the source is newer than the library)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not LIB.exists()
                or LIB.stat().st_mtime < SRC.stat().st_mtime):
            _build()
        lib = ctypes.CDLL(str(LIB))
        lib.zk_selftest.argtypes = []
        lib.zk_selftest.restype = ctypes.c_int
        lib.zk_pairing_check.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.zk_pairing_check.restype = ctypes.c_int
        lib.zk_g1_msm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_void_p]
        lib.zk_g1_msm.restype = None
        if lib.zk_selftest() != 0:
            raise RuntimeError(f"{LIB} (built by g++ from {SRC.name}) "
                               "failed its self test")
        _lib = lib
        return _lib


def _pt_bytes(pt) -> Tuple[bytes, int]:
    if pt is None:
        return bytes(64), 1
    return (int(pt[0]).to_bytes(32, "little")
            + int(pt[1]).to_bytes(32, "little")), 0


def pairing_check(pairs: Sequence[Tuple[object, object]]) -> bool:
    """∏ e(P_i, Q_i) == 1 for G1 affine int tuples P_i and G2 affine Fq2
    tuples Q_i (None = the identity)."""
    lib = get_lib()
    g1b, g1i, g2b, g2i = b"", [], b"", []
    for g1, g2 in pairs:
        b, inf = _pt_bytes(g1)
        g1b += b
        g1i.append(inf)
        if g2 is None:
            g2b += bytes(128)
            g2i.append(1)
        else:
            (x0, x1), (y0, y1) = g2
            g2b += b"".join(int(v).to_bytes(32, "little")
                            for v in (x0, x1, y0, y1))
            g2i.append(0)
    return bool(lib.zk_pairing_check(g1b, bytes(g1i), g2b, bytes(g2i),
                                     len(pairs), _EXP_BYTES,
                                     len(_EXP_BYTES)))


def g1_msm(points: Sequence[object], scalars: Sequence[int]):
    """Σ k_i·P_i (affine int tuples; None = the identity)."""
    lib = get_lib()
    pb, infs, sb = b"", [], b""
    for p, k in zip(points, scalars):
        b, inf = _pt_bytes(p)
        pb += b
        infs.append(inf)
        sb += (int(k) % R_ORDER).to_bytes(32, "little")
    out = (ctypes.c_uint8 * 65)()
    lib.zk_g1_msm(pb, bytes(infs), sb, len(infs), out)
    raw = bytes(out)
    if raw[0]:
        return None
    return (int.from_bytes(raw[1:33], "little"),
            int.from_bytes(raw[33:65], "little"))
