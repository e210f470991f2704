"""ctypes loader for the host lattice-point library (counterpart of
``fastgaussianprocesses_tpu/points/native.py``, lattice half).

``points/_native/fastgp_native.cpp`` is compiled with ``g++`` at first use
into ``_build/libfastgp_native-<hash>.so`` inside the package directory (the
hash covers the source and the flags; never at import).  Where no compiler
is found, the build directory cannot be written, the build fails or times
out, or the library does not load, :func:`lattice_natural` returns ``None``
and ``LatticeSeq`` keeps its numpy path, whose output the library's equals
bit for bit.  This is host code: the points are generated on the CPU and
moved to the device by the models.  The digital net has no library path:
its numpy doubling is already one pass of XORs over the points.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "points" / "_native" / "fastgp_native.cpp"
BUILD_DIR = _PKG / "_build"
# no fused multiply-add: the lattice's frac(vdc(i) * g + shift) must round
# as numpy's separate multiply and add do
FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC"]

_U64P = ctypes.POINTER(ctypes.c_uint64)
_F64P = ctypes.POINTER(ctypes.c_double)
_lib = None
_tried = False


def build():
    """Compile the library if it is missing; its path, or None where there is
    no g++, the build directory cannot be written, or g++ fails or times out."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libfastgp_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(exist_ok=True)
        proc = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out


def load():
    """The loaded library with argtypes set, or None (see :func:`build`)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        path = build()
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                return None
            lib.lattice_natural.argtypes = [_U64P, ctypes.c_int, ctypes.c_uint64,
                                            ctypes.c_uint64, _F64P, _F64P]
            lib.lattice_natural.restype = None
            _lib = lib
    return _lib


def lattice_natural(gen_vec: np.ndarray, n_min: int, n_max: int, shift: np.ndarray):
    """Natural-order shifted rank-1 lattice points ``frac(vdc(i) g + shift)``,
    float64 (n_max - n_min, d), or None."""
    lib = load()
    if lib is None:
        return None
    gen_vec = np.ascontiguousarray(gen_vec, dtype=np.uint64)
    shift = np.ascontiguousarray(shift, dtype=np.float64)
    d = gen_vec.shape[0]
    if shift.shape != (d,) or not 0 <= n_min <= n_max <= (1 << 32):
        raise ValueError("lattice: shift needs d entries and 0 <= n_min <= n_max <= 2^32")
    out = np.empty((int(n_max) - int(n_min), d), dtype=np.float64)
    lib.lattice_natural(gen_vec.ctypes.data_as(_U64P), d, int(n_min), int(n_max),
                        shift.ctypes.data_as(_F64P), out.ctypes.data_as(_F64P))
    return out
