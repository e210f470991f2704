"""Build ``csrc/perm_fft.cu`` with ``nvcc`` and load it with ``ctypes``.

The source exposes a plain C interface (no PyTorch headers, so ``nvcc``
takes seconds, not minutes) and is compiled for ``sm_90a`` into
``_build/perm_fft-<hash>.so`` inside the package directory, the hash
covering the source and the flags.  The build happens at first use, never
at import.  Every entry point returns a CUDA error code; :func:`check`
raises on a non-zero one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "perm_fft.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point: every pointer and the stream as c_void_p
_SIGNATURES = {
    "fgp_passb": [_P] * 12 + [_I] * 5 + [_P],
    "fgp_quad": [_P] * 13 + [_I] * 4 + [_P],
}

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled at first use "
                       "and need the CUDA toolkit (set CUDA_HOME)")


def build() -> Path:
    """Compile the library if it is missing; return its path.  Raises with
    the compiler output on failure."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"perm_fft-{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.fgp_error_string.argtypes = [ctypes.c_int]
        lib.fgp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.fgp_error_string(err).decode()})")
