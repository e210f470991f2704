"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ``ctypes``.

The sources expose a plain C interface (no PyTorch headers, so ``nvcc``
takes seconds, not minutes) and are compiled for ``sm_90a``: one ``nvcc``
per source, all started together, then one link into
``_build/fgp_kernels-<hash>.so`` inside the package directory, the hash
covering every source and the flags.  The build happens at first use,
never at import.  Every entry point returns a CUDA error code; :func:`check`
raises on a non-zero one.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "perm_fft.cu", _PKG / "csrc" / "fwht.cu",
           _PKG / "csrc" / "si_cross.cu")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point: every pointer and the stream as c_void_p
_SIGNATURES = {
    "fgp_pfft": [_P, _I] + [_P] * 6 + [_I] * 4 + [_P],
    "fgp_pifft_real": [_P] * 7 + [_I] * 4 + [_P],
    "fgp_pifft": [_P] * 7 + [_I] * 4 + [_P],
    "fgp_quad": [_P] * 9 + [_I] * 3 + [_P],
    "fgp_fwht": [_P] * 4 + [ctypes.c_longlong] + [_I] * 6 + [ctypes.c_longlong] + [_I] * 3
                + [_P],
    "fgp_si_cross": [_P] * 8 + [ctypes.c_longlong] * 2 + [_I] * 6 + [_P],
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


def _run_all(cmds, what):
    """Run the commands side by side; raise with the compiler output of the
    first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for name, p, out in zip(what, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")


def build() -> Path:
    """Compile and link the library if it is missing; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + src.read_bytes())
    out = BUILD_DIR / f"fgp_kernels-{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(SOURCES, objs)], [s.name for s in SOURCES])
        tmp = out.with_suffix(f".{tag}")
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]],
                 ["the link"])
        for o in objs:
            o.unlink()
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
