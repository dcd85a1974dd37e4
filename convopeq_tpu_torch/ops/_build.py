"""Build and bind the port's CUDA kernels (csrc/frame_conv.cu).

nvcc compiles the source into a shared library with a plain C interface,
bound with ctypes.  The build happens at first use, never at import, and
is keyed by a hash of the source: `convopeq_tpu_torch/_build/` holds one
library per source version.  A failed build raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "frame_conv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "frames_rfft_f32": [_P, _P, _P, _I, _I, _I, _P],
    "irfft_valid_f32": [_P, _P, _P, _I, _I, _I, _P],
    "causal_mac_c64": [_P, _P, _P, _I, _I, _I, _I, _P],
    "frame_conv_mac_tile": [_I],
}

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, with the CUDA toolkit")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libframe_conv_{digest}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if this source version is not built yet.
    Returns (library path, nvcc's stderr: the ptxas register and shared
    memory report, empty when the library was already there)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stderr


def frame_conv_lib() -> ctypes.CDLL:
    """The bound kernel library, built on first call."""
    lib = _loaded.get("frame_conv")
    if lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["frame_conv"] = lib
    return lib
