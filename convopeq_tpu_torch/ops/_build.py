"""Build and bind the port's CUDA kernels (the `.cu` sources under csrc/).

Each source is its own library: nvcc compiles it into a shared library
with a plain C interface, bound with ctypes, with the source's own nvcc
flags and signature table.  The build happens at first use, never at
import, and is keyed by a hash of the source and its flags:
`convopeq_tpu_torch/_build/` holds one library per source version.  A
failed build raises with nvcc's stderr.  `build_all` starts one nvcc per
source at once and waits for all of them; given other `Library` entries
(another tree's source, extra -D flags) it builds those, and `bind` sets
their signatures (`python -m convopeq_tpu_torch.sweep`).

The quantizer library is built with `-fmad=false`: its error-feedback
loops are chaotic at the ULP level, and a contracted multiply-add flips
a rounding decision within a few hundred samples, so the kernel must
round every multiply and every add on its own, as its plain PyTorch
version does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

from ..runtime.telemetry import setup_span

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_DP = ctypes.POINTER(ctypes.c_double)


@dataclass(frozen=True)
class Library:
    name: str
    source: Path
    flags: tuple
    signatures: dict
    deps: tuple = ()      # files the source includes (part of the key)


_EFQ_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _DP, _I, _D, _D, _P]
_EFQ_ROWS_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _D, _D, _P]
_SC_ARGS = [_P, _P, _I, _I, _DP, _D, _D, _D, _P]
_IIR_ARGS = [_P, _P, _I, _I, _I, _I, _I, _DP, _P, _P, _P, _P, _P]

LIBRARIES = {
    "frame_conv": Library(
        "frame_conv", _PKG / "csrc" / "frame_conv.cu", NVCC_FLAGS, {
            "frames_rfft_f32": [_P, _P, _P, _I, _I, _I, _P],
            "frames_rfft_f64": [_P, _P, _P, _I, _I, _I, _P],
            "osa_rfft_f32": [_P, _P, _P, _I, _I, _I, _P],
            "irfft_valid_f32": [_P, _P, _P, _I, _I, _I, _P],
            "irfft_valid_f64": [_P, _P, _P, _I, _I, _I, _P],
            "causal_mac_c64": [_P, _P, _P, _I, _I, _I, _I, _P],
            "causal_mac_c128": [_P, _P, _P, _I, _I, _I, _I, _P],
            "fused_conv_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
            "frame_conv_mac_block": [_I, _I],
            "frame_conv_mac_block_c128": [_I, _I],
        }),
    "error_feedback_quantize": Library(
        "error_feedback_quantize",
        _PKG / "csrc" / "error_feedback_quantize.cu",
        NVCC_FLAGS + ("-fmad=false",), {
            "error_feedback_quantize_f32": _EFQ_ARGS,
            "error_feedback_quantize_f64": _EFQ_ARGS,
            "error_feedback_quantize_rows_f32": _EFQ_ROWS_ARGS,
            "error_feedback_quantize_rows_f64": _EFQ_ROWS_ARGS,
            "error_feedback_quantize_folds": [_I, _D, _I],
        }),
    "softclip": Library(
        "softclip", _PKG / "csrc" / "softclip.cu", NVCC_FLAGS, {
            "soft_clip_local2x_f32": _SC_ARGS,
            "soft_clip_local2x_f64": _SC_ARGS,
        }),
    "iir_cascade": Library(
        "iir_cascade", _PKG / "csrc" / "iir_cascade.cu", NVCC_FLAGS, {
            "iir_cascade_f32": _IIR_ARGS,
            "iir_cascade_f64": _IIR_ARGS,
        }),
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


def library_path(lib: Library) -> Path:
    h = hashlib.sha256(lib.source.read_bytes())
    for dep in lib.deps:
        h.update(Path(dep).read_bytes())
    h.update(" ".join(lib.flags).encode())
    return BUILD_DIR / f"lib{lib.name}_{h.hexdigest()[:16]}.so"


def _start(lib: Library):
    """Start nvcc for `lib` unless built; returns (path, process or None,
    temporary output)."""
    path = library_path(lib)
    if path.exists():
        return path, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *lib.flags, "-o", str(tmp), str(lib.source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return path, proc, tmp


def _finish(path, proc, tmp) -> str:
    if proc is None:
        return ""
    _out, err = proc.communicate()
    if proc.returncode != 0:
        print(err, file=sys.stderr)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(proc.args)}\n{err}")
    os.replace(tmp, path)
    return err


def build(name: str) -> tuple[Path, str]:
    """Compile library `name` if this source version is not built yet.
    Returns (library path, nvcc's stderr: the ptxas register and shared
    memory report, empty when the library was already there)."""
    path, proc, tmp = _start(LIBRARIES[name])
    return path, _finish(path, proc, tmp)


def build_all(libs=None) -> dict:
    """Build every library of `libs` ({name: Library}, by default
    LIBRARIES), one nvcc per source, all started together.  Returns
    {name: (path, nvcc stderr)}."""
    libs = LIBRARIES if libs is None else libs
    started = {name: _start(lib) for name, lib in libs.items()}
    return {name: (s[0], _finish(*s)) for name, s in started.items()}


def bind(lib: Library, path: Path) -> ctypes.CDLL:
    """The built library at `path` with `lib`'s signatures set."""
    dll = ctypes.CDLL(str(path))
    for fn_name, argtypes in lib.signatures.items():
        fn = getattr(dll, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def load(name: str) -> ctypes.CDLL:
    """The bound library `name`, built on first call: the first call's
    build and bind is the set-up span "setup.build"."""
    lib = _loaded.get(name)
    if lib is None:
        with setup_span("setup.build"):
            path, _ = build(name)
            lib = bind(LIBRARIES[name], path)
        _loaded[name] = lib
    return lib
