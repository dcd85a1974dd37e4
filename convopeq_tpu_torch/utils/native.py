"""ctypes bindings of the native runtime library (counterpart of
convopeq_tpu/utils/native.py; the C++ source is the repo's
native/convopeq_native.cpp, reused as it is).

The library is built at first use with g++ and native/Makefile's flags
into convopeq_tpu_torch/_build/ (never into native/, which holds the JAX
package's build), keyed by a hash of the source, the flags and the host's
CPU, written to a temporary name and moved into place, so that parallel
processes may race.  A failed build raises `NativeUnavailable`: nothing
falls back to a Python stand-in.  ctypes releases the GIL around every
call, which the serving plane's producer and consumer threads rely on.

- `read_wav_native`: the WAV parser and decoder (utils/wavio.read_wav
  takes it; the NumPy parser there is its plain version);
- `NativeRing`: SPSC lock-free ring of float64 (the live learner's
  capture ring);
- `NativeMpscRing`: bounded MPSC ring of fixed-size records;
- `deinterleave` / `interleave`: framing kernels;
- `NativeBlockScheduler`: the serving plane's per-stream SPSC rings of
  stereo blocks, batch gather / commit and deadline accounting
  (runtime/native_serving.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "convopeq_native.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile's CXXFLAGS and ARCHFLAGS
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-march=native", "-shared")

_LIB = None
_LOCK = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _host_key() -> bytes:
    """The host's CPU as the build sees it (-march=native)."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    key += line
                if line.startswith("flags"):
                    break
    except OSError:
        pass
    return key.encode()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_host_key())
    return BUILD_DIR / f"libconvopeq_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source is built for this host."""
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler (g++) for "
                                f"{SOURCE.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"native build failed ({proc.returncode}): "
                                f"{proc.stderr.strip()}")
    os.replace(tmp, path)
    return path


def load():
    """The bound library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as e:
            raise NativeUnavailable(str(e)) from e

        u64 = ctypes.c_uint64
        u32 = ctypes.c_uint32
        lib.cq_wav_parse.restype = ctypes.c_int
        lib.cq_wav_parse.argtypes = [ctypes.c_char_p, u64,
                                     ctypes.POINTER(u32), ctypes.POINTER(u32),
                                     ctypes.POINTER(u32), ctypes.POINTER(u32),
                                     ctypes.POINTER(u64), ctypes.POINTER(u64)]
        lib.cq_wav_decode.restype = ctypes.c_int
        lib.cq_wav_decode.argtypes = [ctypes.c_char_p, u64, u32, u32, u32,
                                      ctypes.POINTER(ctypes.c_double),
                                      ctypes.POINTER(u64)]
        lib.cq_ring_create.restype = ctypes.c_void_p
        lib.cq_ring_create.argtypes = [u64]
        lib.cq_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.cq_ring_available_read.restype = u64
        lib.cq_ring_available_read.argtypes = [ctypes.c_void_p]
        lib.cq_ring_available_write.restype = u64
        lib.cq_ring_available_write.argtypes = [ctypes.c_void_p]
        lib.cq_ring_push.restype = u64
        lib.cq_ring_push.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_double), u64]
        lib.cq_ring_pop.restype = u64
        lib.cq_ring_pop.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_double), u64]
        lib.cq_mpsc_create.restype = ctypes.c_void_p
        lib.cq_mpsc_create.argtypes = [u64, u64]
        lib.cq_mpsc_destroy.argtypes = [ctypes.c_void_p]
        lib.cq_mpsc_push.restype = ctypes.c_int
        lib.cq_mpsc_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cq_mpsc_pop.restype = ctypes.c_int
        lib.cq_mpsc_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cq_mpsc_size_approx.restype = u64
        lib.cq_mpsc_size_approx.argtypes = [ctypes.c_void_p]
        lib.cq_deinterleave_f32_to_f64.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
            u64, u32, ctypes.c_double]
        lib.cq_interleave_f64_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
            u64, u32, ctypes.c_double]
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.cq_sched_create.restype = ctypes.c_void_p
        lib.cq_sched_create.argtypes = [u32, u32, ctypes.c_double, u32,
                                        ctypes.c_double]
        lib.cq_sched_destroy.argtypes = [ctypes.c_void_p]
        lib.cq_sched_push.restype = ctypes.c_int
        lib.cq_sched_push.argtypes = [ctypes.c_void_p, u32, f32p]
        lib.cq_sched_gather.restype = u32
        lib.cq_sched_gather.argtypes = [ctypes.c_void_p, f32p, u8p]
        lib.cq_sched_commit.argtypes = [ctypes.c_void_p, f32p, u8p, u64]
        lib.cq_sched_pop.restype = ctypes.c_int
        lib.cq_sched_pop.argtypes = [ctypes.c_void_p, u32, f32p]
        lib.cq_sched_in_ready.restype = u32
        lib.cq_sched_in_ready.argtypes = [ctypes.c_void_p, u32]
        dp = ctypes.POINTER(ctypes.c_double)
        u64p = ctypes.POINTER(u64)
        lib.cq_sched_stats.argtypes = [ctypes.c_void_p, u64p, u64p, u64p,
                                       u64p, u64p, dp, dp, dp]
        _LIB = lib
        return lib


def read_wav_native(path):
    """Native WAV read -> (samples (C, N) float64, sample_rate)."""
    lib = load()
    data = Path(path).read_bytes()
    u32 = ctypes.c_uint32
    u64 = ctypes.c_uint64
    tag, ch, sr, bits = u32(), u32(), u32(), u32()
    off, nbytes = u64(), u64()
    rc = lib.cq_wav_parse(data, len(data), ctypes.byref(tag), ctypes.byref(ch),
                          ctypes.byref(sr), ctypes.byref(bits),
                          ctypes.byref(off), ctypes.byref(nbytes))
    if rc != 0:
        raise ValueError(f"{path}: not a valid WAV (rc={rc})")
    stride = (bits.value // 8) * ch.value
    if stride == 0:
        raise ValueError(
            f"{path}: malformed fmt chunk (channels={ch.value}, "
            f"bits={bits.value})")
    frames = nbytes.value // stride
    out = np.empty((ch.value, frames), np.float64)
    got = u64()
    rc = lib.cq_wav_decode(data[off.value:off.value + nbytes.value],
                           nbytes.value, tag.value, ch.value, bits.value,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                           ctypes.byref(got))
    if rc != 0:
        raise ValueError(f"{path}: unsupported WAV format (rc={rc})")
    return out[:, :got.value], int(sr.value)


class NativeRing:
    """SPSC lock-free ring of float64 (LockFreeRingBuffer analog)."""

    def __init__(self, capacity: int):
        self._lib = load()
        self._h = self._lib.cq_ring_create(capacity)
        if not self._h:
            raise ValueError("capacity must be a nonzero power of two")
        self.capacity = capacity

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cq_ring_destroy(self._h)
            self._h = None

    @property
    def readable(self):
        return self._lib.cq_ring_available_read(self._h)

    @property
    def writable(self):
        return self._lib.cq_ring_available_write(self._h)

    def push(self, arr) -> bool:
        arr = np.ascontiguousarray(arr, np.float64)
        n = self._lib.cq_ring_push(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            arr.size)
        return n == arr.size

    def pop(self, n: int):
        out = np.empty(n, np.float64)
        got = self._lib.cq_ring_pop(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        if got != n:
            return None
        return out


class NativeMpscRing:
    """Bounded MPSC ring of fixed-size byte records (MpscBoundedRing analog:
    Vyukov slots, multi-producer CAS push, single-consumer pop that never
    skips a producer hole).  push/pop move `elem_size`-byte bytes objects."""

    def __init__(self, capacity: int, elem_size: int):
        self._lib = load()
        self._h = self._lib.cq_mpsc_create(capacity, elem_size)
        if not self._h:
            raise ValueError("capacity must be a nonzero power of two")
        self.capacity = capacity
        self.elem_size = elem_size

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cq_mpsc_destroy(self._h)
            self._h = None

    def push(self, record: bytes) -> bool:
        if len(record) != self.elem_size:
            raise ValueError(f"record must be exactly {self.elem_size} bytes")
        buf = ctypes.create_string_buffer(record, self.elem_size)
        return bool(self._lib.cq_mpsc_push(self._h, buf))

    def pop(self) -> bytes | None:
        buf = ctypes.create_string_buffer(self.elem_size)
        if not self._lib.cq_mpsc_pop(self._h, buf):
            return None
        return buf.raw

    @property
    def size_approx(self) -> int:
        return self._lib.cq_mpsc_size_approx(self._h)


def deinterleave(interleaved_f32, channels: int, gain: float = 1.0):
    lib = load()
    x = np.ascontiguousarray(interleaved_f32, np.float32)
    frames = x.size // channels
    out = np.empty((channels, frames), np.float64)
    lib.cq_deinterleave_f32_to_f64(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        frames, channels, gain)
    return out


def interleave(planar_f64, gain: float = 1.0):
    lib = load()
    x = np.ascontiguousarray(planar_f64, np.float64)
    channels, frames = x.shape
    out = np.empty(frames * channels, np.float32)
    lib.cq_interleave_f64_to_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, gain)
    return out


class NativeBlockScheduler:
    """Serving front-end: per-stream SPSC input/output rings of stereo
    blocks + one dispatcher that gathers a (n_streams, 2, block) batch,
    with native deadline/XRUN accounting (native/convopeq_native.cpp
    cq_sched_*; reference analog: the audio-callback plane of
    AudioEngine.Processing.BlockDouble.cpp with the 1.5x-budget XRUN
    contract, ARCHITECTURE.md:397)."""

    def __init__(self, n_streams: int, block: int, sample_rate: float,
                 capacity_blocks: int = 64, xrun_factor: float = 1.5):
        self._lib = load()
        self._h = self._lib.cq_sched_create(
            n_streams, block, float(sample_rate), capacity_blocks,
            float(xrun_factor))
        if not self._h:
            raise NativeUnavailable(
                "cq_sched_create failed (capacity must be a power of two)")
        self.n_streams = n_streams
        self.block = block
        self._f32p = ctypes.POINTER(ctypes.c_float)
        self._u8p = ctypes.POINTER(ctypes.c_uint8)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cq_sched_destroy(h)
            self._h = None

    def push(self, stream: int, block2ch) -> bool:
        """Producer: push one (2, block) float block into a stream."""
        b = np.ascontiguousarray(block2ch, np.float32)
        if b.shape != (2, self.block):
            raise ValueError(f"expected (2, {self.block}), got {b.shape}")
        return bool(self._lib.cq_sched_push(
            self._h, stream, b.ctypes.data_as(self._f32p)))

    def gather(self, batch=None):
        """Dispatcher: (batch (n_streams, 2, block) f32, ready mask, n).
        batch: the buffer to gather into (contiguous float32 of that
        shape, e.g. the NumPy view of a pinned tensor), a fresh one when
        None."""
        shape = (self.n_streams, 2, self.block)
        if batch is None:
            batch = np.empty(shape, np.float32)
        elif batch.shape != shape or batch.dtype != np.float32 or \
                not batch.flags.c_contiguous:
            raise ValueError(f"batch must be contiguous float32 {shape}")
        mask = np.empty(self.n_streams, np.uint8)
        n = self._lib.cq_sched_gather(
            self._h, batch.ctypes.data_as(self._f32p),
            mask.ctypes.data_as(self._u8p))
        return batch, mask, int(n)

    def commit(self, ybatch, mask, wall_ns: int):
        y = np.ascontiguousarray(ybatch, np.float32)
        m = np.ascontiguousarray(mask, np.uint8)
        self._lib.cq_sched_commit(self._h, y.ctypes.data_as(self._f32p),
                                  m.ctypes.data_as(self._u8p), int(wall_ns))

    def pop(self, stream: int):
        """Consumer: pop one processed (2, block) f32 block or None."""
        out = np.empty((2, self.block), np.float32)
        if not self._lib.cq_sched_pop(self._h, stream,
                                      out.ctypes.data_as(self._f32p)):
            return None
        return out

    def in_ready(self, stream: int) -> int:
        return int(self._lib.cq_sched_in_ready(self._h, stream))

    def stats(self) -> dict:
        u64 = ctypes.c_uint64
        d = ctypes.c_double
        served, under, xr, ovf, drop = u64(), u64(), u64(), u64(), u64()
        avg, mx, budget = d(), d(), d()
        self._lib.cq_sched_stats(
            self._h, ctypes.byref(served), ctypes.byref(under),
            ctypes.byref(xr), ctypes.byref(ovf), ctypes.byref(drop),
            ctypes.byref(avg), ctypes.byref(mx), ctypes.byref(budget))
        return {"served_blocks": served.value, "underruns": under.value,
                "xruns": xr.value, "in_overflows": ovf.value,
                "out_drops": drop.value, "avg_wall_ms": avg.value,
                "max_wall_ms": mx.value, "budget_ms": budget.value}
