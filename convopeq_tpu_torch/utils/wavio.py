"""WAV file I/O (counterpart of convopeq_tpu/utils/wavio.py): `read_wav`
through the native C++ parser (utils/native.py), `read_wav_numpy`, the
port's own copy of the JAX package's NumPy parser, as its plain version,
and the NumPy writer.

Supports PCM 16/24/32-bit and IEEE float32/float64, mono or multichannel —
enough to read the reference's `sampledata/` fixtures (float32 and 16-bit
PCM 48 kHz WAVs) and to write processed output.  Replaces the reference's
JUCE AudioFormatReader usage (ref: src/convolver/ConvolverProcessor.LoaderThread.cpp).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavData:
    samples: np.ndarray  # float64, shape (channels, frames), range [-1, 1]
    sample_rate: int


def read_wav(path) -> WavData:
    """The samples of a RIFF/WAVE file as float64 (channels, frames) in
    [-1, 1], and its rate, through the native C++ parser and decoder
    (utils/native.py, built at first use; a failed build raises).  Its
    plain version is `read_wav_numpy`, which the tests hold it to."""
    from .native import read_wav_native
    samples, sr = read_wav_native(path)
    return WavData(samples=samples, sample_rate=sr)


def read_wav_numpy(path) -> WavData:
    """`read_wav` in NumPy (the JAX package's parser, copied)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        chunk_size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            fmt = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    if len(fmt) < 16:
        raise ValueError(f"{path}: fmt chunk too short ({len(fmt)} bytes)")
    (tag, channels, sample_rate, _byte_rate, block_align,
     bits) = struct.unpack_from("<HHIIHH", fmt, 0)
    if tag == _WAVE_FORMAT_EXTENSIBLE:
        if len(fmt) < 26:
            raise ValueError(
                f"{path}: extensible fmt chunk too short ({len(fmt)} bytes)")
        tag = struct.unpack_from("<H", fmt, 24)[0]
    if channels == 0 or bits == 0 or block_align == 0:
        raise ValueError(
            f"{path}: malformed fmt chunk (channels={channels}, bits={bits}, "
            f"block_align={block_align})")

    frames = len(raw) // block_align
    raw = raw[:frames * block_align]

    if tag == _WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            dtype = np.float32
        elif bits == 64:
            dtype = np.float64
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
        x = np.frombuffer(raw, dtype=dtype).astype(np.float64)
    elif tag == _WAVE_FORMAT_PCM:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            u = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            u = np.where(u >= 1 << 23, u - (1 << 24), u)
            x = u.astype(np.float64) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {tag:#x}")

    x = x.reshape(frames, channels).T.copy()
    return WavData(samples=x, sample_rate=int(sample_rate))


def write_wav(path, samples: np.ndarray, sample_rate: int, bits: int = 32,
              float_format: bool = True) -> None:
    """Write (channels, frames) float data as WAV."""
    samples = np.asarray(samples, dtype=np.float64)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, frames = samples.shape
    interleaved = samples.T.reshape(-1)

    if float_format:
        if bits == 32:
            body = interleaved.astype("<f4").tobytes()
        elif bits == 64:
            body = interleaved.astype("<f8").tobytes()
        else:
            raise ValueError("float WAV must be 32 or 64 bit")
        tag = _WAVE_FORMAT_IEEE_FLOAT
    else:
        if bits == 16:
            q = np.clip(np.round(interleaved * 32768.0), -32768, 32767)
            body = q.astype("<i2").tobytes()
        elif bits == 24:
            q = np.clip(np.round(interleaved * 8388608.0), -8388608, 8388607)
            q = q.astype(np.int64)
            b = np.empty((q.size, 3), dtype=np.uint8)
            b[:, 0] = q & 0xFF
            b[:, 1] = (q >> 8) & 0xFF
            b[:, 2] = (q >> 16) & 0xFF
            body = b.tobytes()
        elif bits == 32:
            q = np.clip(np.round(interleaved * 2147483648.0), -2147483648, 2147483647)
            body = q.astype("<i4").tobytes()
        else:
            raise ValueError("PCM WAV must be 16, 24 or 32 bit")
        tag = _WAVE_FORMAT_PCM

    block_align = channels * bits // 8
    byte_rate = sample_rate * block_align
    fmt = struct.pack("<HHIIHH", tag, channels, sample_rate, byte_rate,
                      block_align, bits)
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<I", len(fmt)))
        f.write(fmt)
        f.write(b"data")
        f.write(struct.pack("<I", len(body)))
        f.write(body)
