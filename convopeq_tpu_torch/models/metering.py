"""Metering (counterpart of convopeq_tpu/models/metering.py).

Ported here: the spectrum analyzer's STFT (SpectrumAnalyzerComponent.h:
66-95), 4096-point Hann-windowed frames with hop 1024 and magnitude
scale 2/N, bench config4's analyzer tap.  Loudness, true peak and the
analyzer's smoothing and peak hold are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

ANALYZER_FFT = 4096
ANALYZER_HOP = ANALYZER_FFT // 4
ANALYZER_MAG_SCALE = 2.0 / ANALYZER_FFT


def spectrum_frames(x, fft_size: int = ANALYZER_FFT, hop: int = ANALYZER_HOP):
    """Hann-windowed magnitude STFT frames (scale 2/N) of x (..., N):
    (..., nframes, fft_size // 2 + 1), a signal shorter than one frame
    zero-padded to it.  When hop divides fft_size the frames are the
    concatenation of fft_size / hop shifted contiguous slices of the
    (N / hop, hop)-reshaped signal (JAX :206-216); otherwise a strided
    view of x."""
    n = x.shape[-1]
    if n < fft_size:
        x = torch.nn.functional.pad(x, (0, fft_size - n))
        n = fft_size
    nf = (n - fft_size) // hop + 1
    if fft_size % hop == 0:
        m = n // hop
        r = x[..., :m * hop].reshape(x.shape[:-1] + (m, hop))
        frames = torch.cat([r[..., j:j + nf, :]
                            for j in range(fft_size // hop)], dim=-1)
    else:
        frames = x.unfold(-1, fft_size, hop)
    # juce::dsp::WindowingFunction hann (symmetric)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(fft_size)
                           / (fft_size - 1))
    spec = torch.fft.rfft(frames * torch.as_tensor(w, dtype=x.dtype,
                                                   device=x.device), dim=-1)
    return spec.abs() * ANALYZER_MAG_SCALE
