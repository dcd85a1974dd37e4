"""Simple peak limiter (counterpart of convopeq_tpu/ops/limiter.py;
src/audioengine/SimplePeakLimiter.h).

Zero-attack, adaptive-release peak limiter with a cubic soft knee:
  peak = max(|L|, |R|); clipStart = threshold - knee/2
  knee region:  g = 1 - (1 - threshold/peak) * t^2 (3 - 2t)
  above:        g = threshold / peak
  envelope: attack instant, release one-pole —
      env = g            if g < env
      env = 1 + (env-1)*releaseCoeff   otherwise
  releaseCoeff = exp(-1 / (sr * releaseSec))

With e = 1 - env and d = 1 - desiredGain the envelope is the max-plus
linear recurrence e[n] = max(d[n], r e[n-1]), evaluated by the port's
`associative_scan` (the tree of jax.lax.associative_scan) on the signal's
device: combine((a1, v1), (a2, v2)) = (a1 a2, max(v1 a2, v2)).
"""
from __future__ import annotations

import numpy as np
import torch

from .scan_iir import associative_scan


def _maxplus_combine(left, right):
    la, lv = left
    ra, rv = right
    return (la * ra, torch.maximum(lv * ra, rv))


def desired_gain(peak, threshold: float, knee: float):
    """The soft-knee gain for a linked peak (any shape)."""
    clip_start = threshold - knee * 0.5
    safe = torch.clamp(peak, min=1e-12)
    t = torch.clamp((safe - clip_start) / knee, 0.0, 1.0)
    ks = t * t * (3.0 - 2.0 * t)
    g_knee = 1.0 - (1.0 - threshold / safe) * ks
    g_lim = threshold / safe
    g = torch.where(safe <= threshold, g_knee, g_lim)
    return torch.where(safe > clip_start, g, torch.ones_like(g))


def peak_limiter(x, sample_rate: float, threshold: float = 0.8912509381337456,
                 knee: float = 0.122, release_ms: float = 100.0, env0=None,
                 exact: bool = False):
    """Limit (..., 2, N) stereo (linked channels).  Returns (y, env_final).

    env0: optional (...,) initial envelope (1.0 = no reduction).
    exact=False runs the parallel max-plus scan, which deviates from the
    reference's branchy release only by single-sample dips of magnitude
    <= (1 - releaseCoeff) at attack/release crossings (~2e-4 of the gain
    at 100 ms / 48 kHz).  exact=True runs the branch-exact recurrence as
    a Python loop over the samples, one small tensor op each: for tests
    and short buffers, not for long signals."""
    x = torch.as_tensor(x)
    dt = x.dtype
    r = float(np.exp(-1.0 / (sample_rate * release_ms * 0.001))) \
        if release_ms > 0.0 and sample_rate > 0.0 else 0.0

    peak = x.abs().amax(dim=-2)                       # (..., N)
    d = 1.0 - desired_gain(peak, threshold, knee)     # e-domain drive
    batch = d.shape[:-1]
    if env0 is None:
        e0 = torch.zeros(batch, dtype=dt, device=x.device)
    else:
        e0 = 1.0 - torch.as_tensor(env0, dtype=dt, device=x.device)

    if exact:
        e_n = e0
        es = []
        for dn in d.unbind(-1):
            e_n = torch.where(dn > e_n, dn, r * e_n)
            es.append(e_n)
        e = torch.stack(es, dim=-1)
    else:
        a = torch.full_like(d, r)
        am, vm = associative_scan(_maxplus_combine, (a, d))
        # include the initial state: e[n] = max(vm[n], e0 * am[n])
        e = torch.maximum(vm, e0.unsqueeze(-1) * am)
    env = 1.0 - e
    return x * env.unsqueeze(-2), env[..., -1]
