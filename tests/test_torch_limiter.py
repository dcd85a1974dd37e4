"""The port's peak limiter (convopeq_tpu_torch/ops/limiter.py) against
the JAX package's, both forms, on the same seeded inputs on the CPU, and
against the reference binary's `misc` vectors (limiter_l, limiter_r) at
tests/test_ref_vectors.py's tolerances."""
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convopeq_tpu.ops import limiter as jl
from convopeq_tpu_torch.ops import limiter as tl

SR = 48000.0
VEC = Path(__file__).resolve().parent / "ref_harness" / "vectors"
THR, KNEE, REL = 0.891, 0.122, 100.0


def golden_limiter(L, R, sr, threshold, knee, release_ms):
    """SimplePeakLimiter's sample loop (tests/test_limiter.py)."""
    r = np.exp(-1.0 / (sr * release_ms * 0.001))
    clip_start = threshold - knee * 0.5
    env = 1.0
    outL, outR = np.empty_like(L), np.empty_like(R)
    for i in range(len(L)):
        safe = max(max(abs(L[i]), abs(R[i])), 1e-12)
        desired = 1.0
        if safe > clip_start:
            if safe <= threshold:
                t = (safe - clip_start) / knee
                desired = 1.0 - (1.0 - threshold / safe) * t * t * (3.0 - 2.0 * t)
            else:
                desired = threshold / safe
        env = desired if desired < env else 1.0 + (env - 1.0) * r
        outL[i], outR[i] = L[i] * env, R[i] * env
    return outL, outR, env


def _sig(n=4000, batch=()):
    t = np.arange(n) / SR
    burst = np.where((t > 0.02) & (t < 0.04), 2.0, 0.3)
    x = np.stack([burst * np.sin(2 * np.pi * 700 * t),
                  burst * np.sin(2 * np.pi * 900 * t)])
    if batch:
        scale = np.random.default_rng(8).uniform(0.5, 1.5, batch + (1, 1))
        x = x * scale
    return x


def test_exact_matches_golden():
    x = _sig()
    y, env = tl.peak_limiter(torch.from_numpy(x), SR, THR, KNEE, REL,
                             exact=True)
    gl, gr, genv = golden_limiter(x[0], x[1], SR, THR, KNEE, REL)
    np.testing.assert_allclose(y[0].numpy(), gl, atol=1e-13)
    np.testing.assert_allclose(y[1].numpy(), gr, atol=1e-13)
    assert abs(float(env) - genv) < 1e-13


@pytest.mark.parametrize("exact", [False, True])
def test_matches_jax(exact):
    """Both forms, a batch of 3 streams with a carried initial envelope,
    f64: equal to the JAX package's to rounding."""
    x = _sig(batch=(3,))
    env0 = np.array([1.0, 0.7, 0.95])
    yj, ej = jl.peak_limiter(jnp.asarray(x), SR, THR, KNEE, REL,
                             env0=jnp.asarray(env0), exact=exact)
    yt, et = tl.peak_limiter(torch.from_numpy(x), SR, THR, KNEE, REL,
                             env0=torch.from_numpy(env0), exact=exact)
    assert yt.shape == x.shape and et.shape == (3,)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=0,
                               atol=1e-14)


def test_max_plus_within_documented_bound_f32_and_f64():
    x = _sig()
    r = np.exp(-1.0 / (SR * REL * 0.001))
    y_e, _ = tl.peak_limiter(torch.from_numpy(x), SR, THR, KNEE, REL,
                             exact=True)
    for dt, extra in ((torch.float64, 0.0), (torch.float32, 1e-6)):
        y_f, _ = tl.peak_limiter(torch.from_numpy(x).to(dt), SR, THR, KNEE,
                                 REL)
        assert y_f.dtype == dt
        dev = np.abs(y_f.double().numpy() - y_e.numpy()).max()
        assert dev <= (1.0 - r) * np.abs(x).max() * 1.5 + extra, dev


def test_limits_peaks_and_carries_state():
    x = _sig()
    y, _ = tl.peak_limiter(torch.from_numpy(x), SR, THR, KNEE, REL)
    assert np.abs(y.numpy()).max() <= 0.9
    assert np.abs(y.numpy()[:, -100:]).max() > 0.15
    y_full, _ = tl.peak_limiter(torch.from_numpy(x), SR, exact=True)
    y1, e1 = tl.peak_limiter(torch.from_numpy(x[..., :2000]), SR, exact=True)
    y2, _ = tl.peak_limiter(torch.from_numpy(x[..., 2000:]), SR, env0=e1,
                            exact=True)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=-1).numpy(),
                               y_full.numpy(), atol=1e-13)


def test_peak_limiter_matches_reference_binary():
    """SimplePeakLimiter (dump_misc.cpp): exact form at 1e-14, the
    max-plus form within 5e-4 (tests/test_ref_vectors.py)."""
    v = json.loads((VEC / "misc.json").read_text())
    x = 1.15 * np.stack([np.asarray(v["input_l"]), np.asarray(v["input_r"])])
    thr, knee = 0.8912509381337456, 0.12202930310835076
    want = np.stack([np.asarray(v["limiter_l"]), np.asarray(v["limiter_r"])])
    y, _ = tl.peak_limiter(torch.from_numpy(x), 48000.0, threshold=thr,
                           knee=knee, release_ms=80.0, exact=True)
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-14)
    yp, _ = tl.peak_limiter(torch.from_numpy(x), 48000.0, threshold=thr,
                            knee=knee, release_ms=80.0)
    assert np.max(np.abs(yp.numpy() - want)) < 5e-4
