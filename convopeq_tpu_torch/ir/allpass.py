"""Allpass cascade designer (counterpart of convopeq_tpu/ir/allpass.py; the
port's own host NumPy copy) — rebuild of src/AllpassDesigner.{h,cpp}.

Second-order allpass sections parameterized by pole (rho, theta):
  H(z) = (rho^2 - 2 rho cos(theta) z^-1 + z^-2)
         / (1 - 2 rho cos(theta) z^-1 + rho^2 z^-2)       (AllpassDesigner.h:17-47)
Group delay of one section (the designer's analytic form,
AllpassDesigner.cpp:340-357):
  tau(w) = (1-rho^2)/(1-2 rho cos(w-theta)+rho^2)
         + (1-rho^2)/(1-2 rho cos(w+theta)+rho^2)

Design: CMA-ES over unconstrained params x -> rho = 0.98*sigmoid(x),
theta = 0.99 pi * sigmoid(x) (cpp:238-251), cost = sqrt of the
1/sqrt(f+1)-weighted MSE between summed section group delay and the target
(weights normalized, bins above 0.499 fs down-weighted x0.1, cpp:308-360).
A numeric-gradient AdaGrad refinement stands in for the reference's
Greedy+AdaGrad path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cmaes import CmaEs, CmaEsParams

K_THETA_MAX = 0.99 * np.pi
K_RHO_MAX = 0.98


def _sigmoid(x):
    return np.where(x >= 0, 1.0 / (1.0 + np.exp(-x)),
                    np.exp(x) / (1.0 + np.exp(x)))


def unconstrained_to_rho(x):
    return K_RHO_MAX * _sigmoid(x)


def unconstrained_to_theta(x):
    return K_THETA_MAX * _sigmoid(x)


@dataclass
class SecondOrderAllpass:
    rho: float = 0.0
    theta: float = 0.0

    def response(self, omega):
        """Unit-magnitude complex response (AllpassDesigner.h:25-47)."""
        z = np.exp(-1j * np.asarray(omega))
        a1 = -2.0 * self.rho * np.cos(self.theta)
        a2 = self.rho * self.rho
        num = a2 + a1 * z + z * z
        den = 1.0 + a1 * z + a2 * z * z
        den_mag = np.abs(den)
        den_safe = np.where(den_mag > 0, den / np.maximum(den_mag, 1e-300), 1.0) \
            * np.maximum(den_mag, 1e-12)
        h = num / den_safe
        mag = np.abs(h)
        return np.where(mag > 1e-12, h / np.maximum(mag, 1e-300), 1.0)


def sections_group_delay(rhos, thetas, omega):
    """Summed analytic group delay of the cascade at omega (vectorized)."""
    omega = np.asarray(omega)[:, None]
    rho = np.asarray(rhos)[None, :]
    th = np.asarray(thetas)[None, :]
    rho2 = rho * rho
    num = 1.0 - rho2
    d1 = 1.0 - 2.0 * rho * np.cos(omega - th) + rho2
    d2 = 1.0 - 2.0 * rho * np.cos(omega + th) + rho2
    eps = 1e-12 * (1.0 + rho2)
    t = np.where(d1 > eps, num / d1, 0.0) + np.where(d2 > eps, num / d2, 0.0)
    return t.sum(axis=1)


def compute_response(sections, sample_rate, freq_hz):
    """computeResponse: product of section responses at freq_hz."""
    omega = 2.0 * np.pi * np.asarray(freq_hz) / sample_rate
    h = np.ones(len(omega), complex)
    for s in sections:
        h = h * s.response(omega)
    return h


@dataclass
class DesignerConfig:
    """AllpassDesignerConfig (AllpassDesigner.h:63-102)."""
    num_sections: int = 8
    freq_points: int = 512
    min_freq_hz: float = 20.0
    max_freq_hz: float = 20000.0
    max_iterations: int = 50
    learning_rate: float = 0.01
    cmaes_max_generations: int = 100
    cmaes_population: int = 32
    cmaes_initial_sigma: float = 0.3
    cmaes_seed: int = 0x434F4E564F4251
    cmaes_params: CmaEsParams = field(default_factory=lambda: CmaEsParams(
        sigma_min=1e-6, sigma_max=2.0, cov_retention_target=0.98,
        cov_retention_step=0.002))


def _cost_weights(freq_hz, sample_rate):
    w = 1.0 / np.sqrt(np.asarray(freq_hz) + 1.0)
    w = np.where(np.asarray(freq_hz) >= 0.499 * sample_rate, w * 0.1, w)
    return w / w.sum()


def _make_cost(freq_hz, target_gd, sample_rate, num_sections):
    omega = 2.0 * np.pi * np.asarray(freq_hz) / sample_rate
    weights = _cost_weights(freq_hz, sample_rate)
    target = np.asarray(target_gd)

    def cost(x):
        rho = unconstrained_to_rho(x[0::2])
        th = unconstrained_to_theta(x[1::2])
        tau = sections_group_delay(rho, th, omega)
        d = tau - target
        return float(np.sqrt(np.sum(weights * d * d)))
    return cost


def _initial_mean(cfg: DesignerConfig, sample_rate):
    """Log-spaced theta seeding (AllpassDesigner.cpp:283-298)."""
    d = 2 * cfg.num_sections
    mean = np.zeros(d)
    log_min = np.log(cfg.min_freq_hz)
    log_max = np.log(cfg.max_freq_hz)
    for i in range(cfg.num_sections):
        f = np.exp(log_min + (log_max - log_min) * (i + 0.5) / cfg.num_sections)
        theta = 2.0 * np.pi * f / sample_rate
        t = np.clip(theta / K_THETA_MAX, 1e-6, 1.0 - 1e-6)
        mean[2 * i + 1] = np.log(t / (1.0 - t))
    return mean


def design_cmaes(sample_rate, freq_hz, target_gd, cfg: DesignerConfig):
    """designWithCMAES (AllpassDesigner.cpp:256-430).

    Returns (sections, cost) or (None, inf) on failure.
    """
    d = 2 * cfg.num_sections
    cost = _make_cost(freq_hz, target_gd, sample_rate, cfg.num_sections)
    opt = CmaEs(d, population=cfg.cmaes_population or 4 * d,
                elite=max(1, (cfg.cmaes_population or 4 * d) // 3),
                params=cfg.cmaes_params, seed=cfg.cmaes_seed)
    opt.init_mean(_initial_mean(cfg, sample_rate))
    if cfg.cmaes_initial_sigma > 0:
        opt.set_sigma(cfg.cmaes_initial_sigma)

    best, best_f = None, np.inf
    for _gen in range(cfg.cmaes_max_generations):
        cands = opt.sample()
        fit = np.array([cost(c) for c in cands])
        i = int(np.argmin(fit))
        if fit[i] < best_f:
            best_f = float(fit[i])
            best = cands[i].copy()
        opt.update(cands, fit)
    if best is None or not np.isfinite(best_f):
        return None, np.inf
    sections = [SecondOrderAllpass(float(unconstrained_to_rho(best[2 * i])),
                                   float(unconstrained_to_theta(best[2 * i + 1])))
                for i in range(cfg.num_sections)]
    return sections, best_f


def _section_gd_f0_gain(f0, gain, omega, sample_rate):
    """sectionGroupDelay (f0, gain) form (AllpassDesigner.cpp:228-232):
    rho = clamp(|gain|, 0, 0.995), theta = 2 pi f0 / fs."""
    rho = min(abs(gain), 0.995)
    theta = 2.0 * np.pi * f0 / sample_rate
    rho2 = rho * rho
    num = 1.0 - rho2
    d1 = 1.0 - 2.0 * rho * np.cos(omega - theta) + rho2
    d2 = 1.0 - 2.0 * rho * np.cos(omega + theta) + rho2
    eps = 1e-12 * (1.0 + rho2)
    return (np.where(d1 > eps, num / d1, 0.0)
            + np.where(d2 > eps, num / d2, 0.0))


def _freq_candidates(sample_rate):
    """buildFrequencyCandidates: 18 log-spaced 20 Hz .. min(20k, 0.499 fs)
    (AllpassDesigner.cpp:29-58)."""
    hi = max(20.0, min(20000.0, 0.499 * sample_rate))
    if hi <= 20.0:
        return np.array([20.0])
    t = np.arange(18) / 17.0
    return np.exp(np.log(20.0) + (np.log(hi) - np.log(20.0)) * t)


def _clamp_freq(sample_rate, f0):
    hi = max(20.0, min(20000.0, 0.499 * sample_rate))
    return float(np.clip(f0, 20.0, hi))


def design_greedy_adagrad(sample_rate, freq_hz, target_gd,
                          cfg: DesignerConfig):
    """The reference's deterministic Greedy+AdaGrad design path, exact
    (AllpassDesigner.cpp:465-590; pinned against the compiled reference
    binary by test_ref_vectors.py):

    per section: 2D grid search over 18 log-spaced f0 candidates x
    gains {.1,.3,.5,.7,.9,.95,.98} on the unweighted squared GD residual,
    then central-difference AdaGrad refinement of (f0, gain) with
    relative steps and early stop on non-improvement; the section's GD
    is subtracted from the residual.  Returns (sections, sq_cost).
    """
    omega = 2.0 * np.pi * np.asarray(freq_hz, float) / sample_rate
    residual = np.asarray(target_gd, float).copy()
    gain_candidates = np.array([0.1, 0.3, 0.5, 0.7, 0.9, 0.95, 0.98])
    f0_candidates = _freq_candidates(sample_rate)
    sections = []

    def err(f0, gain):
        d = _section_gd_f0_gain(f0, gain, omega, sample_rate) - residual
        return float(np.sum(d * d))

    for _sec in range(cfg.num_sections):
        # gridSearch2D (cpp:525-548)
        best_err, f0, gain = np.inf, 1000.0, 0.5
        for fc in f0_candidates:
            for gc in gain_candidates:
                e = err(fc, gc)
                if e < best_err:
                    best_err, f0, gain = e, float(fc), float(gc)
        # adaptiveGradientDescent (cpp:551-590)
        g2_f0, g2_gain, prev = 0.0, 0.0, np.inf
        for _it in range(cfg.max_iterations):
            e = err(f0, gain)
            if e >= prev:
                break
            prev = e
            eps_f0 = max(1.0e-3, abs(f0) * 1.0e-4)
            eps_g = float(np.clip(max(1.0e-6, abs(gain) * 1.0e-4),
                                  1.0e-6, 5.0e-3))
            gf = (err(f0 + eps_f0, gain) - err(f0 - eps_f0, gain)) \
                / (2.0 * eps_f0)
            gg = (err(f0, gain + eps_g) - err(f0, gain - eps_g)) \
                / (2.0 * eps_g)
            g2_f0 += gf * gf
            g2_gain += gg * gg
            f0 -= cfg.learning_rate * gf / (np.sqrt(g2_f0) + 1e-8)
            gain -= cfg.learning_rate * gg / (np.sqrt(g2_gain) + 1e-8)
            f0 = _clamp_freq(sample_rate, f0)
            gain = float(np.clip(gain, 0.0, 0.995))

        rho = min(abs(gain), 0.995)
        theta = 2.0 * np.pi * f0 / sample_rate
        sections.append(SecondOrderAllpass(rho, theta))
        residual -= np.asarray(
            sections_group_delay([rho], [theta], omega))

    return sections, float(np.sum(residual * residual))
