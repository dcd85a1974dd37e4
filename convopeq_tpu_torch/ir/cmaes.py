"""CMA-ES optimizers (counterpart of convopeq_tpu/ir/cmaes.py; the port's
own host NumPy copy) — rebuild of src/CmaEsOptimizer.h and
src/CmaEsOptimizerDynamic.cpp.

Simplified elite-mean CMA-ES variant used by the reference:
- fixed variant: kDim=9, kPopulation=18, kElite=6, sigma in [0.03, 0.30]
  (CmaEsOptimizer.h:14-20)
- sampling: x = mean + sigma * L z, L = Cholesky(C) (h:107-129)
- update (h:131-193): new mean = elite average; covariance
  C <- r C + (1-r)/elite * sum(y y^T), y = (x - oldMean)/sigma, with the
  retention r ramping to covRetentionTarget; sigma = clamp(sqrt(elite
  variance around the new mean / (elite*dim)), sigmaMin, sigmaMax)
- parcor mapping: tanh / atanh with clamp +-0.995 (h:195-216)
- sanitize: non-finite or |x| < 1e-15 -> 0.

Host-side NumPy (the reference runs this on worker threads).  Sampling
draws from np.random.default_rng(seed), as the JAX package does, so the
same seed gives the same candidates and designs in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _sanitize(x):
    x = np.where(np.isfinite(x), x, 0.0)
    return np.where(np.abs(x) < 1e-15, 0.0, x)


@dataclass
class CmaEsParams:
    sigma_min: float = 0.03
    sigma_max: float = 0.30
    cov_retention_target: float = 0.92
    cov_retention_step: float = 0.0


class CmaEs:
    """Dynamic-dimension variant (CmaEsOptimizerDynamic); the fixed 9-dim
    noise-shaper learner uses dim=9, population=18, elite=6."""

    def __init__(self, dim: int, population: int | None = None,
                 elite: int | None = None, params: CmaEsParams | None = None,
                 seed: int = 0):
        self.dim = dim
        self.population = population if population else max(4, 2 * dim)
        self.elite = elite if elite else max(1, self.population // 3)
        self.params = params or CmaEsParams()
        self.rng = np.random.default_rng(seed)
        self.mean = np.zeros(dim)
        self.cov = np.eye(dim)
        self.sigma = 0.12
        # Starts AT the target, exactly like the reference
        # (CmaEsOptimizer.h:103, Dynamic.cpp:33/68): the per-generation
        # min(target, retention+step) ramp therefore only engages when a
        # caller RAISES the target mid-run — the learner's phase
        # transitions do (models/learner.py::_apply_phase); a fixed-target
        # run (e.g. the allpass designer) never ramps, by design.
        self.cov_retention = self.params.cov_retention_target

    def set_sigma(self, s: float):
        self.sigma = float(np.clip(s, self.params.sigma_min,
                                   self.params.sigma_max))

    def init_mean(self, mean):
        self.mean = np.asarray(mean, np.float64).copy()
        self.sigma = 0.12
        self.cov_retention = self.params.cov_retention_target
        self.cov = np.eye(self.dim)

    def _cholesky(self):
        try:
            return np.linalg.cholesky(
                self.cov + 1e-12 * np.eye(self.dim))
        except np.linalg.LinAlgError:
            self.cov = np.eye(self.dim)
            return np.eye(self.dim)

    def sample(self):
        L = self._cholesky()
        z = self.rng.standard_normal((self.population, self.dim))
        return _sanitize(self.mean + self.sigma * z @ L.T)

    def update(self, candidates, fitness):
        candidates = np.asarray(candidates)
        order = np.argsort(fitness, kind="stable")
        elite = candidates[order[:self.elite]]
        old_mean = self.mean.copy()
        new_mean = elite.mean(axis=0)

        self.cov_retention = min(self.params.cov_retention_target,
                                 self.cov_retention + self.params.cov_retention_step)
        y = (elite - old_mean) / self.sigma
        elite_cov = y.T @ y
        self.cov = _sanitize(self.cov_retention * self.cov
                             + (1.0 - self.cov_retention) / self.elite * elite_cov)

        variance = float(((elite - new_mean) ** 2).sum())
        self.mean = _sanitize(new_mean)
        self.sigma = float(np.clip(
            np.sqrt(variance / (self.elite * self.dim)),
            self.params.sigma_min, self.params.sigma_max))

    # Parcor mapping (used by the noise-shaper learner)
    @staticmethod
    def to_parcor(unconstrained):
        return _sanitize(np.tanh(unconstrained))

    @staticmethod
    def parcor_to_unconstrained(v):
        v = np.clip(v, -0.995, 0.995)
        return 0.5 * np.log((1.0 + v) / (1.0 - v))


def minimize(cost_fn, dim, generations=100, population=None, elite=None,
             params=None, initial_mean=None, initial_sigma=None, seed=0):
    """Run the CMA-ES loop; returns (best_params, best_fitness)."""
    opt = CmaEs(dim, population, elite, params, seed)
    if initial_mean is not None:
        opt.init_mean(initial_mean)
    if initial_sigma is not None:
        opt.set_sigma(initial_sigma)
    best = None
    best_f = np.inf
    for _ in range(generations):
        cands = opt.sample()
        fit = np.array([cost_fn(c) for c in cands])
        i = int(np.argmin(fit))
        if fit[i] < best_f:
            best_f = float(fit[i])
            best = cands[i].copy()
        opt.update(cands, fit)
    return best, best_f
