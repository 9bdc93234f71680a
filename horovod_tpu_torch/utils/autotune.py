"""Parameter manager with Bayesian-optimization autotuning.

Port of ``horovod_tpu/utils/autotune.py`` (numpy only, as there;
reference: horovod/common/parameter_manager.cc:28-66 and
horovod/common/optim/bayesian_optimization.cc, gaussian_process.cc): a
joint search over fusion threshold (MB) x cycle time (ms) scored by
allreduced bytes per second, with a GP and expected improvement. Every
rank runs the same deterministic search from the same seed, so the ranks
need no extra coordination; ``HOROVOD_AUTOTUNE`` (any truthy value but
``native``) runs it from ``core/session.py`` through the core's
``hvd_core_set_params``.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import numpy as np

# Search space matching the reference exactly: fusion 0-64 MB (0 = no
# fusion, every tensor ships alone) x cycle 1-100 ms
# (reference: parameter_manager.cc:28-66).
FUSION_MB_BOUNDS = (0.0, 64.0)
CYCLE_MS_BOUNDS = (1.0, 100.0)
WARMUP_SAMPLES = 3
STEPS_PER_SAMPLE = 10
MAX_SAMPLES = 20
GP_NOISE = 0.8


class GaussianProcess:
    """RBF-kernel GP regression (reference: gaussian_process.cc:1-183)."""

    def __init__(self, length_scale: float = 1.0, noise: float = GP_NOISE):
        self.length_scale = length_scale
        self.noise = noise
        self._X: Optional[np.ndarray] = None
        self._alpha = None
        self._L = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d / self.length_scale**2)

    def fit(self, X: np.ndarray, y: np.ndarray):
        self._X = np.asarray(X, float)
        self._y_mean = float(np.mean(y))
        y = np.asarray(y, float) - self._y_mean
        K = self._kernel(self._X, self._X)
        K[np.diag_indices_from(K)] += self.noise**2
        self._L = np.linalg.cholesky(K)
        self._alpha = np.linalg.solve(
            self._L.T, np.linalg.solve(self._L, y))

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        X = np.asarray(X, float)
        Ks = self._kernel(X, self._X)
        mu = Ks @ self._alpha + self._y_mean
        v = np.linalg.solve(self._L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-12, None)
        return mu, np.sqrt(var)


def _norm_cdf(x):
    return 0.5 * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0)))


def _norm_pdf(x):
    return np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


class BayesianOptimizer:
    """Expected-improvement search over a box
    (reference: bayesian_optimization.cc NextSample)."""

    def __init__(self, bounds: List[Tuple[float, float]], seed: int = 0,
                 xi: float = 0.01):
        self.bounds = np.asarray(bounds, float)
        self.xi = xi
        self._rng = np.random.RandomState(seed)
        self.X: List[np.ndarray] = []
        self.y: List[float] = []

    def _normalize(self, x):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (np.asarray(x, float) - lo) / (hi - lo)

    def _denormalize(self, u):
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + u * (hi - lo)

    def add_sample(self, x, y: float):
        self.X.append(self._normalize(x))
        self.y.append(float(y))

    def suggest(self) -> np.ndarray:
        if len(self.X) < 2:
            return self._denormalize(self._rng.rand(len(self.bounds)))
        gp = GaussianProcess(length_scale=0.3)
        ys = np.asarray(self.y)
        scale = ys.std() or 1.0
        gp.fit(np.stack(self.X), (ys - ys.mean()) / scale)
        best = (ys.max() - ys.mean()) / scale
        cands = self._rng.rand(256, len(self.bounds))
        mu, sigma = gp.predict(cands)
        imp = mu - best - self.xi
        z = imp / sigma
        ei = imp * _norm_cdf(z) + sigma * _norm_pdf(z)
        return self._denormalize(cands[int(np.argmax(ei))])


class ParameterManager:
    """Drives (fusion_mb, cycle_ms) from throughput scores
    (reference: parameter_manager.cc ParameterManager::Update).

    ``record(bytes)`` is called per completed step; every
    STEPS_PER_SAMPLE steps the bytes/sec score closes the current sample
    and the next candidate is proposed. After MAX_SAMPLES the best point
    is frozen. Deterministic: identical on every rank.
    """

    def __init__(self, set_params_fn, log_file: Optional[str] = None):
        self._set_params = set_params_fn
        self._bo = BayesianOptimizer([FUSION_MB_BOUNDS, CYCLE_MS_BOUNDS],
                                     seed=1234)
        self._current = np.array([
            float(os.environ.get("HOROVOD_FUSION_THRESHOLD",
                                 128 * 1024 * 1024)) / (1024 * 1024),
            float(os.environ.get("HOROVOD_CYCLE_TIME", 1.0))])
        self._steps = 0
        self._bytes = 0
        self._t0: Optional[float] = None
        self._samples = 0
        self._warmup_left = WARMUP_SAMPLES
        self.done = False
        self._log = open(log_file, "w") if log_file else None
        if self._log:
            self._log.write("sample,fusion_mb,cycle_ms,score_bytes_per_sec\n")

    def record(self, nbytes: int, now: float):
        if self.done:
            return
        if self._t0 is None:
            self._t0 = now
        self._bytes += nbytes
        self._steps += 1
        if self._steps < STEPS_PER_SAMPLE:
            return
        elapsed = max(now - self._t0, 1e-9)
        score = self._bytes / elapsed
        self._advance(score)
        self._steps = 0
        self._bytes = 0
        self._t0 = now

    def _advance(self, score: float):
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return
        self._samples += 1
        self._bo.add_sample(self._current, score)
        if self._log:
            self._log.write("%d,%.2f,%.2f,%.1f\n" % (
                self._samples, self._current[0], self._current[1], score))
            self._log.flush()
        if self._samples >= MAX_SAMPLES:
            best = self._bo.X[int(np.argmax(self._bo.y))]
            self._current = self._bo._denormalize(best)
            self.done = True
        else:
            self._current = self._bo.suggest()
        self._apply()

    def _apply(self):
        fusion_mb, cycle_ms = self._current
        # The box's 0 MB endpoint means "unfused"; the apply/staging
        # paths treat <=0 as "no update", so express it as a 1-byte
        # threshold — every tensor then closes its own bin, which IS
        # unfused semantics.
        fusion_bytes = max(int(fusion_mb * 1024 * 1024), 1)
        self._set_params(float(cycle_ms), fusion_bytes)

    @property
    def current(self):
        return tuple(self._current)
