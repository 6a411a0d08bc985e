"""Spearmint-style Gaussian-process Bayesian optimization (Snoek et al. 2012).

Pure-numpy GP (Matérn 5/2 on the unit cube, Cholesky solve) + Expected
Improvement, maximized over a random candidate sweep.  Parallel proposals use
the *kriging believer* heuristic: pending points are imputed with the GP mean
so simultaneous workers do not pile onto the same optimum.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from . import Proposer, register


def _matern52(X1: np.ndarray, X2: np.ndarray, ls: float) -> np.ndarray:
    d = np.sqrt(np.maximum(((X1[:, None, :] - X2[None, :, :]) ** 2).sum(-1), 1e-30)) / ls
    s5 = math.sqrt(5.0)
    return (1.0 + s5 * d + 5.0 / 3.0 * d * d) * np.exp(-s5 * d)


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    # erf-based CDF (no scipy in this container)
    from math import erf

    return np.vectorize(lambda t: 0.5 * (1.0 + erf(t / math.sqrt(2.0))))(z)


class _GP:
    def __init__(self, ls: float = 0.25, noise: float = 1e-4):
        self.ls, self.noise = ls, noise
        self.X: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> None:
        self.X = X
        self.ymean, self.ystd = float(y.mean()), float(y.std() + 1e-9)
        yn = (y - self.ymean) / self.ystd
        K = _matern52(X, X, self.ls) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(self.L.T, np.linalg.solve(self.L, yn))

    def predict(self, Xs: np.ndarray):
        Ks = _matern52(Xs, self.X, self.ls)
        mu = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
        return mu * self.ystd + self.ymean, np.sqrt(var) * self.ystd


@register("spearmint")
@register("gp")
class GPBayesianProposer(Proposer):
    """``n_init`` random warmup points, then EI over ``n_candidates`` samples."""

    def __init__(self, space, n_init: int = 8, n_candidates: int = 2048,
                 length_scale: float = 0.25, **kwargs):
        super().__init__(space, **kwargs)
        self.n_init = int(n_init)
        self.n_candidates = int(n_candidates)
        self.gp = _GP(ls=float(length_scale))
        self._pending: List[np.ndarray] = []

    def _propose(self) -> Optional[Dict[str, Any]]:
        if self.n_proposed >= self.n_samples:
            return None
        if len(self.history) < self.n_init:
            cfg = self.space.sample(self.rng)
            self._pending.append(self.space.to_unit(cfg))
            return cfg

        X = np.array([self.space.to_unit(h["config"]) for h in self.history])
        y = np.array([h["score"] for h in self.history])
        # kriging believer: impute pending points at the current GP mean
        if self._pending:
            gp0 = _GP(self.gp.ls)
            gp0.fit(X, y)
            P = np.array(self._pending)
            mu_p, _ = gp0.predict(P)
            X = np.vstack([X, P])
            y = np.concatenate([y, mu_p])
        self.gp.fit(X, y)

        cand = self.rng.uniform(size=(self.n_candidates, len(self.space)))
        # densify around the incumbent (local exploitation)
        best_x = X[int(np.argmax(y))]
        local = np.clip(best_x + 0.05 * self.rng.standard_normal((self.n_candidates // 4, len(self.space))), 0, 1)
        cand = np.vstack([cand, local])

        mu, sigma = self.gp.predict(cand)
        f_best = float(y.max())
        z = (mu - f_best) / sigma
        ei = (mu - f_best) * _norm_cdf(z) + sigma * _norm_pdf(z)
        x = cand[int(np.argmax(ei))]
        self._pending.append(x)
        return self.space.from_unit(x)

    def _on_result(self, config: Dict[str, Any], score: float) -> None:
        self._drop_pending(config)

    def _on_failure(self, config: Dict[str, Any]) -> None:
        self._drop_pending(config)

    def _drop_pending(self, config: Dict[str, Any]) -> None:
        try:
            x = self.space.to_unit(config)
        except (KeyError, ValueError):
            return
        for i, p in enumerate(self._pending):
            if np.allclose(p, x, atol=1e-9):
                self._pending.pop(i)
                return
