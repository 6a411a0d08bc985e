"""Tree-structured Parzen Estimator (Bergstra et al. 2011) — Hyperopt's engine.

Observations are split at the ``gamma`` quantile into good/bad sets; each
dimension gets a 1-D Parzen (Gaussian KDE on the unit cube, categorical counts
for choices).  Candidates are drawn from the *good* density and ranked by the
density ratio l(x)/g(x).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from . import Proposer, register


def _kde_logpdf(x: np.ndarray, samples: np.ndarray, bw: float) -> np.ndarray:
    # x: (n,), samples: (m,) -> log mean_j N(x | s_j, bw^2), reflected at [0,1]
    if len(samples) == 0:
        return np.zeros_like(x)
    d = x[:, None] - samples[None, :]
    log_k = -0.5 * (d / bw) ** 2 - np.log(bw * np.sqrt(2 * np.pi))
    m = log_k.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(log_k - m).mean(axis=1, keepdims=True)))[:, 0]


@register("hyperopt")
@register("tpe")
class TPEProposer(Proposer):
    def __init__(self, space, n_init: int = 10, gamma: float = 0.25,
                 n_candidates: int = 64, engine: str = "tpe", **kwargs):
        super().__init__(space, **kwargs)
        if engine != "tpe":  # paper Code 2 passes {"engine": "tpe"} through
            raise ValueError(f"hyperopt proposer supports engine='tpe', got {engine!r}")
        self.n_init = int(n_init)
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)

    def _propose(self) -> Optional[Dict[str, Any]]:
        if self.n_proposed >= self.n_samples:
            return None
        if len(self.history) < self.n_init:
            return self.space.sample(self.rng)

        X = np.array([self.space.to_unit(h["config"]) for h in self.history])
        y = np.array([h["score"] for h in self.history])
        n_good = max(1, int(np.ceil(self.gamma * len(y))))
        order = np.argsort(-y)  # internal scores are always maximized
        good, bad = X[order[:n_good]], X[order[n_good:]]
        bw = max(0.08, 1.0 / max(2.0, np.sqrt(len(y))))

        dim = len(self.space)
        cand = np.empty((self.n_candidates, dim))
        for j in range(dim):
            centers = good[:, j]
            picks = centers[self.rng.integers(len(centers), size=self.n_candidates)]
            cand[:, j] = np.clip(picks + bw * self.rng.standard_normal(self.n_candidates), 0.0, 1.0)

        score = np.zeros(self.n_candidates)
        for j in range(dim):
            score += _kde_logpdf(cand[:, j], good[:, j], bw)
            score -= _kde_logpdf(cand[:, j], bad[:, j], bw) if len(bad) else 0.0
        return self.space.from_unit(cand[int(np.argmax(score))])
