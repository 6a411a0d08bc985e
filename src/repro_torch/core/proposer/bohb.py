"""BOHB (Falkner et al. 2018) — Hyperband brackets + TPE-modeled sampling.

The paper's extensibility showcase: its authors integrated BOHB with 138 new
lines against HpBandSter's 4305.  Here the integration is a Hyperband subclass
that overrides one hook (``_sample_config``) with a TPE density-ratio model
fitted on the highest budget that has enough observations.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from . import register
from .hyperband import HyperbandProposer
from .tpe import _kde_logpdf


@register("bohb")
class BOHBProposer(HyperbandProposer):
    def __init__(self, space, min_points_in_model: int = None, gamma: float = 0.25,
                 n_candidates: int = 64, **kwargs):
        # set model params BEFORE super().__init__ — bracket construction
        # already calls the _sample_config hook.
        self.min_points = int(min_points_in_model or (len(space) + 2))
        self.gamma = float(gamma)
        self.n_candidates = int(n_candidates)
        self.history = []  # _sample_config may consult it during bracket build
        super().__init__(space, **kwargs)

    def _sample_config(self) -> Dict[str, Any]:
        obs = self._observations_at_best_budget()
        if len(obs) < self.min_points:
            return self.space.sample(self.rng)
        X = np.array([self.space.to_unit(c) for c, _ in obs])
        y = np.array([s for _, s in obs])
        n_good = max(1, int(np.ceil(self.gamma * len(y))))
        order = np.argsort(-y)
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
            if len(bad):
                score -= _kde_logpdf(cand[:, j], bad[:, j], bw)
        return self.space.from_unit(cand[int(np.argmax(score))])

    def _observations_at_best_budget(self):
        """(config, score) pairs at the largest budget with >= min_points obs."""
        by_budget: Dict[int, list] = {}
        for h in self.history:
            b = int(h["config"].get("n_iterations", 0))
            by_budget.setdefault(b, []).append((h["config"], h["score"]))
        for b in sorted(by_budget, reverse=True):
            if len(by_budget[b]) >= self.min_points:
                return by_budget[b]
        # fall back to pooling everything
        return [(h["config"], h["score"]) for h in self.history]
