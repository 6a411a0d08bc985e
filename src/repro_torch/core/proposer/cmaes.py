"""CMA-ES proposer (beyond-paper addition — the paper's intro cites
evolutionary tuning [Friedrichs & Igel 2005] as a major HPO family).

Generation-synchronous (μ/μ_w, λ)-CMA-ES in the search space's unit cube:
propose λ offspring, wait for all scores (same barrier pattern as PBT/EAS),
then update the mean with the weighted top-μ, adapt the step size via
cumulative path length, and adapt a diagonal covariance (sep-CMA — full
covariance buys little at the ≤10 dims typical of HPO and diagonal keeps
the update O(d)).  Choice dims ride along through the unit-cube encoding.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from . import Proposer, register


@register("cmaes")
@register("evolution")
class CMAESProposer(Proposer):
    def __init__(self, space, popsize: int = 0, sigma0: float = 0.3, **kwargs):
        super().__init__(space, **kwargs)
        d = max(len(space), 1)
        self.lam = int(popsize) or (4 + int(3 * math.log(d)))
        self.mu = self.lam // 2
        # log-linear recombination weights
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mu_eff = 1.0 / float((self.w ** 2).sum())
        # step-size / covariance time constants (Hansen's defaults, diag variant)
        self.c_sigma = (self.mu_eff + 2) / (d + self.mu_eff + 5)
        self.d_sigma = 1 + 2 * max(0.0, math.sqrt((self.mu_eff - 1) / (d + 1)) - 1) + self.c_sigma
        self.c_c = (4 + self.mu_eff / d) / (d + 4 + 2 * self.mu_eff / d)
        self.c_1 = 2 / ((d + 1.3) ** 2 + self.mu_eff)
        self.c_mu = min(1 - self.c_1, 2 * (self.mu_eff - 2 + 1 / self.mu_eff) / ((d + 2) ** 2 + self.mu_eff))
        self.chi_n = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))

        self.d = d
        self.mean = np.full(d, 0.5)
        self.sigma = float(sigma0)
        self.diag_c = np.ones(d)          # diagonal covariance
        self.p_sigma = np.zeros(d)
        self.p_c = np.zeros(d)
        self.gen = 0
        self.n_generations = max(1, self.n_samples // self.lam)
        self.n_samples = self.lam * self.n_generations
        self.offspring: List[np.ndarray] = []
        self.gen_results: Dict[int, float] = {}

    def _propose(self) -> Optional[Dict[str, Any]]:
        if self.gen >= self.n_generations:
            return None
        if len(self.offspring) < self.lam:
            z = self.rng.standard_normal(self.d)
            y = np.sqrt(self.diag_c) * z
            u = np.clip(self.mean + self.sigma * y, 0.0, 1.0)
            idx = len(self.offspring)
            self.offspring.append(u)
            cfg = self.space.from_unit(u)
            cfg.update(cma_gen=self.gen, cma_idx=idx)
            return cfg
        if len(self.gen_results) >= self.lam:
            self._update()
            return self._propose()
        return None  # generation barrier

    def _update(self) -> None:
        ranked = sorted(self.gen_results.items(), key=lambda kv: -kv[1])
        elite = [self.offspring[i] for i, _ in ranked[: self.mu]]
        old_mean = self.mean
        self.mean = np.clip(sum(w * e for w, e in zip(self.w, elite)), 0.0, 1.0)
        y_w = (self.mean - old_mean) / max(self.sigma, 1e-12)

        c_inv_sqrt = 1.0 / np.sqrt(np.maximum(self.diag_c, 1e-12))
        self.p_sigma = (1 - self.c_sigma) * self.p_sigma + math.sqrt(
            self.c_sigma * (2 - self.c_sigma) * self.mu_eff
        ) * c_inv_sqrt * y_w
        self.sigma *= math.exp(
            (self.c_sigma / self.d_sigma)
            * (np.linalg.norm(self.p_sigma) / self.chi_n - 1)
        )
        self.sigma = float(np.clip(self.sigma, 1e-6, 1.0))

        h_sigma = float(
            np.linalg.norm(self.p_sigma)
            / math.sqrt(1 - (1 - self.c_sigma) ** (2 * (self.gen + 1)))
            < (1.4 + 2 / (self.d + 1)) * self.chi_n
        )
        self.p_c = (1 - self.c_c) * self.p_c + h_sigma * math.sqrt(
            self.c_c * (2 - self.c_c) * self.mu_eff
        ) * y_w
        rank_mu = np.zeros(self.d)
        for w, e in zip(self.w, elite):
            ye = (e - old_mean) / max(self.sigma, 1e-12)
            rank_mu += w * ye * ye
        self.diag_c = (
            (1 - self.c_1 - self.c_mu) * self.diag_c
            + self.c_1 * self.p_c * self.p_c
            + self.c_mu * rank_mu
        )
        self.diag_c = np.clip(self.diag_c, 1e-8, 1e4)

        self.gen += 1
        self.offspring, self.gen_results = [], {}

    def _on_result(self, config: Dict[str, Any], score: float) -> None:
        if config.get("cma_gen") == self.gen:
            self.gen_results[config["cma_idx"]] = score

    def _on_failure(self, config: Dict[str, Any]) -> None:
        self._on_result(config, float("-inf"))
