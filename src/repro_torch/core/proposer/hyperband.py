"""Hyperband (Li et al. 2018) — bandit-based budget allocation.

Auxiliary keys placed into each job's BasicConfig — ``n_iterations`` (budget),
``hb_bracket`` / ``hb_rung`` / ``hb_idx`` (position) and ``hb_key`` (stable
checkpoint key so jobs can resume a promoted config's training) — are exactly
the mechanism the paper describes in §III-A1/§III-A2 for Hyperband support.
Crash-resume rebuilds rung tables from these keys alone (``replay``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from . import Proposer, register


class _Rung:
    def __init__(self, size: int, budget: int):
        self.size = size              # how many configs run at this rung
        self.budget = budget          # n_iterations for this rung
        self.alive: List[int] = []    # config indices admitted to this rung
        self.issued: set = set()
        self.results: Dict[int, float] = {}

    def complete(self) -> bool:
        return len(self.results) >= len(self.alive) > 0


class _Bracket:
    def __init__(self, s: int, s_max: int, max_iter: int, eta: float, sampler, min_iter: int):
        self.s = s
        n = int(math.ceil((s_max + 1) / (s + 1) * eta ** s))
        r = max(min_iter, max_iter * eta ** (-s))
        self.base_configs = [sampler() for _ in range(n)]
        self.rungs: List[_Rung] = []
        for i in range(s + 1):
            n_i = max(1, int(n * eta ** (-i)))
            r_i = min(max_iter, int(round(r * eta ** i)))
            self.rungs.append(_Rung(n_i, max(min_iter, r_i)))
        self.rungs[0].alive = list(range(n))
        self.cur = 0

    def done(self) -> bool:
        return self.cur > self.s

    def total_jobs(self) -> int:
        return sum(r.size for r in self.rungs)


@register("hyperband")
class HyperbandProposer(Proposer):
    def __init__(self, space, max_iter: int = 27, min_iter: int = 1, eta: float = 3.0, **kwargs):
        super().__init__(space, **kwargs)
        self.max_iter = int(max_iter)
        self.min_iter = int(min_iter)
        self.eta = float(eta)
        self.s_max = int(math.floor(math.log(max(self.max_iter / max(self.min_iter, 1), 1.0)) / math.log(eta)))
        self.brackets = [
            _Bracket(s, self.s_max, self.max_iter, eta, self._sample_config, self.min_iter)
            for s in range(self.s_max, -1, -1)
        ]
        # Hyperband defines its own job count; override requested n_samples.
        self.n_samples = sum(b.total_jobs() for b in self.brackets)

    # Hook BOHB overrides to bias sampling with a model.
    def _sample_config(self) -> Dict[str, Any]:
        return self.space.sample(self.rng)

    def inflight_hook(self, steps_per_unit: int = 1):
        """Rung rule as an in-flight lane-truncation hook (population engines);
        see ``ASHAProposer.inflight_hook``."""
        from .early_stop import InFlightSuccessiveHalving

        return InFlightSuccessiveHalving(
            eta=self.eta,
            min_iter=self.min_iter * steps_per_unit,
            max_iter=self.max_iter * steps_per_unit,
        )

    def _active_bracket(self) -> Optional[_Bracket]:
        for b in self.brackets:
            if not b.done():
                return b
        return None

    def _propose(self) -> Optional[Dict[str, Any]]:
        b = self._active_bracket()
        while b is not None:
            rung = b.rungs[b.cur]
            for idx in rung.alive:
                if idx not in rung.issued and idx not in rung.results:
                    rung.issued.add(idx)
                    cfg = dict(b.base_configs[idx])
                    cfg.update(
                        n_iterations=rung.budget,
                        hb_bracket=b.s,
                        hb_rung=b.cur,
                        hb_idx=idx,
                        hb_key=f"b{b.s}c{idx}",
                    )
                    return cfg
            if rung.complete():
                self._promote(b)
                b = self._active_bracket()
                continue
            return None  # rung barrier: wait for callbacks
        return None

    def _promote(self, b: _Bracket) -> None:
        rung = b.rungs[b.cur]
        b.cur += 1
        if b.cur > b.s:
            return
        nxt = b.rungs[b.cur]
        ranked = sorted(rung.results.items(), key=lambda kv: -kv[1])
        nxt.alive = [idx for idx, _ in ranked[: nxt.size]]

    def _on_result(self, config: Dict[str, Any], score: float) -> None:
        self._record(config, score)

    def _on_failure(self, config: Dict[str, Any]) -> None:
        self._record(config, -math.inf)

    def _record(self, config: Dict[str, Any], score: float) -> None:
        s, rung_i, idx = config.get("hb_bracket"), config.get("hb_rung"), config.get("hb_idx")
        if s is None:
            return
        for b in self.brackets:
            if b.s == s:
                b.rungs[rung_i].results[idx] = score
                b.rungs[rung_i].issued.discard(idx)
                return

    def finished(self) -> bool:
        return all(b.done() for b in self.brackets)

    def replay(self, rows) -> None:
        # Re-seed sampling so base_configs regenerate identically, then replay
        # finished rows through the aux keys. Mid-flight rows re-issue naturally.
        for r in rows:
            if r.get("status") == "finished" and r.get("score") is not None:
                self.n_proposed += 1
                sc = float(r["score"]) if self.maximize else -float(r["score"])
                self.n_updated += 1
                self.history.append({"config": r["config"], "score": sc})
                self._record(r["config"], sc)
            elif r.get("status") in ("failed", "killed", "lost"):
                self.n_proposed += 1
                self.n_failed += 1
                self._record(r["config"], -math.inf)
        # advance through any rungs completed before the crash
        for b in self.brackets:
            while not b.done() and b.rungs[b.cur].complete():
                self._promote(b)
