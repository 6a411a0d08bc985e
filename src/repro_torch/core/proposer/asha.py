"""ASHA — Asynchronous Successive Halving (beyond-paper addition).

Hyperband's rung *barriers* waste parallel resources (exactly the Fig. 3
"last-job" effect the paper measures).  ASHA promotes asynchronously: a config
is promoted the moment it is in the top 1/eta of *completed* results at its
rung, so workers never idle at a barrier.  This is the proposer we pair with
the elastic mesh-slice pool: it tolerates stragglers and lost jobs natively.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

from . import Proposer, register


@register("asha")
class ASHAProposer(Proposer):
    def __init__(self, space, max_iter: int = 27, min_iter: int = 1, eta: float = 3.0, **kwargs):
        super().__init__(space, **kwargs)
        self.eta = float(eta)
        self.min_iter = int(min_iter)
        self.max_iter = int(max_iter)
        self.n_rungs = int(math.floor(math.log(max(max_iter / max(min_iter, 1), 1.0)) / math.log(eta))) + 1
        # rung k: results {cfg_idx: score}; promoted set
        self.rung_results: List[Dict[int, float]] = [dict() for _ in range(self.n_rungs)]
        self.promoted: List[set] = [set() for _ in range(self.n_rungs)]
        self.configs: List[Dict[str, Any]] = []
        self.outstanding = 0
        self.n_configs_target = self.n_samples  # new configs at rung 0
        # ASHA job count is dynamic; cap generously (promotions add jobs).
        self.n_samples = self.n_configs_target * self.n_rungs

    def _budget(self, rung: int) -> int:
        return min(self.max_iter, int(round(self.min_iter * self.eta ** rung)))

    def inflight_hook(self, steps_per_unit: int = 1):
        """Rung rule as an in-flight lane-truncation hook (population engines).

        Budgets/boundaries are scaled to raw train steps (``n_iterations`` is
        in budget units; a unit is ``steps_per_unit`` steps).  The hook shares
        no state with this proposer — thread-safe on the batch worker.
        """
        from .early_stop import InFlightSuccessiveHalving

        return InFlightSuccessiveHalving(
            eta=self.eta,
            min_iter=self.min_iter * steps_per_unit,
            max_iter=self.max_iter * steps_per_unit,
        )

    def _promotable(self) -> Optional[tuple]:
        for k in range(self.n_rungs - 1):
            res = self.rung_results[k]
            if not res:
                continue
            n_top = int(len(res) / self.eta)
            if n_top < 1:
                continue
            ranked = sorted(res.items(), key=lambda kv: -kv[1])
            for idx, _ in ranked[:n_top]:
                if idx not in self.promoted[k]:
                    return k, idx
        return None

    def _propose(self) -> Optional[Dict[str, Any]]:
        promo = self._promotable()
        if promo is not None:
            k, idx = promo
            self.promoted[k].add(idx)
            cfg = dict(self.configs[idx])
            cfg.update(n_iterations=self._budget(k + 1), asha_rung=k + 1,
                       asha_idx=idx, hb_key=f"a{idx}")
            self.outstanding += 1
            return cfg
        if len(self.configs) < self.n_configs_target:
            base = self.space.sample(self.rng)
            idx = len(self.configs)
            self.configs.append(base)
            cfg = dict(base)
            cfg.update(n_iterations=self._budget(0), asha_rung=0,
                       asha_idx=idx, hb_key=f"a{idx}")
            self.outstanding += 1
            return cfg
        return None  # drain

    def _on_result(self, config: Dict[str, Any], score: float) -> None:
        rung, idx = config.get("asha_rung"), config.get("asha_idx")
        if rung is not None and idx is not None:
            self.rung_results[rung][idx] = score
        self.outstanding = max(0, self.outstanding - 1)

    def _on_failure(self, config: Dict[str, Any]) -> None:
        rung, idx = config.get("asha_rung"), config.get("asha_idx")
        if rung is not None and idx is not None:
            self.rung_results[rung][idx] = -math.inf
        self.outstanding = max(0, self.outstanding - 1)

    def finished(self) -> bool:
        return (
            len(self.configs) >= self.n_configs_target
            and self.outstanding == 0
            and self._promotable() is None
        )

    def replay(self, rows) -> None:
        for r in rows:
            cfg = r["config"]
            idx = cfg.get("asha_idx")
            if idx is None:
                continue
            while len(self.configs) <= idx:
                # regenerate deterministically-shaped slot; base = cfg minus aux keys
                base = {k: v for k, v in cfg.items()
                        if k not in ("n_iterations", "asha_rung", "asha_idx", "hb_key", "job_id")}
                self.configs.append(base)
            rung = cfg.get("asha_rung", 0)
            if rung > 0:
                self.promoted[rung - 1].add(idx)
            if r.get("status") == "finished" and r.get("score") is not None:
                sc = float(r["score"]) if self.maximize else -float(r["score"])
                self.rung_results[rung][idx] = sc
                self.n_updated += 1
                self.n_proposed += 1
                self.history.append({"config": cfg, "score": sc})
            elif r.get("status") in ("failed", "killed", "lost"):
                self.rung_results[rung][idx] = -math.inf
                self.n_failed += 1
                self.n_proposed += 1
            elif r.get("status") == "running":
                # mid-flight at the crash: the Experiment re-queues it under a
                # new job id, so it stays outstanding here (its eventual result
                # decrements) and is never proposed a second time
                self.n_proposed += 1
                self.outstanding += 1
