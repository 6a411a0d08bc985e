"""Proposer interface (paper §III-A) + registry.

Every HPO algorithm is reduced to:

* ``get_param()``  -> next hyperparameter dict (or ``None`` == "wait": a rung /
  batch barrier is outstanding, ask again after a callback fires),
* ``update(score, job)`` -> feed one finished job's score back,
* ``finished()``   -> experiment is complete.

This is the paper's central extensibility claim — integrating a new algorithm
touches exactly one file (a subclass registered with ``@register``), which the
``benchmarks/extensibility_loc.py`` benchmark counts.

Auxiliary keys the proposer places in the config (``n_iterations``,
``hb_bracket``, ...) flow through the BasicConfig to the job and back —
the mechanism the paper uses so Hyperband can resume/extend training
(§III-A2).  ``replay(rows)`` rebuilds internal state from the tracking DB for
crash-resume; it relies only on those auxiliary keys, never on in-memory state.

Optional protocols: rung-based proposers (ASHA, Hyperband, BOHB) additionally
expose ``inflight_hook(steps_per_unit)`` returning a stateless-per-flight
early-stop rule the population engines apply *between* proposals — see
``early_stop.InFlightSuccessiveHalving``.  Lifecycle proposers (streaming
PBT) expose ``lifecycle_hook()`` returning the shared decision/registry
object (``pbt.PBTLifecycle``) the lane-refill engine and ``LaneScheduler``
consult on lane retirement and lease, so a losing member is refilled in
place as a donor-clone (compiled ``make_lane_clone``) instead of through a
host checkpoint.  The Experiment wires the hook onto targets exposing a
``lifecycle`` attribute automatically.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from ..search_space import SearchSpace

_REGISTRY: Dict[str, Type["Proposer"]] = {}


def register(name: str):
    def deco(cls: Type["Proposer"]) -> Type["Proposer"]:
        _REGISTRY[name.lower()] = cls
        cls.registry_name = name.lower()
        return cls
    return deco


def get_proposer_cls(name: str) -> Type["Proposer"]:
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown proposer {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_proposers() -> List[str]:
    return sorted(_REGISTRY)


def make_proposer(name: str, space: SearchSpace, **kwargs) -> "Proposer":
    return get_proposer_cls(name)(space=space, **kwargs)


class Proposer(abc.ABC):
    """Base class: bookkeeping shared by all algorithms."""

    registry_name = "base"

    def __init__(
        self,
        space: SearchSpace,
        n_samples: int = 100,
        seed: int = 0,
        maximize: bool = True,
        **_unused: Any,
    ):
        self.space = space
        self.n_samples = int(n_samples)
        self.maximize = bool(maximize)
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self.n_proposed = 0
        self.n_updated = 0
        self.n_failed = 0
        self.history: List[Dict[str, Any]] = []  # {config, score}

    # -- core interface -------------------------------------------------------
    def get_param(self) -> Optional[Dict[str, Any]]:
        """Next config, or None to signal 'wait for outstanding jobs'."""
        if self.finished():
            return None
        cfg = self._propose()
        if cfg is not None:
            self.n_proposed += 1
        return cfg

    def get_params(self, k: int) -> List[Dict[str, Any]]:
        """Up to ``k`` configs in one call — the batched-draining protocol.

        The Experiment loop claims every free resource each pass and asks for
        that many configs at once, which is how a whole population of lanes
        (``VectorizedResourceManager`` / the sharded pool) fills per round.
        The contract:

        * the return value has **at most** ``k`` entries and may be empty;
        * draining stops at the first ``None`` from ``get_param`` — a ``None``
          mid-drain means "a barrier is outstanding" (rung/generation barrier,
          budget issued), NOT "finished"; the loop must hand back the unused
          resources and retry after a callback fires;
        * every returned config counts as *proposed*: the caller is expected
          to run each one and eventually feed ``update`` exactly once per
          config (score or failure), or the proposer's accounting will stall.

        The default loops ``get_param`` so synchronous proposers fill a whole
        population per round with no per-algorithm work.  Subclasses that can
        propose a batch more cheaply (or atomically) may override.
        """
        out: List[Dict[str, Any]] = []
        for _ in range(max(0, int(k))):
            cfg = self.get_param()
            if cfg is None:
                break
            out.append(cfg)
        return out

    def update(self, score: Optional[float], job: Any = None) -> None:
        """Feed back one finished job.  ``job.config`` carries auxiliary keys."""
        config = dict(job.config) if job is not None else {}
        if score is None:
            self.n_failed += 1
            self._on_failure(config)
        else:
            self.n_updated += 1
            s = float(score) if self.maximize else -float(score)
            self.history.append({"config": config, "score": s})
            self._on_result(config, s)

    def finished(self) -> bool:
        return (self.n_updated + self.n_failed) >= self.n_samples

    # -- crash-resume -----------------------------------------------------------
    def replay(self, rows: Sequence[Dict[str, Any]]) -> None:
        """Rebuild state from tracking-DB job rows.

        Rows still ``running`` at the crash count as *proposed* (the
        Experiment re-queues them under new job ids without consulting the
        proposer), so a resumed proposer issues exactly the remaining draws
        instead of double-issuing replacements for in-flight work.
        """
        for r in rows:
            if r.get("status") == "finished" and r.get("score") is not None:
                self.n_proposed += 1

                class _J:  # minimal duck-typed job
                    config = r["config"]

                self.update(r["score"], _J())
            elif r.get("status") in ("failed", "killed", "lost"):
                self.n_proposed += 1
                self.n_failed += 1
            elif r.get("status") == "running":
                self.n_proposed += 1

    def state_json(self) -> Dict[str, Any]:
        """JSON-able snapshot of the proposer's *draw* state, written ahead of
        each proposal batch (``TrackingDB.save_proposer_state``).  The default
        captures the numpy bit-generator state — enough for any proposer whose
        draws come from ``self.rng`` to continue the exact sequence an
        uninterrupted run would have produced.  Subclasses with extra RNGs or
        draw cursors should extend the dict (and ``load_state_json``)."""
        try:
            rng_state = self.rng.bit_generator.state
        except AttributeError:  # pragma: no cover - exotic rng
            rng_state = None
        return {"rng": rng_state, "n_proposed": self.n_proposed}

    def load_state_json(self, state: Optional[Dict[str, Any]]) -> None:
        """Restore the draw state saved by ``state_json``.  Called *after*
        ``replay`` (replay rebuilds result structures from rows; this puts the
        RNG back where the last write-ahead save left it)."""
        if not state:
            return
        rng_state = state.get("rng")
        if rng_state:
            try:
                self.rng.bit_generator.state = rng_state
            except (AttributeError, ValueError, TypeError):  # pragma: no cover
                pass

    # -- subclass hooks ---------------------------------------------------------
    @abc.abstractmethod
    def _propose(self) -> Optional[Dict[str, Any]]:
        ...

    def _on_result(self, config: Dict[str, Any], score: float) -> None:
        pass

    def _on_failure(self, config: Dict[str, Any]) -> None:
        pass

    # -- helpers -----------------------------------------------------------------
    def best(self) -> Optional[Dict[str, Any]]:
        if not self.history:
            return None
        h = max(self.history, key=lambda r: r["score"])
        return {"config": h["config"], "score": h["score"] if self.maximize else -h["score"]}


# Import submodules so @register decorators run on package import.
from . import random_search, grid_search, bayesian, tpe, hyperband, bohb, asha, pbt, eas, cmaes  # noqa: E402,F401
