"""Population trial engine: K HPO trials trained as one program.

The lane-batched model runs all K trials' forward and backward passes
together (batched matmuls over K; the kernels take K as part of their batch
dimension), and AdamW updates all K lanes in one pass.

Population state layout (the JAX package's)::

    {"inner":     lane-batched train state (leading axis K),
     "diverged":  bool[K]   — latch; a NaN/inf loss freezes that trial,
     "last_loss": f32[K]    — loss at each trial's last *applied* step}

Semantics per ``pop_step(pstate, batch, hp)``:

* a trial is **active** while ``opt.step < hp.total_steps`` and not
  diverged — ``hp.total_steps`` doubles as the per-trial step budget, and the
  driver may shrink it mid-flight (in-flight early stopping);
* a non-finite loss at an active step sets the ``diverged`` latch and the
  update is not applied;
* lanes that are inactive or diverge keep their state bit for bit;
* ``last_loss`` records the loss of the most recent applied update.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import TrainConfig
from ..interop import tree_map
from ..optim.hparams import HParams
from . import train_step as ts

PopState = Dict[str, Any]


def _wrap(inner, k: int, device) -> PopState:
    return {
        "inner": inner,
        "diverged": torch.zeros((k,), dtype=torch.bool, device=device),
        "last_loss": torch.full((k,), float("inf"), dtype=torch.float32, device=device),
    }


def init_population_state(gen: torch.Generator, tc: TrainConfig, population: int,
                          device) -> PopState:
    """K identical trials from one generator: every lane starts from the same
    weights (the serial driver inits every trial from the same seed); only
    their hyperparameters differ."""
    one = ts.init_train_state(gen, tc, device)
    inner = tree_map(lambda x: x[None].repeat((population,) + (1,) * x.dim()), one)
    return _wrap(inner, population, device)


def init_population_state_from_keys(gens, tc: TrainConfig, device) -> PopState:
    """One trial per generator (per-trial init weights)."""
    states = [ts.init_train_state(g, tc, device) for g in gens]
    inner = tree_map(lambda *xs: torch.stack(xs), *states)
    return _wrap(inner, len(states), device)


def make_population_train_step(tc: TrainConfig, per_trial_batch: bool = True) -> Callable:
    """``(pstate, batch, hp) -> (pstate, metrics)`` over a leading K axis.

    ``hp`` is a stacked HParams (fields (K,)); metrics come back per lane plus
    the ``active`` mask.  With ``per_trial_batch`` the batch leaves carry a
    leading K axis (one data stream per trial); otherwise one batch is
    broadcast to every lane.  The state is updated in place.
    """
    step = ts.make_hparam_train_step(tc)

    def pop_step(pstate: PopState, batch, hp: HParams):
        inner = pstate["inner"]
        k = pstate["diverged"].shape[0]
        if not per_trial_batch:
            batch = {n: b[None].expand((k,) + b.shape) for n, b in batch.items()}
        in_budget = inner["opt"]["step"].float() < hp.total_steps
        active = in_budget & ~pstate["diverged"]
        _, metrics = step(inner, batch, hp, active=active)
        finite = torch.isfinite(metrics["loss"])
        applied = active & finite
        pstate["diverged"] = pstate["diverged"] | (active & ~finite)
        pstate["last_loss"] = torch.where(applied, metrics["loss"], pstate["last_loss"])
        return pstate, dict(metrics, active=active)

    return pop_step


def pad_population(k: int, mesh: Optional[Any] = None) -> int:
    """Smallest population size >= k that divides over the lane rows.  Only
    the single-device engine is ported: ``mesh`` must be None."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device population meshes come with ROADMAP.md section 1, item 12")
    return max(k, 1)


def population_scores(pstate: PopState, diverged_score: float = -1e9) -> torch.Tensor:
    """HPO convention: score = -final_loss, with a sentinel for diverged
    trials.  Trials that never applied a step (budget 0) also get the
    sentinel."""
    last = pstate["last_loss"]
    ok = ~pstate["diverged"] & torch.isfinite(last)
    return torch.where(ok, -last, torch.full_like(last, diverged_score))
