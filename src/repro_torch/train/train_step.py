"""The HPO train step over lane-batched state.

``make_hparam_train_step(tc)`` returns ``step(state, batch, hp, active=None)
-> (state, metrics)``: the state's leaves, the batch's leaves and the
HParams fields all carry a leading lane axis K, and one call trains K trials
as one program.  The serial engine is the K=1 case.

State layout (JAX package's, plus the lane axis):
``{"params": ..., "opt": {"mu", "nu", "step"}}``.  The step updates the
state's tensors in place and returns the same dict.

Numerics follow ``repro.train.train_step.make_hparam_train_step``: every
gradient is rounded to ``parallel.grad_allreduce_dtype`` (bfloat16) before
the global norm and AdamW, also in fp32 models; with
``parallel.microbatch`` the batch is split and the rounded per-microbatch
gradients are summed in fp32 and averaged.  With MoE layers the loss adds
``aux_loss_weight`` times each lane's load-balancing loss, which the metrics
report as ``aux_loss``.  A batch with ``embeds`` (K, B, S, d) feeds them
to the model in place of ``tokens``, as the JAX step does.  The forward
pass recomputes its activations as ``parallel.remat`` says (``"none" |
"full" | "dots"``); the values do not change.

**One trial.**  ``make_train_step(tc)`` is the JAX package's ``(state,
batch) -> (state, metrics)`` over one trial's state with no lane axis,
``{"params", "opt": {"mu", "nu", "step"[, "master"]}}`` with ``step`` a 0-d
int32, its hyperparameters from ``tc``; ``get_compiled_train_step(tc)`` is
the ``(state, batch, hp)`` form, one object for every trial of one static
config; ``make_eval_step(tc)`` gives a batch's metrics.  They run the
lane-batched step on a population of one: the lane axis is a view, so the
update lands in the caller's tensors.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import TrainConfig
from ..interop import add_lane_axis, tree_leaves, tree_map, tree_unflatten
from ..models import transformer as T
from ..models.layers import dtype_of
from ..optim.adamw import adamw_update, init_opt_state
from ..optim.hparams import HParams, hparams_from_config, stack_hparams
from ..optim.schedule import warmup_cosine
from .loss import cross_entropy


def init_params(gen: torch.Generator, tc: TrainConfig, device) -> Dict[str, Any]:
    """One trial's parameters (no lane axis), initialised from ``gen``."""
    return T.init_params(gen, tc.model, device)


def init_train_state(gen: torch.Generator, tc: TrainConfig, device) -> Dict[str, Any]:
    """One trial's train state (no lane axis), initialised from ``gen``: its
    parameters and a zero optimizer state."""
    params = init_params(gen, tc, device)
    return {"params": params, "opt": init_opt_state(params, tc)}


def train_state_specs(tc: TrainConfig) -> Dict[str, Any]:
    """The train state's logical axis names (per trial): the optimizer's
    moments and master copy take the parameters' (the JAX package's)."""
    p = T.param_specs(tc.model)
    opt: Dict[str, Any] = {"mu": p, "nu": p, "step": ()}
    if tc.parallel.master_dtype is not None:
        opt["master"] = p
    return {"params": p, "opt": opt}


def static_step_key(tc: TrainConfig) -> Tuple:
    """The program-cache key: everything a trial may NOT vary per proposal."""
    return (tc.model, tc.parallel, tc.b1, tc.eps, tc.z_loss)


def _loss_fn(params, batch, tc: TrainConfig):
    cfg = tc.model
    logits, aux = T.forward(params, batch.get("tokens"), cfg,
                            inputs_embeds=batch.get("embeds"), remat=tc.parallel.remat)
    loss, metrics = cross_entropy(logits, batch["targets"], batch["mask"], z_loss=tc.z_loss)
    if cfg.has_moe:
        loss = loss + cfg.aux_loss_weight * aux
        metrics["aux_loss"] = aux
    metrics["loss"] = loss
    return loss, metrics


def _value_and_grad(params, batch, tc: TrainConfig):
    """Per-lane metrics and per-lane gradients.  The lanes share no
    parameters, so the gradient of the summed lane losses is each lane's own
    gradient.  A leaf the loss does not read (the embedding table of a batch
    of ``embeds``) gets a zero gradient, as under ``jax.grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = _loss_fn(tree_unflatten(params, leaves), batch, tc)
    grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, tree_unflatten(params, list(grads))


def make_hparam_train_step(tc: TrainConfig) -> Callable:
    """``(state, batch, hp, active=None) -> (state, metrics)`` over K lanes.

    With ``active`` (bool[K]) the update lands only on lanes that are active
    and whose loss is finite; the other lanes keep their state bit for bit.
    Without it every lane is updated."""
    mb = tc.parallel.microbatch
    acc_dt = dtype_of(tc.parallel.grad_allreduce_dtype)

    def train_step(state, batch, hp: HParams, active: Optional[torch.Tensor] = None):
        params = state["params"]
        if mb and mb > 0:
            gb = next(iter(batch.values())).shape[1]
            if gb % mb:
                raise ValueError(f"batch {gb} is not a multiple of microbatch {mb}")
            n_mb = gb // mb
            grads, metrics = None, None
            for i in range(n_mb):
                part = {k: v[:, i * mb:(i + 1) * mb] for k, v in batch.items()}
                m, g = _value_and_grad(params, part, tc)
                g = [x.to(acc_dt).float() for x in tree_leaves(g)]
                m = {k: v.float() for k, v in m.items()}
                if grads is None:
                    grads, metrics = g, m
                else:
                    grads = [a + x for a, x in zip(grads, g)]
                    metrics = {k: metrics[k] + m[k] for k in m}
            grads = tree_unflatten(params, [g / n_mb for g in grads])
            metrics = {k: v / n_mb for k, v in metrics.items()}
        else:
            metrics, grads = _value_and_grad(params, batch, tc)
            grads = tree_map(lambda g: g.to(acc_dt), grads)

        lr = warmup_cosine(state["opt"]["step"], peak_lr=hp.learning_rate,
                           warmup_steps=hp.warmup_steps, total_steps=hp.total_steps)
        applied = None
        if active is not None:
            applied = active & torch.isfinite(metrics["loss"])
        om = adamw_update(grads, params, state["opt"], lr, tc, hp, applied=applied)
        return state, dict(metrics, **om, lr=lr)

    return train_step


# -- one trial ------------------------------------------------------------------


def _one_lane_batch(batch, device) -> Dict[str, torch.Tensor]:
    """One trial's batch (numpy arrays or tensors) on ``device``, as a
    population of one."""
    return {k: torch.as_tensor(v, device=device)[None] for k, v in batch.items()}


def _single_trial(lane_step: Callable) -> Callable:
    """``(state, batch, hp) -> (state, metrics)`` over one trial's state
    (no lane axis) through ``lane_step`` at K=1; ``hp``'s fields are floats
    or 0-d tensors; the metrics are 0-d tensors."""

    def train_step(state, batch, hp: HParams):
        dev = state["opt"]["step"].device
        _, metrics = lane_step(add_lane_axis(state), _one_lane_batch(batch, dev),
                               stack_hparams([hp], dev))
        return state, {k: v[0] for k, v in metrics.items()}

    return train_step


def make_train_step(tc: TrainConfig) -> Callable:
    """``(state, batch) -> (state, metrics)`` for one trial, its
    hyperparameters from ``tc`` (the JAX package's back-compat form)."""
    step = _single_trial(make_hparam_train_step(tc))
    hp = hparams_from_config(tc)

    def train_step(state, batch):
        return step(state, batch, hp)

    return train_step


# -- the step cache -----------------------------------------------------------------
#
# Keyed on the static parts of TrainConfig only (frozen dataclasses hash by
# value): distinct trials of one architecture share one step callable, their
# knobs arriving as the ``hp`` argument.  There is no compilation behind it
# in the port; the cache keeps the JAX package's contract.

_STEP_CACHE: Dict[Tuple, Any] = {}
_STEP_CACHE_LOCK = threading.Lock()


def get_compiled_train_step(tc: TrainConfig) -> Callable:
    """The memoized one-trial ``(state, batch, hp) -> (state, metrics)``:
    the same object for every trial of one static config
    (``static_step_key``).  Thread-safe; ``clear_step_cache()`` empties it."""
    key = static_step_key(tc)
    with _STEP_CACHE_LOCK:
        fn = _STEP_CACHE.get(key)
        if fn is None:
            fn = _STEP_CACHE[key] = _single_trial(make_hparam_train_step(tc))
    return fn


def clear_step_cache() -> None:
    with _STEP_CACHE_LOCK:
        _STEP_CACHE.clear()


def make_eval_step(tc: TrainConfig) -> Callable:
    """``(params, batch) -> metrics`` for one trial's parameters (no lane
    axis): the loss and its metrics, 0-d tensors, without a gradient."""

    @torch.no_grad()
    def eval_step(params, batch):
        dev = tree_leaves(params)[0].device
        _, metrics = _loss_fn(add_lane_axis(params), _one_lane_batch(batch, dev), tc)
        return {k: v[0] for k, v in metrics.items()}

    return eval_step
