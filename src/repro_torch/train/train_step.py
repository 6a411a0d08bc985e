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
gradients are summed in fp32 and averaged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import TrainConfig
from ..interop import tree_leaves, tree_map, tree_unflatten
from ..models import transformer as T
from ..models.layers import dtype_of
from ..optim.adamw import adamw_update, init_opt_state
from ..optim.hparams import HParams
from ..optim.schedule import warmup_cosine
from .loss import cross_entropy


def init_train_state(gen: torch.Generator, tc: TrainConfig, device) -> Dict[str, Any]:
    """One trial's train state (no lane axis), initialised from ``gen``."""
    params = T.init_params(gen, tc.model, device)
    return {"params": params, "opt": init_opt_state(params, tc)}


def _loss_fn(params, batch, tc: TrainConfig):
    logits, _ = T.forward(params, batch["tokens"], tc.model)
    loss, metrics = cross_entropy(logits, batch["targets"], batch["mask"], z_loss=tc.z_loss)
    metrics["loss"] = loss
    return loss, metrics


def _value_and_grad(params, batch, tc: TrainConfig):
    """Per-lane metrics and per-lane gradients.  The lanes share no
    parameters, so the gradient of the summed lane losses is each lane's own
    gradient."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = _loss_fn(tree_unflatten(params, leaves), batch, tc)
    grads = torch.autograd.grad(loss.sum(), leaves)
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
            gb = batch["tokens"].shape[1]
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
