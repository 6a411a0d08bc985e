"""AdamW over lane-batched parameter trees, updated in place.

Every leaf carries a leading lane axis K and every hyperparameter is a (K,)
tensor, so one call updates K independent trials.  The numerics are the JAX
package's ``adamw_update``:

* the schedule reads the step counter before its increment; the bias
  correction reads it after;
* ``grad_clip <= 0`` turns clipping off, per lane;
* a leaf is decayed iff its per-trial ``ndim >= 2`` — the lane axis does not
  count, so the stacked per-layer norm gains ``(n_superblocks, d)`` are
  decayed, as in the reference.

The update writes into the state's tensors (the JAX step donates its state
buffer); with ``applied`` given, lanes outside the mask keep their old state
bit for bit, including ``step``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import TrainConfig
from ..interop import tree_leaves, tree_map
from ..models.layers import dtype_of
from .hparams import HParams

OptState = Dict[str, Any]


def init_opt_state(params, tc: TrainConfig) -> OptState:
    pc = tc.parallel
    if pc.master_dtype is not None:
        raise NotImplementedError(
            "master_dtype is not ported yet: the population trainer updates "
            "parameters in their own dtype")
    mu_dt, nu_dt = dtype_of(pc.mu_dtype), dtype_of(pc.nu_dtype)
    leaf = tree_leaves(params)[0]
    return {
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dt), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=nu_dt), params),
        "step": torch.zeros(leaf.shape[:0], dtype=torch.int32, device=leaf.device),
    }


def _lanes(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (K,) tensor shaped to broadcast against a (K, ...) leaf."""
    return t.view((-1,) + (1,) * (like.dim() - 1))


def global_norm(grads) -> torch.Tensor:
    """Per-lane L2 norm (K,) over all leaves."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.square(g.float()).sum(dim=tuple(range(1, g.dim())))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, params, state: OptState, lr: torch.Tensor, tc: TrainConfig,
                 hp: HParams, applied: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One AdamW step on every lane, in place.  Returns ``{"grad_norm": (K,)}``."""
    b1, eps = tc.b1, tc.eps
    b2, wd, gc = hp.b2, hp.weight_decay, hp.grad_clip
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.where(gc > 0, torch.clamp(gc / (gnorm + 1e-9), max=1.0),
                       torch.ones_like(gnorm))
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(g, p, m, v):
        L = lambda t: _lanes(t, g)  # noqa: E731
        gf = g.float() * L(clip)
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = L(b2) * v.float() + L(1 - b2) * gf * gf
        del gf
        delta = (m_new / L(c1)) / (torch.sqrt(v_new / L(c2)) + eps)
        base = p.float()
        if p.dim() - 1 >= 2:  # decay matrices, not norms/biases (wd==0 is a no-op)
            delta = delta + L(wd) * base
        new = base - L(lr) * delta
        del delta, base
        if applied is None:
            p.copy_(new)
            m.copy_(m_new)
            v.copy_(v_new)
        else:
            keep = ~L(applied)
            p.copy_(torch.where(keep, p, new.to(p.dtype)))
            m.copy_(torch.where(keep, m, m_new.to(m.dtype)))
            v.copy_(torch.where(keep, v, v_new.to(v.dtype)))

    tree_map(upd, grads, params, state["mu"], state["nu"])
    state["step"] = step if applied is None else torch.where(applied, step, state["step"])
    return {"grad_norm": gnorm}
