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
bit for bit, including ``step`` and ``master``.

With ``parallel.master_dtype`` the state holds ``master``, a copy of the
parameters in that dtype: the update reads its base from the master, writes
the new master in its dtype, and writes the parameters as the new master
cast to their own dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import TrainConfig
from ..interop import tree_leaves, tree_map
from ..models.layers import dtype_of, lane_sum
from .hparams import HParams

OptState = Dict[str, Any]


def init_opt_state(params, tc: TrainConfig) -> OptState:
    """Zero moments in ``mu_dtype`` / ``nu_dtype`` and a step counter; with
    ``parallel.master_dtype`` also ``master``, the parameters cast to it."""
    pc = tc.parallel
    mu_dt, nu_dt = dtype_of(pc.mu_dtype), dtype_of(pc.nu_dtype)
    leaf = tree_leaves(params)[0]
    state: OptState = {
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mu_dt), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=nu_dt), params),
        "step": torch.zeros(leaf.shape[:0], dtype=torch.int32, device=leaf.device),
    }
    if pc.master_dtype is not None:
        mdt = dtype_of(pc.master_dtype)
        state["master"] = tree_map(lambda p: p.detach().to(mdt, copy=True), params)
    return state


def _lanes(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (K,) tensor shaped to broadcast against a (K, ...) leaf."""
    return t.view((-1,) + (1,) * (like.dim() - 1))


# a stacked leaf larger than this is updated a slice of its superblock axis at
# a time: the update is elementwise, so the bits are the same, and its fp32
# temporaries are a slice's (at most ~1 GiB each), not the whole leaf's
_SLICE_ELEMS = 1 << 28


def _slices(p: torch.Tensor) -> list:
    """Index tuples that cover ``p`` (K, n, ...) in runs along axis 1."""
    if p.dim() < 3 or p.numel() <= _SLICE_ELEMS:
        return [(slice(None),)]
    n = p.shape[1]
    c = max(1, n * _SLICE_ELEMS // p.numel())
    return [(slice(None), slice(j, j + c)) for j in range(0, n, c)]


def global_norm(grads) -> torch.Tensor:
    """Per-lane L2 norm (K,) over all leaves, each lane's sums its own
    reductions (``lane_sum``)."""
    total = None
    for g in tree_leaves(grads):
        sq = lane_sum(torch.square(g.float()))
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

    def upd(g, p, m, v, master, decay: bool):
        L = lambda t: _lanes(t, g)  # noqa: E731
        gf = g.float() * L(clip)
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = L(b2) * v.float() + L(1 - b2) * gf * gf
        del gf
        delta = (m_new / L(c1)) / (torch.sqrt(v_new / L(c2)) + eps)
        base = (p if master is None else master).float()
        if decay:  # decay matrices, not norms/biases (wd==0 is a no-op)
            delta = delta + L(wd) * base
        new = base - L(lr) * delta
        del delta, base
        outs = (p, m, v) if master is None else (p, m, v, master)
        for dst, src in zip(outs, (new, m_new, v_new, new)):
            if applied is None:
                dst.copy_(src)
            else:
                dst.copy_(torch.where(~L(applied), dst, src.to(dst.dtype)))

    def upd_leaf(g, p, m, v, master=None):
        decay = p.dim() - 1 >= 2
        for sl in _slices(p):
            upd(g[sl], p[sl], m[sl], v[sl], None if master is None else master[sl], decay)

    trees = (grads, params, state["mu"], state["nu"])
    tree_map(upd_leaf, *trees, *((state["master"],) if "master" in state else ()))
    # in place, like every other leaf: a captured CUDA graph replays fixed addresses
    state["step"].copy_(step if applied is None else torch.where(applied, step, state["step"]))
    return {"grad_norm": gnorm}
