"""Pytree helpers and the numpy bridge to the JAX package's state layout.

The port keeps the JAX package's parameter and population-state trees (nested
dicts and lists) with one extra leading lane axis K on every leaf of a
population.  Converting a JAX tree, given as numpy arrays, into the port's
tensors is therefore a tree copy:

    {"inner": {"params": ..., "opt": {"mu", "nu", "step"}},
     "diverged": bool[K], "last_loss": f32[K]}

bfloat16 arrays from JAX arrive as numpy arrays of the ``ml_dtypes``
bfloat16 type; they are read through their 16-bit pattern, so no extra
package is needed.  ``to_numpy`` returns bfloat16 tensors as float32 arrays,
which hold every bfloat16 value exactly.
"""
from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over nested dicts/lists/tuples of equal structure;
    dicts are walked in sorted key order, as JAX walks them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the order ``tree_map`` visits them."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``tree`` with its leaves replaced, in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)  # the port updates its state in place
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def to_torch(tree: Any, device="cpu") -> Any:
    """A JAX pytree of numpy arrays (or arrays convertible to numpy) as the
    port's tensors on ``device``, same structure and dtypes."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def to_numpy(tree: Any) -> Any:
    """The port's tensors back to numpy arrays (bfloat16 as float32)."""
    return tree_map(_leaf_to_numpy, tree)


def add_lane_axis(tree: Any) -> Any:
    """One trial's tree as a population of one (leading K=1 on every leaf)."""
    return tree_map(lambda t: t[None], tree)
