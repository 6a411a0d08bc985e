"""Per-trial hyperparameters.

``HParams`` holds the knobs a trial may vary without changing the program:
lr / weight_decay / b2 / grad_clip / schedule lengths.  A population carries
one value per lane: ``stack_hparams`` turns K trials' HParams into one whose
fields are fp32 tensors of shape (K,).  Anything still read from
``TrainConfig`` inside the step (model architecture, dtypes, ``b1``,
``eps``, ``z_loss``) is the same for every lane.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from ..configs.base import TrainConfig

FIELDS = ("learning_rate", "weight_decay", "b2", "grad_clip", "warmup_steps",
          "total_steps")


@dataclasses.dataclass(frozen=True)
class HParams:
    """Per-trial hyperparameters: Python floats for one trial, fp32 tensors
    (K,) once stacked."""

    learning_rate: Any
    weight_decay: Any
    b2: Any
    grad_clip: Any          # <= 0 disables clipping
    warmup_steps: Any       # float; schedule math is float
    total_steps: Any


def hparams_from_dict(cfg: Dict[str, Any], tc: TrainConfig) -> HParams:
    """Build HParams from an HPO proposal dict, defaulting to ``tc``'s values.

    Recognised keys mirror the search space in ``repro_torch.launch.hpo``:
    ``learning_rate``, ``weight_decay``, ``b2``, ``grad_clip`` and either
    explicit ``warmup_steps``/``total_steps`` or ``warmup_frac`` applied to
    ``tc.total_steps``.
    """
    total = float(cfg.get("total_steps", tc.total_steps))
    if "warmup_steps" in cfg:
        warmup = float(cfg["warmup_steps"])
    elif "warmup_frac" in cfg:
        warmup = float(cfg["warmup_frac"]) * total
    else:
        warmup = float(tc.warmup_steps)
    return HParams(
        learning_rate=float(cfg.get("learning_rate", tc.learning_rate)),
        weight_decay=float(cfg.get("weight_decay", tc.weight_decay)),
        b2=float(cfg.get("b2", tc.b2)),
        grad_clip=float(cfg.get("grad_clip", tc.grad_clip)),
        warmup_steps=float(max(warmup, 1.0)),
        total_steps=total,
    )


def stack_hparams(hps: Sequence[HParams], device="cpu") -> HParams:
    """Stack per-trial HParams along a new leading population axis."""
    if not hps:
        raise ValueError("empty population")
    return HParams(**{
        f: torch.tensor([float(getattr(h, f)) for h in hps], dtype=torch.float32,
                        device=device)
        for f in FIELDS})
