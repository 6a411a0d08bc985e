"""Cross-entropy loss with optional z-loss, per lane."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.layers import lane_sum


def cross_entropy(
    logits: torch.Tensor,   # (K, B, S, V) fp32
    targets: torch.Tensor,  # (K, B, S) int
    mask: torch.Tensor,     # (K, B, S) float
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-lane mean next-token loss (K,) and per-lane metrics; each lane's
    sums are its own reductions (``lane_sum``)."""
    lse = torch.logsumexp(logits, dim=-1)                                # (K, B, S)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    denom = torch.clamp(lane_sum(mask), min=1.0)
    loss = lane_sum(nll * mask) / denom
    metrics = {"ce_loss": loss}
    if z_loss > 0:
        zl = z_loss * lane_sum((lse * lse) * mask) / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    acc = lane_sum((logits.argmax(-1) == targets).float() * mask) / denom
    metrics["accuracy"] = acc
    return loss, metrics
