"""Rotary position embeddings (half-rotation / llama convention), in fp32."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions (S,) — the same positions for every row."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, device=x.device)                  # (D/2,)
    ang = positions.float()[:, None] * inv                        # (S, D/2)
    ang = ang[:, None, :]                                         # (S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
