"""Architecture registry: 10 assigned archs + per-arch run policy.

``get_config(id)`` / ``get_smoke_config(id)`` return ModelConfigs;
``cells(id)`` enumerates the (arch x shape) dry-run cells with skip reasons
(encoder-only archs have no decode; long_500k runs only on sub-quadratic
archs — see DESIGN.md §5);
``memory_policy(id, shape)`` picks optimizer-state dtypes / microbatch so the
cell fits 16 GB/chip on the production mesh.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

from .base import SHAPES, ModelConfig, ParallelConfig, ShapeConfig, TrainConfig

ARCH_IDS: Tuple[str, ...] = (
    "gemma2-9b",
    "phi3-mini-3.8b",
    "starcoder2-3b",
    "granite-34b",
    "hubert-xlarge",
    "jamba-1.5-large-398b",
    "falcon-mamba-7b",
    "pixtral-12b",
    "deepseek-v2-lite-16b",
    "qwen3-moe-30b-a3b",
)

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "starcoder2-3b": "starcoder2_3b",
    "granite-34b": "granite_34b",
    "hubert-xlarge": "hubert_xlarge",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "pixtral-12b": "pixtral_12b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).smoke()


def cells(arch: str) -> List[Tuple[ShapeConfig, Optional[str]]]:
    """All 4 shape cells for an arch, each with a skip reason or None."""
    cfg = get_config(arch)
    out: List[Tuple[ShapeConfig, Optional[str]]] = []
    for shape in SHAPES.values():
        skip = None
        if shape.kind == "decode" and cfg.encoder_only:
            skip = "encoder-only: no autoregressive decode step"
        elif shape.name == "long_500k" and not cfg.sub_quadratic:
            skip = "full-attention arch: 500k KV working set (prompt rule: sub-quadratic only)"
        out.append((shape, skip))
    return out


def memory_policy(arch: str, shape: ShapeConfig, multi_pod: bool = False) -> ParallelConfig:
    """Per-cell parallelism + memory policy targeting 16 GB/chip (v5e).

    Big-model levers: bf16 Adam moments, no fp32 master, microbatching.
    """
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    big = arch in ("jamba-1.5-large-398b", "granite-34b")
    mu = nu = "bfloat16" if big else "float32"
    micro = 0
    if shape.kind == "train":
        # logits (mb, seq, vocab) are the activation-memory driver
        micro = {256: 32}.get(shape.global_batch, 0)
        if big:
            micro = 16
        # a microbatch smaller than the data parallelism cannot shard
        dp = 32 if multi_pod else 16
        if micro:
            micro = max(micro, dp)
    return ParallelConfig(
        mesh_shape=mesh_shape,
        mesh_axes=mesh_axes,
        microbatch=micro,
        remat="full" if shape.kind == "train" else "none",
        master_dtype=None,
        mu_dtype=mu,
        nu_dtype=nu,
        grad_allreduce_dtype="bfloat16",
        shard_cache_seq=(shape.name == "long_500k"),
    )
