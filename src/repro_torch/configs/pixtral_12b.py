"""pixtral-12b [vlm] — 40L d=5120 32H (GQA kv=8) ff=14336 vocab=131072.
Mistral-Nemo-style decoder backbone; the Pixtral ViT frontend is a STUB —
input_specs() supplies precomputed patch embeddings (B, S, d).
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        n_layers=40,
        d_model=5120,
        vocab_size=131072,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        rope_theta=1000000.0,
        activation="swiglu",
        pattern=(("attn", "dense"),),
        tie_embeddings=False,
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        pattern=(("attn", "dense"),),
        tie_embeddings=False,
        frontend="vision",
        param_dtype="float32",
        compute_dtype="float32",
    )
