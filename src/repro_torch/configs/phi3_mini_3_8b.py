"""phi3-mini-3.8b [dense] — 32L d=3072 32H (GQA kv=32 => MHA) ff=8192
vocab=32064.  RoPE + SwiGLU. [arXiv:2404.14219; unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        n_layers=32,
        d_model=3072,
        vocab_size=32064,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        rope_theta=10000.0,
        activation="swiglu",
        pattern=(("attn", "dense"),),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        pattern=(("attn", "dense"),),
        tie_embeddings=False,
        param_dtype="float32",
        compute_dtype="float32",
    )
