"""starcoder2-3b [dense] — 30L d=3072 24H (GQA kv=2) ff=12288 vocab=49152.
GQA + RoPE, GeLU MLP. [arXiv:2402.19173; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        n_layers=30,
        d_model=3072,
        vocab_size=49152,
        n_heads=24,
        n_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        rope_theta=999999.0,
        activation="gelu",
        pattern=(("attn", "dense"),),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        activation="gelu",
        pattern=(("attn", "dense"),),
        param_dtype="float32",
        compute_dtype="float32",
    )
