"""qwen3-moe-30b-a3b [moe] — 48L d=2048 32H (GQA kv=4), 128 experts top-8,
expert ff=768, vocab=151936, no shared experts. [hf:Qwen/Qwen3-30B-A3B]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        n_layers=48,
        d_model=2048,
        vocab_size=151936,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        rope_theta=1000000.0,
        n_experts=128,
        moe_top_k=8,
        moe_d_ff=768,
        activation="swiglu",
        pattern=(("attn", "moe"),),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        n_experts=8,
        moe_top_k=2,
        moe_d_ff=32,
        pattern=(("attn", "moe"),),
        tie_embeddings=False,
        param_dtype="float32",
        compute_dtype="float32",
    )
