"""gemma2-9b [dense] — 42L d=3584 16H (GQA kv=8) ff=14336 vocab=256000.
Local(4096-window)+global alternating attention, attn softcap 50, final logit
softcap 30, post-norms, sqrt(d)-scaled embeddings. [arXiv:2408.00118; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        n_layers=42,
        d_model=3584,
        vocab_size=256000,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        rope_theta=10000.0,
        sliding_window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        activation="swiglu",
        pattern=(("attn_local", "dense"), ("attn", "dense")),
        post_norm=True,
        scale_embed=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke",
        n_layers=4,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        sliding_window=8,
        attn_softcap=50.0,
        final_softcap=30.0,
        pattern=(("attn_local", "dense"), ("attn", "dense")),
        post_norm=True,
        scale_embed=True,
        param_dtype="float32",
        compute_dtype="float32",
    )
