"""deepseek-v2-lite-16b [moe] — 27L d=2048 16H, MLA kv_lora=512, MoE 64
routed top-6 + 2 shared, expert ff=1408, vocab=102400.  First layer is a
dense-FFN MLA layer (prefix), the remaining 26 are MLA+MoE (scanned).
[arXiv:2405.04434; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        n_layers=27,
        d_model=2048,
        vocab_size=102400,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        kv_lora_rank=512,
        rope_head_dim=64,
        d_ff=10944,                 # the one dense layer
        n_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        activation="swiglu",
        prefix_pattern=(("attn_mla", "dense"),),
        pattern=(("attn_mla", "moe"),),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        n_layers=3,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        kv_lora_rank=32,
        rope_head_dim=16,
        d_ff=128,
        n_experts=8,
        n_shared_experts=2,
        moe_top_k=2,
        moe_d_ff=32,
        prefix_pattern=(("attn_mla", "dense"),),
        pattern=(("attn_mla", "moe"),),
        tie_embeddings=False,
        param_dtype="float32",
        compute_dtype="float32",
    )
