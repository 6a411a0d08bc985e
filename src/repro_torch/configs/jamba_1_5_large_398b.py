"""jamba-1.5-large-398b [hybrid] — 72L d=8192 64H (GQA kv=8) ff=24576
vocab=65536, MoE 16e top-2.  Mamba:attention 7:1 interleave, MoE every 2nd
layer.  Super-block of 8: [M Mmoe M Mmoe A Mmoe M Mmoe] x 9. [arXiv:2403.19887; hf]"""
from .base import ModelConfig

_PATTERN = (
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("attn", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        n_layers=72,
        d_model=8192,
        vocab_size=65536,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        n_experts=16,
        moe_top_k=2,
        moe_d_ff=24576,
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        activation="swiglu",
        pattern=_PATTERN,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke",
        n_layers=8,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        n_experts=4,
        moe_top_k=2,
        moe_d_ff=64,
        ssm_state=8,
        pattern=_PATTERN,
        param_dtype="float32",
        compute_dtype="float32",
    )
