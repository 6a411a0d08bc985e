"""granite-34b [dense] — 88L d=6144 48H (MQA kv=1) ff=24576 vocab=49152.
Granite Code 34B: GPTBigCode-family MQA + 2-matrix GeLU MLP (the 3-matrix
SwiGLU variant would be 47B; the published checkpoint is ~34B).
[arXiv:2405.04324; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        n_layers=88,
        d_model=6144,
        vocab_size=49152,
        n_heads=48,
        n_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        rope_theta=10000.0,
        activation="gelu",
        pattern=(("attn", "dense"),),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        pattern=(("attn", "dense"),),
        param_dtype="float32",
        compute_dtype="float32",
    )
