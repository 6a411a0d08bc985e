"""falcon-mamba-7b [ssm] — 64L d=4096, attention-free Mamba-1, ssm_state=16,
vocab=65024.  No FFN (the Mamba mixer is the whole block). [arXiv:2410.05355]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        n_layers=64,
        d_model=4096,
        vocab_size=65024,
        d_ff=0,
        ssm_state=16,
        ssm_expand=2,
        ssm_conv=4,
        pattern=(("mamba", "none"),),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=256,
        d_ff=0,
        ssm_state=8,
        pattern=(("mamba", "none"),),
        param_dtype="float32",
        compute_dtype="float32",
    )
