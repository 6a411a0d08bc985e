"""hubert-xlarge [audio] — 48L d=1280 16H (MHA) ff=5120 vocab=504.
Encoder-only (bidirectional, no decode step); the CNN waveform frontend is a
STUB — input_specs() supplies precomputed frame embeddings (B, S, d).
vocab=504 is the masked-prediction codebook. [arXiv:2106.07447; unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        n_layers=48,
        d_model=1280,
        vocab_size=504,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        activation="gelu",
        pattern=(("attn", "dense"),),
        encoder_only=True,
        tie_embeddings=False,
        frontend="audio",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke",
        n_layers=2,
        d_model=64,
        vocab_size=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        activation="gelu",
        pattern=(("attn", "dense"),),
        encoder_only=True,
        tie_embeddings=False,
        frontend="audio",
        param_dtype="float32",
        compute_dtype="float32",
    )
