"""Modality frontend STUBS (per assignment: ``[audio]``/``[vlm]`` entries
specify the transformer backbone only; ``input_specs()`` provides precomputed
frame/patch embeddings).

These helpers generate deterministic synthetic embeddings with the right
shapes/dtypes so the hubert (audio frames) and pixtral (image patches)
backbones can be exercised end-to-end on CPU, and document what a real
frontend would produce.
"""
from __future__ import annotations

import numpy as np


def synthetic_audio_frames(batch: int, n_frames: int, d_model: int, seed: int = 0) -> np.ndarray:
    """Stand-in for a wav2vec2-style conv feature encoder output:
    (batch, n_frames, d_model) bf16-able float32 frames (~50 Hz frame rate)."""
    rng = np.random.default_rng((seed, 0xA0D10))
    # smooth over time like real speech features (AR(1) mixing)
    x = rng.standard_normal((batch, n_frames, d_model)).astype(np.float32)
    for t in range(1, n_frames):
        x[:, t] = 0.7 * x[:, t - 1] + 0.3 * x[:, t]
    return x


def synthetic_image_patches(batch: int, n_patches: int, d_model: int, seed: int = 0) -> np.ndarray:
    """Stand-in for a Pixtral-ViT patch projection: (batch, n_patches, d_model).
    Patches carry a low-frequency spatial signal like projected image content."""
    rng = np.random.default_rng((seed, 0x1777A6E))
    side = max(int(np.sqrt(n_patches)), 1)
    coarse = rng.standard_normal((batch, side // 2 + 1, side // 2 + 1, d_model)).astype(np.float32)
    up = np.kron(coarse, np.ones((1, 2, 2, 1), np.float32))[:, :side, :side]
    flat = up.reshape(batch, side * side, d_model)
    if flat.shape[1] < n_patches:
        pad = np.zeros((batch, n_patches - flat.shape[1], d_model), np.float32)
        flat = np.concatenate([flat, pad], axis=1)
    return flat[:, :n_patches]
