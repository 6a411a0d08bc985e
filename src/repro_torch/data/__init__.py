"""Synthetic data streams and the host-to-device feed."""
from .pipeline import SyntheticLM
