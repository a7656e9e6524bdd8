"""Synthetic data pipeline."""
from .pipeline import BatchSpec, camera_frames, make_batch, token_batches  # noqa: F401
