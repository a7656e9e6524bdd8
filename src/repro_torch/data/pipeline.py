"""Synthetic data pipeline: token streams, camera frames, modality stubs.

A copy of `repro/data/pipeline.py` (numpy only): the same ``RandomState``
draws in the same order, so a batch or a frame equals the reference's bit
for bit for the same config, shape and seed.  Batches are numpy arrays;
the training loop moves them to its device.

Deterministic (seeded) generators sized by the model config — the training
substrate for examples/tests and the source of the modality-frontend
embeddings (the one permitted stub: precomputed patch/frame embeddings for
VLM/audio backbones).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from ..models.config import ModelConfig

__all__ = ["BatchSpec", "token_batches", "make_batch", "camera_frames"]


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    batch: int
    seq_len: int


def make_batch(cfg: ModelConfig, spec: BatchSpec, seed: int = 0) -> dict:
    """One training batch matching the config's modality."""
    rng = np.random.RandomState(seed)
    b, s = spec.batch, spec.seq_len
    if cfg.modality == "vision_prefix":
        s_text = s - cfg.vision_tokens
        if s_text <= 0:
            raise ValueError("seq_len must exceed vision prefix")
        tokens = rng.randint(0, cfg.vocab_size, (b, s_text), dtype=np.int32)
        return {
            "tokens": tokens,
            "labels": np.roll(tokens, -1, axis=1),
            "vision_embeds": rng.randn(b, cfg.vision_tokens, cfg.d_model)
            .astype(np.float32) * 0.02,
        }
    if cfg.num_codebooks > 1:
        tokens = rng.randint(0, cfg.vocab_size, (b, s, cfg.num_codebooks),
                             dtype=np.int32)
    else:
        tokens = rng.randint(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}


def token_batches(cfg: ModelConfig, spec: BatchSpec, *, seed: int = 0,
                  num_batches: int | None = None) -> Iterator[dict]:
    step = 0
    while num_batches is None or step < num_batches:
        yield make_batch(cfg, spec, seed=seed + step)
        step += 1


def camera_frames(width: int = 640, height: int = 480, *, seed: int = 0,
                  num_frames: int | None = None) -> Iterator[np.ndarray]:
    """Synthetic MJPEG-like camera frames (the paper's 640x480 streams)."""
    rng = np.random.RandomState(seed)
    n = 0
    while num_frames is None or n < num_frames:
        yield rng.randint(0, 256, (height, width, 3), np.uint8)
        n += 1
