"""Architecture config: qwen3-0.6b [dense] — qk_norm, GQA, tied embeddings
(Qwen/Qwen3-0.6B published config)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1e6,
        tie_embeddings=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, param_dtype=torch.float32, compute_dtype=torch.float32,
    )
