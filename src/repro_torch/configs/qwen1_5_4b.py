"""Architecture config: qwen1.5-4b [dense] — multi-head attention (20/20
heads), QKV bias, untied embeddings (Qwen/Qwen1.5 family)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
        d_ff=6912, vocab=151936, qkv_bias=True, rope_theta=5e6,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, param_dtype=torch.float32, compute_dtype=torch.float32,
    )
