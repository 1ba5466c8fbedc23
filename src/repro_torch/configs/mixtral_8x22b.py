"""Architecture config: mixtral-8x22b [moe] — 8 experts top-2, sliding-window
attention (arXiv:2401.04088)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=32768, rope_theta=1e6, sliding_window=4096,
        n_experts=8, top_k=2,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_experts=4, sliding_window=32,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
