"""Architecture config: rwkv6-3b [ssm] — Finch, data-dependent decay,
attention-free (arXiv:2404.05892; hf)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, rwkv_head_dim=64,
        d_ff=8960, vocab=65536, norm_type="layernorm",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, rwkv_head_dim=16,
        d_ff=224, vocab=256, param_dtype=torch.float32, compute_dtype=torch.float32,
    )
