"""Architecture config: minitron-8b [dense] — pruned nemotron, non-gated
relu^2 MLP, GQA kv8, untied embeddings (arXiv:2407.14679)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=256000, gated_mlp=False, mlp_act="relu2",
        rope_theta=1e4,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, param_dtype=torch.float32, compute_dtype=torch.float32,
    )
