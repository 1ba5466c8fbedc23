"""Architecture config: jamba-1.5-large-398b [hybrid] — mamba:attention 7:1
in periods of 8 layers, MoE (16 experts top-2) at every other layer
(arXiv:2403.19887; hf)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=65536,
        n_experts=16, top_k=2, attn_every=8, d_state=16, ssm_expand=2,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_experts=4, d_state=8,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
