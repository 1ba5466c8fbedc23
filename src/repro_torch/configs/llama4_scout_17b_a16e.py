"""Architecture config: llama4-scout-17b-a16e [moe] — 16 experts top-1 plus a
shared expert (hf:meta-llama/Llama-4-Scout-17B-16E)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048, rope_theta=5e5,
        n_experts=16, top_k=1, shared_expert=True,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_experts=4,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
