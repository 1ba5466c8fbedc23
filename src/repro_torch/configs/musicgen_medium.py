"""Architecture config: musicgen-medium [audio] — a decoder over four
EnCodec codebooks (their embeddings summed, one head each), sinusoidal
positions, LayerNorm and a non-gated gelu MLP; the audio frontend is a stub
(arXiv:2306.05284; facebook/musicgen-medium)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048, n_codebooks=4,
        norm_type="layernorm", gated_mlp=False, mlp_act="gelu",
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64, param_dtype=torch.float32, compute_dtype=torch.float32,
    )
