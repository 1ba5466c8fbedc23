"""Architecture config: llama-3.2-vision-11b [vlm] — a period of five
layers, four self-attention and one gated cross-attention layer over the
image tokens (4 tiles x 1,601 patch embeddings); the vision frontend is a
stub, its embeddings an input (meta-llama/Llama-3.2-11B-Vision)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.base import ModelConfig


def config() -> ModelConfig:
    """Exact published configuration."""
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256, rope_theta=5e5,
        cross_attn_every=5, n_img_tokens=6404,
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    )


def smoke_config() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        config(), n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_img_tokens=8,
        param_dtype=torch.float32, compute_dtype=torch.float32,
    )
