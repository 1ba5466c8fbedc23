"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``."""

from __future__ import annotations

import importlib

from repro_torch.configs import shapes
from repro_torch.configs.shapes import SHAPES, input_specs, supported_shapes

ARCHS = {
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2-7b": "qwen2_7b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "qwen1.5-4b": "qwen1_5_4b",
    "minitron-8b": "minitron_8b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "rwkv6-3b": "rwkv6_3b",
    "musicgen-medium": "musicgen_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    # the paper's own accelerator workload (MLP on MNIST-class tasks)
    "paper-nn": "paper_nn",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


__all__ = [
    "ARCHS", "SHAPES", "get_config", "get_smoke_config", "input_specs",
    "supported_shapes", "shapes",
]
