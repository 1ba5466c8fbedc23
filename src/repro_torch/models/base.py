"""Model config, parameter specs and the parameter-tree helpers.

Parameters are nested dicts of tensors. Layers are stacked: every block leaf
carries a leading ``n_groups`` dimension and the forward pass loops over it.
Flattening visits dict keys in sorted order and names every leaf by its key
path in the reference's notation (``"['blocks']['p0']['attn']['wq']"``), so
leaf order, per-leaf fault seeds and memory domains match the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    gated_mlp: bool = True  # SwiGLU vs plain MLP
    mlp_act: str = "gelu"  # non-gated MLP activation: gelu | relu2
    rope_theta: float = 1e4
    sliding_window: int = 0  # 0 -> full attention
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # every k-th layer position is MoE (within a period)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # hybrid / ssm
    attn_every: int = 0  # jamba: one attention layer per this many layers
    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # vlm
    cross_attn_every: int = 0  # one cross-attention layer per this many layers
    n_img_tokens: int = 0
    # audio
    n_codebooks: int = 0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    kv_quant: bool = False  # int8 KV cache (+per-token scales) for decode
    flash_chunk: int = 1024  # q / kv chunk of the train forward's chunked attention

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        """Layers per stacked group (the repeating block pattern): jamba's
        ``attn_every``, a vlm's ``cross_attn_every``, an MoE config's
        ``moe_every``, else one layer."""
        if self.family == "hybrid":
            return self.attn_every
        if self.family == "vlm":
            return self.cross_attn_every
        if self.n_experts and self.moe_every > 1:
            return self.moe_every
        return 1

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kind(self, pos: int) -> dict:
        """Period position ``pos``'s mixer and feed-forward type: a hybrid
        period has its attention at ``attn_every // 2`` and MoE at the odd
        positions; a vlm period's last position is cross-attention; an ssm
        layer is RWKV time-mix and channel-mix."""
        if self.family == "hybrid":
            mixer = "attn" if pos == self.attn_every // 2 else "mamba"
            return {"mixer": mixer, "ffn": "moe" if pos % 2 == 1 else "mlp"}
        if self.family == "vlm":
            return {"mixer": "cross" if pos == self.period - 1 else "attn", "ffn": "mlp"}
        if self.family == "ssm":
            return {"mixer": "rwkv", "ffn": "rwkv_cm"}
        if self.family == "moe":
            ffn = "moe" if pos % self.moe_every == self.moe_every - 1 else "mlp"
            return {"mixer": "attn", "ffn": ffn}
        return {"mixer": "attn", "ffn": "mlp"}


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    init: str = "normal"  # normal | zeros | ones | decay
    scale: float = 1.0
    # logical axis names, one per dim ("layers", "embed", "heads:<n>", "ffn",
    # "experts", "vocab" or None): distributed/sharding.py maps them to a mesh
    axes: tuple = ()


def struct(spec_tree, dtype):
    """Spec tree -> tensors on the meta device: shapes and dtypes, no
    storage (the reference's ShapeDtypeStructs)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), spec_tree,
                    is_leaf=lambda x: isinstance(x, Spec))


def axes_tree(spec_tree):
    """Spec tree -> the tree of its leaves' logical axes."""
    return tree_map(lambda s: s.axes, spec_tree, is_leaf=lambda x: isinstance(x, Spec))


def materialize(spec_tree, generator: torch.Generator, dtype, device):
    """Spec tree -> tensors: ``normal`` leaves are N(0, 1) * scale /
    sqrt(fan_in) drawn from ``generator`` in flattening order; ``decay``
    leaves (the recurrent mixers' decay logits) are linspace(-6, -0.5) over
    the leaf's elements, reshaped, and draw nothing. A leaf of
    four or more dimensions (a stacked expert weight) is drawn one trailing
    matrix at a time, so no float32 copy of it is ever whole."""
    flat = flatten(spec_tree, is_leaf=lambda x: isinstance(x, Spec))
    out = []
    for _, s in flat:
        if s.init == "zeros":
            a = torch.zeros(s.shape, dtype=dtype, device=device)
        elif s.init == "ones":
            a = torch.ones(s.shape, dtype=dtype, device=device)
        elif s.init == "decay":
            a = torch.from_numpy(np.linspace(-6.0, -0.5, num=math.prod(s.shape)))
            a = a.to(torch.float32).reshape(s.shape).to(device, dtype)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            mult = s.scale / math.sqrt(fan_in)
            if len(s.shape) >= 4:
                a = torch.empty(s.shape, dtype=dtype, device=device)
                for m in a.view(-1, *s.shape[-2:]):
                    m.copy_(torch.randn(m.shape, generator=generator, device=device) * mult)
            else:
                a = torch.randn(s.shape, generator=generator, device=device)
                a = (a * mult).to(dtype)
        out.append(a)
    return unflatten(spec_tree, [a for a in out], is_leaf=lambda x: isinstance(x, Spec))


# ---------------------------------------------------------------------------
# Tree helpers (nested dicts)
# ---------------------------------------------------------------------------
def flatten(tree, is_leaf=None, _prefix: str = "") -> list:
    """[(key path, leaf)] in sorted-key order."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        out = []
        for k in sorted(tree):
            out += flatten(tree[k], is_leaf, f"{_prefix}[{k!r}]")
        return out
    return [(_prefix, tree)]


def unflatten(tree, leaves, is_leaf=None):
    """A tree shaped like ``tree`` whose leaves (in flatten order) are
    ``leaves``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict) and not (is_leaf and is_leaf(t)):
            return {k: rebuild(t[k]) for k in sorted(t)}
        return next(it)

    out = rebuild(tree)
    assert next(it, None) is None, "more leaves than the tree holds"
    return out


def tree_map(fn, tree, is_leaf=None):
    return unflatten(tree, [fn(x) for _, x in flatten(tree, is_leaf)], is_leaf)


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Carry a parameter tree of numpy arrays (e.g. the reference's params
    converted with ``np.asarray``) onto ``device`` in ``cfg.param_dtype``."""
    from repro_torch.kernels.backend import resolve_device

    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, cfg.param_dtype),
        tree,
    )
