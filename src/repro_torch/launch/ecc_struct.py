"""Struct-level ECC parameter transform for the dry run.

Mirrors ``serving.engine.protect_params_inline`` on the meta device: each
protected weight matrix becomes an ``EccWeight`` whose planes are meta
tensors (lo / hi the int32 bit patterns of the uint32 words, the check plane
uint8, the scale float32), so an ECC-protected serve cell's inputs and
shardings exist at full scale with nothing allocated. The planes' shardings
derive from the weight's logical axes: a (L, K/8, N) plane inherits
(axes_L, axes_K, axes_N), the (L, N) scale (axes_L, axes_N). The
reference's ``fuse`` flag selects which read path its dry run lowers; the
port lowers nothing, so it has none.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.ops import EccWeight
from repro_torch.models import base, lm


def _protectable(key: str, shape) -> bool:
    # stacked (L, K, N) weight matrices of attention / MLP blocks
    return (("attn" in key or "mlp" in key) and len(shape) == 3 and shape[1] % 8 == 0
            and min(shape[1:]) >= 64)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _map_specs(cfg, fn):
    specs = lm.init_specs(cfg)
    flat = base.flatten(specs, is_leaf=lambda x: isinstance(x, base.Spec))
    return base.unflatten(specs, [fn(k, s) for k, s in flat],
                          is_leaf=lambda x: isinstance(x, base.Spec))


def ecc_param_struct(cfg):
    """The parameter tree on the meta device with ``EccWeight`` nodes in
    place of the protected leaves."""
    def one(key, s):
        if not _protectable(key, s.shape):
            return _meta(s.shape, cfg.param_dtype)
        n_l, k, n = s.shape
        return EccWeight(lo=_meta((n_l, k // 8, n), torch.int32),
                         hi=_meta((n_l, k // 8, n), torch.int32),
                         parity=_meta((n_l, k // 8, n), torch.uint8),
                         scale=_meta((n_l, n), torch.float32), k=k, n=n)

    return _map_specs(cfg, one)


def ecc_param_shardings(cfg, mesh, fsdp: bool):
    """The sharding tree matching ``ecc_param_struct``."""
    def one(key, s):
        if not _protectable(key, s.shape):
            return shd.NamedSharding(mesh, shd.spec_for(s.axes, s.shape, mesh, fsdp))
        lax_, kax, nax = s.axes  # ("layers", axes_K, axes_N)
        plane_shape = (s.shape[0], s.shape[1] // 8, s.shape[2])
        plane = shd.NamedSharding(mesh, shd.spec_for((lax_, kax, nax), plane_shape, mesh, fsdp))
        scale = shd.NamedSharding(
            mesh, shd.spec_for((lax_, nax), (s.shape[0], s.shape[2]), mesh, fsdp))
        return EccWeight(lo=plane, hi=plane, parity=plane, scale=scale, k=s.shape[1],
                         n=s.shape[2])

    return _map_specs(cfg, one)
