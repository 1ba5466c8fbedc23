"""The reliability layer's per-shard primitives.

Each reliability shard draws its own fault population. Shard 0 keeps the
unsharded stream, the anchor that makes a one-shard mesh equal the
unsharded arena bit for bit; every other shard keys its stream with
``shard_seed``. The one cross-shard reduction is the sum of a stacked
per-shard counter block over its shard axis.

Not ported here: the int8-compressed gradient all-reduce and the
data-parallel train step, which the training mesh brings.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import reliability_axes


def shard_index(coords: dict, mesh, axes=None) -> int:
    """Row-major linear shard index of the coordinates ``coords`` ({axis:
    index}) over ``axes`` (default: the mesh's reliability axes)."""
    axes = reliability_axes(mesh) if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))
    shape = mesh.shape
    idx = 0
    for a in axes:
        idx = idx * shape[a] + int(coords[a])
    return idx


def shard_seed(seed: int, shard: int) -> int:
    """The field seed of shard ``shard``: shard 0 keeps ``seed``, every other
    shard keys its own stream."""
    return int(seed) if shard == 0 else int(seed) ^ (int(shard) << 32)


def shard_key(seed: int, coords: dict, mesh, axes=None) -> int:
    """The stream seed of the shard at ``coords``: ``seed`` on shard 0,
    ``shard_seed`` everywhere else, so no shard reproduces another's
    masks."""
    return shard_seed(seed, shard_index(coords, mesh, axes))


def psum_counters(counters: torch.Tensor) -> torch.Tensor:
    """Cross-shard reduction of a stacked (n_shards, ...) counter block: its
    sum over the shard axis."""
    return counters.sum(dim=0)
