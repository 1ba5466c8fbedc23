"""The reliability layer's mesh axes.

One reliability shard is one chip with its own voltage rails and fault
population. Tensor parallelism lives inside a replica, whose memories share
a board and its rails, so the shard unit is the data-parallel replica: the
batch super-axis ("pod", "data"). A mesh without batch axes treats every
axis as a shard axis.

Not ported here: the parameter, cache and data sharding rules, which the
training mesh brings.
"""

from __future__ import annotations

import math


def batch_axes(mesh) -> tuple:
    return tuple(n for n in ("pod", "data") if n in mesh.axis_names)


def reliability_axes(mesh) -> tuple:
    """The mesh axes the reliability layer shards over."""
    ba = batch_axes(mesh)
    return ba if ba else tuple(mesh.axis_names)


def reliability_shards(mesh) -> int:
    """The chip count of the reliability layer on ``mesh`` (its rail sets)."""
    return _axes_size(mesh, reliability_axes(mesh))


def _axes_size(mesh, axes: tuple) -> int:
    shape = mesh.shape
    return math.prod(shape[a] for a in axes)
