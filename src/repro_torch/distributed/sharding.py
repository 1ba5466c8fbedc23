"""Logical-axis -> mesh sharding rules (DP / FSDP / TP / EP / SP), the
reliability layer's mesh axes, and the placement of tensors by a sharding.

Parameters carry logical axes from the model's spec tree
(``lm.logical_axes``); the rules map them onto a mesh with the reference's
legality fallbacks:

  * "vocab" / "heads" / "ffn" / "experts" -> "model"  (TP / EP)
  * "embed"        -> batch super-axis ("pod", "data") when FSDP is enabled
  * "layers"/None  -> replicated

One mesh axis is never used twice in a spec; non-divisible dims fall back to
replication. Decode KV caches are sharded over the sequence axis on "model"
(flash-decoding), and over every axis for the B=1 long-context cells. The
rules read only a mesh's ``axis_names`` and ``shape`` (a {name: size}
mapping), so they run on an abstract mesh (``launch.mesh.abstract_mesh``,
the pod meshes of ``make_production_mesh``) as on a process group's mesh
(``launch.mesh.HostMesh``).

A spec (``PartitionSpec``) is a tuple with the reference's entries, one per
tensor dim: a mesh axis name, a tuple of names, or None. A sharding
(``NamedSharding``) is a (mesh, spec) pair. ``place`` turns full tensors
into ``torch.distributed.tensor.DTensor``s on a ``HostMesh``: an entry
naming axes becomes ``Shard(dim)`` on those mesh dims, in mesh order, and
``Replicate()`` elsewhere; each rank keeps its slice of the full tensor, so
placing moves nothing between ranks. ``gather`` turns DTensors back into
full tensors with one all-gather a sharded leaf, or over the batch axes
only (``gather(tree, axes)``): the training mesh's step gathers an
FSDP-sharded leaf over "data" and keeps its "model" shard local, where the
forward computes on it tensor- and expert-parallel (``placed_by_rules``;
``model_bounds`` gives a rank's head, vocab or expert range).
``gathered_bytes`` counts the bytes gathered over each mesh axis.

One reliability shard is one chip with its own voltage rails and fault
population. Tensor parallelism lives inside a replica, whose memories share
a board and its rails, so the shard unit is the data-parallel replica: the
batch super-axis ("pod", "data"). A mesh without batch axes treats every
axis as a shard axis.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import torch

from repro_torch.models import base

TP_AXES = ("vocab", "heads", "ffn", "experts")


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names (one dim
    over several axes, in mesh order) or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: PartitionSpec


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


def _is_spec(x) -> bool:
    return isinstance(x, base.Spec)


def spec_for(logical: tuple, shape: tuple, mesh, fsdp: bool) -> PartitionSpec:
    used: set = set()
    parts = []
    for ax, dim in zip(logical, shape):
        target: tuple = ()
        granularity = 0  # head-granular TP: "heads:<n>" shards only if n divides
        if ax is not None and ax.startswith("heads:"):
            target = ("model",)
            granularity = int(ax.split(":")[1])
        elif ax in TP_AXES:
            target = ("model",)
        elif ax == "embed" and fsdp:
            target = batch_axes(mesh)
        size = _axes_size(mesh, target) if target else 1
        ok = (target and not (set(target) & used) and dim % size == 0
              and (granularity == 0 or granularity % size == 0))
        if ok:
            used.update(target)
            parts.append(target[0] if len(target) == 1 else tuple(target))
        else:
            parts.append(None)
    return P(*parts)


def param_shardings(cfg, mesh, fsdp: bool):
    """The sharding tree matching ``lm.param_struct(cfg)``."""
    from repro_torch.models import lm

    return base.tree_map(lambda s: NamedSharding(mesh, spec_for(s.axes, s.shape, mesh, fsdp)),
                         lm.init_specs(cfg), is_leaf=_is_spec)


def spec_fsdp_only(logical: tuple, shape: tuple, mesh) -> PartitionSpec:
    """Pure ZeRO-3: no tensor parallelism; the largest weight dim sharded
    over all mesh axes combined."""
    all_axes = tuple(mesh.axis_names)
    size = _axes_size(mesh, all_axes)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    parts: list = [None] * len(shape)
    for i in order:
        if logical[i] != "layers" and shape[i] % size == 0:
            parts[i] = all_axes if len(all_axes) > 1 else all_axes[0]
            break
    return P(*parts)


def param_shardings_fsdp_only(cfg, mesh):
    from repro_torch.models import lm

    return base.tree_map(lambda s: NamedSharding(mesh, spec_fsdp_only(s.axes, s.shape, mesh)),
                         lm.init_specs(cfg), is_leaf=_is_spec)


def data_sharding_all_axes(mesh, global_batch: int) -> NamedSharding:
    """Batch sharded over every mesh axis (pure-DP/FSDP regime)."""
    axes = tuple(mesh.axis_names)
    if global_batch % _axes_size(mesh, axes) == 0:
        return NamedSharding(mesh, P(axes))
    return data_sharding(mesh, global_batch)


def data_sharding(mesh, global_batch: int) -> NamedSharding:
    """Sharding for (B, ...) batch arrays; replicated if B doesn't divide."""
    ba = batch_axes(mesh)
    if ba and global_batch % _axes_size(mesh, ba) == 0:
        return NamedSharding(mesh, P(ba if len(ba) > 1 else ba[0]))
    return NamedSharding(mesh, P())


def batch_shardings(mesh, batch_struct):
    """``data_sharding`` of every leaf of a {tokens, labels, img} batch."""
    return base.tree_map(lambda leaf: data_sharding(mesh, leaf.shape[0]), batch_struct)


def _seq_axes(mesh, b: int, s: int):
    """Axes for the KV sequence dim: 'model' plus (if the batch is
    unshardable) the batch axes too, for B=1 long-context decode."""
    ba = batch_axes(mesh)
    batch_ok = bool(ba) and b % _axes_size(mesh, ba) == 0
    axes = ("model",) if batch_ok else tuple(ba) + ("model",)
    if s % _axes_size(mesh, axes) == 0:
        return axes, batch_ok
    return (), batch_ok


def cache_shardings(cfg, mesh, cache_struct):
    """The sharding tree of the decode cache (see the module docstring)."""
    ba = batch_axes(mesh)
    b_axis = ba if len(ba) > 1 else (ba[0] if ba else None)
    model = mesh.shape["model"]

    def one(key, leaf):
        b = leaf.shape[1]
        bspec = b_axis if ba and b % _axes_size(mesh, ba) == 0 else None
        if "kv_scale" in key or "'k'" in key or "'v'" in key:
            seq_axes, _ = _seq_axes(mesh, b, leaf.shape[2])
            sspec = (None if not seq_axes
                     else seq_axes[0] if len(seq_axes) == 1 else tuple(seq_axes))
            return NamedSharding(mesh, P(None, bspec, sspec, None, None))
        if "conv" in key:
            return NamedSharding(mesh, P(None, bspec, None,
                                         "model" if leaf.shape[3] % model == 0 else None))
        if "ssm" in key:
            return NamedSharding(mesh, P(None, bspec,
                                         "model" if leaf.shape[2] % model == 0 else None, None))
        if "shift" in key:
            return NamedSharding(mesh, P(None, bspec,
                                         "model" if leaf.shape[2] % model == 0 else None))
        if "wkv" in key:
            return NamedSharding(mesh, P(None, bspec,
                                         "model" if leaf.shape[2] % model == 0 else None,
                                         None, None))
        return NamedSharding(mesh, P())

    flat = base.flatten(cache_struct)
    return base.unflatten(cache_struct, [one(k, leaf) for k, leaf in flat])


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# -- placement on a process group's mesh --------------------------------------
def placements(mesh, spec: PartitionSpec) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for name in names:
            out[mesh.axis_names.index(name)] = Shard(d)
    return out


def local_slice(full: torch.Tensor, device_mesh, place, coord=None) -> torch.Tensor:
    """The slice of ``full`` that the rank at mesh coordinate ``coord``
    (default: this rank's) holds under ``place``: a dim sharded over several
    mesh dims is cut row-major over them, in mesh order."""
    coord = device_mesh.get_coordinate() if coord is None else coord
    idx, count = [0] * full.dim(), [1] * full.dim()
    for i, p in enumerate(place):
        if p.is_shard():
            idx[p.dim] = idx[p.dim] * device_mesh.size(i) + int(coord[i])
            count[p.dim] *= device_mesh.size(i)
    out = full
    for d in range(full.dim()):
        if count[d] > 1:
            if full.shape[d] % count[d]:
                raise ValueError(f"dim {d} of {tuple(full.shape)} does not split into "
                                 f"{count[d]} shards")
            n = full.shape[d] // count[d]
            out = out.narrow(d, idx[d] * n, n)
    return out


def place(tree, shardings):
    """Full tensors -> DTensors placed by ``shardings`` (a tree of
    ``NamedSharding``s on a ``HostMesh``); each rank keeps its own slice,
    on the mesh's device. A DTensor leaf is gathered first."""
    from torch.distributed.tensor import DTensor

    def one(leaf, sh):
        full = gather_leaf(leaf).to(sh.mesh.device)
        dm = sh.mesh.device_mesh
        pl = placements(sh.mesh, sh.spec)
        return DTensor.from_local(local_slice(full, dm, pl).contiguous(), dm, pl,
                                  run_check=False, shape=full.shape, stride=full.stride())

    flat = base.flatten(tree)
    shards = [s for _, s in base.flatten(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))]
    if len(shards) != len(flat):
        raise ValueError(f"{len(shards)} shardings for {len(flat)} leaves")
    return base.unflatten(tree, [one(leaf, s) for (_, leaf), s in zip(flat, shards)])


def model_bounds(local: int, index: int) -> tuple:
    """[start, stop) of the ``index``-th model rank's slice along a dim that
    the rules shard over "model" alone and that holds ``local`` elements a
    rank: one block a rank, in rank order (``local_slice``). The
    tensor-parallel forward reads its local head, vocab and expert ranges
    here."""
    return index * local, (index + 1) * local


def model_dim(leaf) -> int | None:
    """The tensor dim of a DTensor leaf sharded over "model" (None: a plain
    tensor, or replicated over "model")."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor) or "model" not in leaf.device_mesh.mesh_dim_names:
        return None
    p = leaf.placements[leaf.device_mesh.mesh_dim_names.index("model")]
    return p.dim if p.is_shard() and leaf.device_mesh.size(
        leaf.device_mesh.mesh_dim_names.index("model")) > 1 else None


# bytes gathered over each mesh axis since the last reset (``gathered_bytes``)
_GATHERED: dict = {}


def gathered_bytes() -> dict:
    """{mesh axis: bytes}: each gather adds the bytes of the tensor it
    returns to the count of every axis of size above 1 that it gathers a
    sharded leaf over. A count of 0 on "model" says no leaf was gathered
    over "model"."""
    return dict(_GATHERED)


def reset_gathered_bytes() -> None:
    _GATHERED.clear()


def _count(axes, t: torch.Tensor) -> None:
    for a in axes:
        _GATHERED[a] = _GATHERED.get(a, 0) + t.numel() * t.element_size()


def gather_leaf(leaf, axes=None):
    """A DTensor's full tensor on its rank's device (one all-gather of the
    local shards over the mesh's ranks, unless it is replicated); any other
    leaf as it is.

    With ``axes`` (mesh axis names) only the shards over those axes are
    gathered, over the group of the ranks along them: the result is this
    rank's slice on the other axes (its local shard over "model" where
    ``axes`` are the batch axes). One axis at a time; a dim sharded over a
    gathered axis and a later one kept local is refused (its blocks would
    not be contiguous)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return leaf
    local = leaf.to_local()
    dm = leaf.device_mesh
    names = tuple(dm.mesh_dim_names)
    want = names if axes is None else tuple(axes)
    todo = [i for i, p in enumerate(leaf.placements)
            if p.is_shard() and names[i] in want and dm.size(i) > 1]
    if not todo:
        return local
    from repro_torch.distributed import collectives

    if len(todo) < sum(p.is_shard() and dm.size(i) > 1 for i, p in enumerate(leaf.placements)):
        out = local
        for i in reversed(todo):  # inner axes first: each gather leaves whole blocks
            d = leaf.placements[i].dim
            if any(p.is_shard() and p.dim == d and j > i and j not in todo
                   for j, p in enumerate(leaf.placements)):
                raise ValueError(f"dim {d} is sharded over {names[i]!r} and an inner axis "
                                 "kept local: its blocks are not contiguous")
            out = torch.cat(collectives.all_gather(out.contiguous(), dm.get_group(names[i])),
                            dim=d)
        _count([names[i] for i in todo], out)
        return out
    if dm.size() != torch.distributed.get_world_size():
        raise ValueError(f"a mesh of {dm.size()} ranks in a world of "
                         f"{torch.distributed.get_world_size()}: gather takes a mesh over "
                         "every rank")
    parts = collectives.all_gather(local.contiguous(), None)
    full = torch.empty(leaf.shape, dtype=local.dtype, device=local.device)
    for coord in itertools.product(*map(range, dm.mesh.shape)):
        local_slice(full, dm, leaf.placements, coord).copy_(parts[int(dm.mesh[coord])])
    _count([names[i] for i in todo], full)
    return full


def gather(tree, axes=None):
    """Every DTensor leaf of ``tree`` gathered (``gather_leaf``): whole, or
    over ``axes`` only."""
    return base.tree_map(lambda t: gather_leaf(t, axes), tree)


def placed_by_rules(tree, cfg, mesh) -> bool:
    """Whether every leaf of ``tree`` is placed on "model" as the rules
    (``param_shardings``) place it: sharded on the rule's dim, or replicated
    where the rule replicates it. The tensor-parallel step takes such a
    tree; any other placement is gathered whole."""
    rules = [s for _, s in base.flatten(param_shardings(cfg, mesh, fsdp=False),
                                        is_leaf=lambda x: isinstance(x, NamedSharding))]
    flat = base.flatten(tree)
    if len(rules) != len(flat):
        return False
    for (_, leaf), rule in zip(flat, rules):
        want = next((d for d, e in enumerate(rule.spec) if e == "model"), None)
        if model_dim(leaf) != want:
            return False
    return True


def to_local(tree):
    """Each DTensor leaf's local shard; other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return base.tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def like(local_tree, ref_tree):
    """The local shards ``local_tree`` wrapped as DTensors placed as the
    leaves of ``ref_tree`` are (plain where those are plain)."""
    from torch.distributed.tensor import DTensor

    def one(t, ref):
        if not isinstance(ref, DTensor):
            return t
        return DTensor.from_local(t, ref.device_mesh, ref.placements, run_check=False,
                                  shape=ref.shape, stride=ref.stride())

    flat = [t for _, t in base.flatten(local_tree)]
    refs = [r for _, r in base.flatten(ref_tree)]
    return base.unflatten(ref_tree, [one(t, r) for t, r in zip(flat, refs)])


def shard_like(full_tree, ref_tree, axes=None):
    """Each full tensor of ``full_tree`` cut to the local slice of the
    matching DTensor of ``ref_tree`` (whole where that leaf is plain); with
    ``axes``, cut over those mesh axes only (a tensor gathered over them,
    ``gather(tree, axes)``, back to its shard)."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t, ref):
        if not isinstance(ref, DTensor):
            return t
        names = ref.device_mesh.mesh_dim_names
        place = [p if axes is None or names[i] in axes else Replicate()
                 for i, p in enumerate(ref.placements)]
        return local_slice(t, ref.device_mesh, place)

    flat = [t for _, t in base.flatten(full_tree)]
    refs = [r for _, r in base.flatten(ref_tree)]
    return base.unflatten(ref_tree, [one(t, r) for t, r in zip(flat, refs)])
