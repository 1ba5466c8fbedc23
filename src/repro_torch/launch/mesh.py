"""Meshes of the port: the reliability mesh of data-parallel shards, the
production pod meshes as abstract meshes, and the host mesh over a
``torch.distributed`` process group.

A ``ReliabilityMesh`` names its axes, their sizes (``shape``, a mapping such
as ``{"data": 4, "model": 1}``) and the ``torch.device`` of each
reliability shard. A shard is a logical chip: several shards may share one
card (``devices=["cuda:0"] * 4``), as the reference's forced host devices
share one CPU. The decode stays on one device, as in the reference's engine,
so a ``model`` axis above 1 is recorded and not used.

The reference's meshes are TPU pods: ``make_production_mesh`` builds
(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model") over
256 or 512 chips. No host here has that many ranks, so the port returns
them as abstract meshes (axes and sizes, no devices), which is all the
sharding rules and the dry run's analytic model read. ``make_host_mesh``
is the mesh that runs: a ``HostMesh`` of ("data", "model") over the ranks
of the default process group, which the caller starts (``torchrun``, or
``torch.distributed.init_process_group`` with its address, world size and
rank). It never starts a group and never falls back to one rank. Its
"model" axis is where the training step computes tensor- and
expert-parallel (``train_step.make_mesh_train_step``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class ReliabilityMesh:
    """Axis names, their sizes and one device per reliability shard
    (``devices`` None: an abstract mesh, axes only)."""

    axis_names: tuple
    sizes: tuple
    devices: tuple | None = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    def device_of(self, shard: int) -> torch.device:
        """The device that shard ``shard`` runs on."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        return self.devices[shard]


def _indexed(d: torch.device) -> torch.device:
    """``d`` with its index: "cuda" is the current card, as a tensor placed
    there reports it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available()
                            else 0)
    return d


def abstract_mesh(shape, axes) -> ReliabilityMesh:
    """A mesh of axes and sizes with no devices (the axis rules take it)."""
    return ReliabilityMesh(tuple(axes), tuple(int(s) for s in shape))


def make_reliability_mesh(n_shards: int | None = None, model: int = 1,
                          devices=None) -> ReliabilityMesh:
    """A ("data", "model") mesh of ``n_shards`` reliability shards x
    ``model`` ways.

    ``devices`` None takes every visible card once (one shard per card,
    ``n_shards`` defaulting to all of them) and raises without one. A
    list of devices, repeats allowed, places the shards on them in order:
    ``devices=["cuda:0"] * 4`` puts four shards on one card,
    ``["cpu"] * 8`` eight on the CPU. Shard ``s`` runs on the first device
    of its row of ``model`` devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a reliability mesh takes the visible cards "
                               "unless devices= names others")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    model = int(model)
    if model < 1:
        raise ValueError(f"model must be >= 1, got {model}")
    n = len(devices)
    if n_shards is None:
        if n % model:
            raise ValueError(f"{n} devices do not split into rows of {model}")
        n_shards = n // model
    n_shards = int(n_shards)
    if n_shards < 1 or n_shards * model > n:
        raise ValueError(f"{n_shards} shards x {model} ways need {n_shards * model} devices, "
                         f"got {n}")
    return ReliabilityMesh(("data", "model"), (n_shards, model),
                           tuple(devices[s * model] for s in range(n_shards)))


def make_production_mesh(*, multi_pod: bool = False) -> ReliabilityMesh:
    """The reference's pod mesh as an abstract mesh: (16, 16) ("data",
    "model"), or (2, 16, 16) ("pod", "data", "model") across two pods."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


class HostMesh:
    """A ("data", "model") mesh over the ranks of the default process group:
    axis names, their sizes (``shape``), the ``DeviceMesh`` that DTensors
    are placed on, this rank's device and coordinate, the group of all its
    ranks (``group``), the group of the ranks along "data" through this
    rank (``batch_group``: the data-parallel replicas of its shard, in batch
    order, this rank the ``batch_index``-th of ``n_batch``) and the group of
    the ranks along "model" through it (``model_group``: the ranks whose
    shards of one replica's tensor-parallel leaves make up the whole, this
    rank the ``model_index``-th of ``n_model``)."""

    def __init__(self, device_mesh, device: torch.device):
        import torch.distributed as dist

        self.device_mesh = device_mesh
        self.group = dist.group.WORLD
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        if self.axis_names != ("data", "model"):
            raise ValueError(f"a host mesh has the axes ('data', 'model'), not {self.axis_names}")
        self.sizes = tuple(int(n) for n in device_mesh.mesh.shape)
        self.device = device
        self.coordinate = tuple(int(c) for c in device_mesh.get_coordinate())
        self.batch_group = device_mesh.get_group("data")
        self.batch_index, self.n_batch = self.coordinate[0], self.sizes[0]
        self.model_group = device_mesh.get_group("model")
        self.model_index, self.n_model = self.coordinate[1], self.sizes[1]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_host_mesh(model: int = 1, device=None) -> HostMesh:
    """A ("data", "model") mesh over the default process group's world:
    world / ``model`` data-parallel ways x ``model``. Ranks are laid out
    row-major, so rank r has coordinate (r // model, r % model). Each rank
    runs on ``device`` (None: the card, the current CUDA device, which the
    caller sets per rank; ``"cpu"`` off the card). Raises without an
    initialised process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: start one (torchrun, or "
                           "torch.distributed.init_process_group) before make_host_mesh")
    dev = resolve_device(device)
    n = dist.get_world_size()
    model = int(model)
    if model < 1 or n % model:
        raise ValueError(f"a world of {n} ranks does not split into rows of {model}")
    dm = init_device_mesh(dev.type, (n // model, model), mesh_dim_names=("data", "model"))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return HostMesh(dm, dev)
