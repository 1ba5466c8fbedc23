"""The reliability mesh: data-parallel shards, each one chip with its own
rails and fault population.

A ``ReliabilityMesh`` names its axes, their sizes (``shape``, a mapping such
as ``{"data": 4, "model": 1}``) and the ``torch.device`` of each
reliability shard. A shard is a logical chip: several shards may share one
card (``devices=["cuda:0"] * 4``), as the reference's forced host devices
share one CPU. The decode stays on one device, as in the reference's engine,
so a ``model`` axis above 1 is recorded and not used.

Not ported here: the production pod meshes (``make_production_mesh``,
``make_host_mesh``), which only the dry run and the training mesh use.
"""

from __future__ import annotations

import dataclasses

import torch


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
