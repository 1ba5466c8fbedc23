"""EccMemoryDomain: a software-defined "BRAM" under one voltage rail.

Arrays written into the domain are stored bit-exact as SECDED(72,64) word
planes (two uint32 data lanes and one uint8 check plane) on the domain's
device. Reads happen at the domain's rail voltage: the fault field's XOR
masks go into all three planes (check bits undervolt too, as in the real
BRAM), then the SECDED decoder corrects or flags each word and the read's
telemetry is collected.

Masks come from the host numpy ``FaultField``, one per array, seeded by
(domain seed, array name), so the faulty words are bit-identical to the
reference domain's. A read is ``ops.inject`` then ``ops.decode``: two
kernel launches on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quantize
from repro_torch.core.faultsim import FaultField, device_masks, flip_counts, gather_masks
from repro_torch.core.planestore import leaf_seed
from repro_torch.core.telemetry import FaultStats
from repro_torch.core.voltage import PLATFORMS, PlatformProfile
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import base


@dataclasses.dataclass
class EncodedArray:
    """One array stored in the domain: its planes on the device and what
    rebuilds it."""

    lo: torch.Tensor  # (n,) int32 bit patterns
    hi: torch.Tensor  # (n,) int32 bit patterns
    parity: torch.Tensor  # (n,) uint8
    nbytes: int
    shape: tuple
    dtype: torch.dtype
    field: FaultField

    @property
    def n_words(self) -> int:
        return self.lo.shape[0]


class EccMemoryDomain:
    """A named collection of SECDED-protected arrays under one voltage rail.

    ``device=None`` keeps the planes on the card and raises without one."""

    def __init__(
        self,
        platform: str | PlatformProfile = "vc707",
        seed: int = 0,
        ecc_enabled: bool = True,
        voltage: float | None = None,
        device=None,
    ):
        self.platform = PLATFORMS[platform] if isinstance(platform, str) else platform
        self.seed = seed
        self.ecc_enabled = ecc_enabled
        self.voltage = self.platform.v_nom if voltage is None else voltage
        self.device = resolve_device(device)
        self._store: dict[str, EncodedArray] = {}
        self.stats = FaultStats()

    # -- rail control --------------------------------------------------------
    def set_voltage(self, v: float) -> None:
        if v < self.platform.v_crash:
            raise RuntimeError(
                f"rail collapsed: {v:.3f} V < V_crash={self.platform.v_crash} V"
            )
        self.voltage = float(v)

    # -- storage --------------------------------------------------------------
    def write(self, name: str, arr) -> None:
        """Store ``arr`` (a tensor, or an array ``torch.as_tensor`` takes)
        under ``name``; its check plane is encoded on the domain's device."""
        t = torch.as_tensor(arr).to(self.device)
        lo, hi, nbytes = quantize.array_to_words(t)
        parity = kops.encode(lo, hi)
        field = FaultField(self.platform, lo.shape[0], seed=leaf_seed(self.seed, name))
        self._store[name] = EncodedArray(lo, hi, parity, nbytes, tuple(t.shape), t.dtype, field)

    def write_pytree(self, prefix: str, tree) -> None:
        """Store every leaf of a nested-dict tree under ``prefix`` + its key
        path (``"w['blocks']['p0']..."``)."""
        for key, leaf in base.flatten(tree):
            self.write(prefix + key, leaf)

    def names(self):
        return list(self._store)

    def entry(self, name: str) -> EncodedArray:
        return self._store[name]

    # -- read path -------------------------------------------------------------
    def read(self, name: str, voltage: float | None = None):
        """Read one array at the rail voltage (or ``voltage``). Returns
        (tensor, FaultStats); the stats also join the domain's."""
        e = self._store[name]
        v = self.voltage if voltage is None else voltage
        arr, stats = decode_read(
            e, device_masks(e.field, v, self.device), ecc_enabled=self.ecc_enabled
        )
        self.stats.accumulate(stats)
        return arr, stats

    def read_pytree(self, prefix: str, tree_like, voltage: float | None = None):
        """Read a whole tree written with ``write_pytree``. Returns (tree,
        FaultStats). The masks of every leaf are drawn first, together, on
        a pool of threads."""
        v = self.voltage if voltage is None else voltage
        keys = [prefix + key for key, _ in base.flatten(tree_like)]
        if self.platform.fault_rate(float(v)) > 0.0:
            gather_masks([(self._store[k].field, v) for k in keys])
        out, agg = [], FaultStats()
        for k in keys:
            arr, stats = self.read(k, v)
            out.append(arr)
            agg.accumulate(stats)
        return base.unflatten(tree_like, out), agg


def decode_read(e: EncodedArray, masks, ecc_enabled: bool = True):
    """Fault-inject + SECDED-decode read of one EncodedArray with ``masks`` =
    (lo, hi, check) mask tensors on its device. Returns (tensor, FaultStats);
    without ECC the stats hold the masks' ground truth only."""
    lo, hi, parity = kops.inject(e.lo, e.hi, e.parity, *masks)
    status = None
    if ecc_enabled:
        lo, hi, status = kops.decode(lo, hi, parity)
    arr = quantize.words_to_array(lo, hi, e.nbytes, e.shape, e.dtype)
    flips = flip_counts(*masks)
    if ecc_enabled:
        return arr, FaultStats.from_decode(status, flips)
    return arr, FaultStats.from_flips(flips)
