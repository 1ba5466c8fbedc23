"""Batched plane store: every EccWeight plane of a model in one flat arena.

The clean (lo, hi, check) planes of all protected leaves are concatenated at
protect time into flat (n_words,) arenas on the model's device, with a leaf
-> [offset, offset+size) slot index. A voltage step is one fused
``inject_scrub`` launch over the whole arena (``inject_scrub_domains`` with a
per-domain rail schedule), and only the counter block crosses to the host.

Masks come from the host numpy ``FaultField``, one field per leaf keyed by
``leaf_seed(seed, key)``, so the faulty planes are bit-identical to the
reference store's. All domains share the built-in SECDED code: one codec
group whose planes are the master arenas.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch import codes
from repro_torch.codes import DEFAULT_CODEC
from repro_torch.core.faultsim import FaultField, flip_counts, gather_masks
from repro_torch.core.telemetry import DomainFaultStats, FaultStats
from repro_torch.core.voltage import PlatformProfile
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device


def leaf_seed(base_seed: int, key: str) -> int:
    """Per-leaf fault-field seed: the fault pattern is a property of
    (silicon sample, rail), i.e. (seed, leaf)."""
    return (base_seed * 0x9E3779B1 + zlib.crc32(key.encode())) & 0x7FFFFFFF


def inject_leaf(leaf, masks, ecc: bool = True):
    """The per-leaf reference step of one EccWeight leaf: inject ``masks``
    ((lo, hi, check) tensors shaped like its planes), re-encode the check
    bits over the faulty data when ECC is off (the decoder then passes the
    faults through, as when all 72 bits are data), and scrub. Returns (faulty
    leaf, FaultStats); bit-identical to the leaf's slice of a batched step."""
    lo, hi, par = kops.inject(leaf.lo, leaf.hi, leaf.parity, *masks)
    if not ecc:
        par = kops.encode(lo, hi)
    faulty = dataclasses.replace(leaf, lo=lo, hi=hi, parity=par)
    return faulty, FaultStats.from_decode(kops.scrub(faulty), flip_counts(*masks))


@dataclasses.dataclass(frozen=True)
class Slot:
    """Arena placement of one EccWeight leaf's planes."""

    key: str
    offset: int
    size: int
    shape: tuple
    domain: str = "all"


def _words(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 / uint8 plane -> torch int32 / uint8 on ``device``."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


class PlaneStore:
    """Flat arena over a sequence of EccWeight leaves (clean planes).

    With a ``domain_key`` classifier the arena is partitioned into named
    memory domains; ``set_rails`` drives one rail voltage per domain and
    returns one counter row per domain. ``profiles`` optionally gives a
    domain its own PlatformProfile.
    """

    def __init__(
        self,
        leaves,
        keys,
        platform: PlatformProfile,
        seed: int = 0,
        domain_key=None,
        profiles=None,
        codecs=None,
        device=None,
    ):
        assert len(leaves) == len(set(keys)), "leaf keys must be unique"
        self.platform = platform
        self.seed = int(seed)
        self._profiles = dict(profiles or {})
        classify = domain_key if domain_key is not None else (lambda _k: "all")
        slots, off = [], 0
        los, his, pars = [], [], []
        for key, leaf in zip(keys, leaves):
            size = int(leaf.lo.numel())
            slots.append(Slot(key, off, size, tuple(leaf.lo.shape), str(classify(key))))
            los.append(leaf.lo.reshape(-1))
            his.append(leaf.hi.reshape(-1))
            pars.append(leaf.parity.reshape(-1))
            off += size
        # Keep only plane-free leaf metadata (scale/k/n); the arena owns the
        # clean plane data.
        self._leaves = [
            dataclasses.replace(leaf, lo=None, hi=None, parity=None) for leaf in leaves
        ]
        self.slots = tuple(slots)
        self.n_words = off
        # device=None follows the leaves; with none it is the card, as for
        # every entry point.
        self.device = resolve_device(los[0].device if device is None and los else device)
        if los:
            self.lo = torch.cat(los).to(self.device)
            self.hi = torch.cat(his).to(self.device)
            self.parity = torch.cat(pars).to(self.device)
        else:
            self.lo = torch.zeros(0, dtype=torch.int32, device=self.device)
            self.hi = torch.zeros(0, dtype=torch.int32, device=self.device)
            self.parity = torch.zeros(0, dtype=torch.uint8, device=self.device)
        # Domain order: first appearance in arena order == counter row order.
        self.domains = tuple(dict.fromkeys(s.domain for s in self.slots))
        self._dom_index = {d: i for i, d in enumerate(self.domains)}
        dom_ids = np.zeros(self.n_words, np.int32)
        for s in self.slots:
            dom_ids[s.offset : s.offset + s.size] = self._dom_index[s.domain]
        self.dom_ids = torch.from_numpy(dom_ids).to(self.device)
        if codecs is None:
            codecs = {}
        elif isinstance(codecs, str):
            codecs = {d: codecs for d in self.domains}
        self._codecs = {d: str(codecs.get(d, DEFAULT_CODEC)) for d in self.domains}
        unported = sorted(set(self._codecs.values()) - {DEFAULT_CODEC})
        if unported:
            raise NotImplementedError(
                f"codecs {unported}: only {DEFAULT_CODEC} is ported"
            )
        self.codec = codes.get(DEFAULT_CODEC)
        self._external_words: dict = {}
        self._external_codecs: dict = {}
        self._host_fields = {
            s.key: FaultField(
                self.domain_profile(s.domain), s.size, seed=leaf_seed(self.seed, s.key)
            )
            for s in self.slots
        }

    # -- domains -------------------------------------------------------------
    def codec_of(self, domain: str) -> str:
        return self._codecs.get(domain, DEFAULT_CODEC)

    def codecs_by_domain(self) -> dict:
        out = {d: self.codec_of(d) for d in self.domains}
        out.update(self._external_codecs)
        return out

    def check_bits_by_domain(self) -> dict:
        """Check bits per 64-bit word for every domain (power weighting)."""
        return {d: codes.get(c).n_check for d, c in self.codecs_by_domain().items()}

    def domain_profile(self, domain: str) -> PlatformProfile:
        return self._profiles.get(domain, self.platform)

    def register_domain_words(self, domain: str, words: int, codec: str = DEFAULT_CODEC) -> None:
        """Account storage that lives outside the arena (the paged KV cache)
        under a named domain: it joins ``words_by_domain`` (power weighting)
        but not the arena's counter rows."""
        self._external_words[str(domain)] = int(words)
        self._external_codecs[str(domain)] = str(codec)

    def words_by_domain(self) -> dict:
        """Word count per domain: arena slots plus registered external
        domains."""
        counts = dict.fromkeys(self.domains, 0)
        for s in self.slots:
            counts[s.domain] += s.size
        for d, w in self._external_words.items():
            counts[d] = counts.get(d, 0) + w
        return counts

    # -- masks ---------------------------------------------------------------
    def host_masks(self, v):
        """Arena-order (mask_lo, mask_hi, mask_check) at rail voltage ``v``
        (a float or a {domain: voltage} schedule), on the store's device."""
        volts = v if isinstance(v, dict) else {d: v for d in self.domains}
        if all(self.domain_profile(d).fault_rate(float(volts[d])) == 0.0 for d in self.domains):
            # At or above every rail's V_min nothing flips: zero masks made
            # on the device, with no host arrays and no copy.
            z = lambda dt: torch.zeros(self.n_words, dtype=dt, device=self.device)
            return z(torch.int32), z(torch.int32), z(torch.uint8)
        masks = gather_masks(
            [(self._host_fields[s.key], volts[s.domain]) for s in self.slots]
        )
        cat = lambda xs: _words(np.concatenate(xs), self.device)
        return (
            cat([m.lo for m in masks]),
            cat([m.hi for m in masks]),
            cat([m.parity for m in masks]),
        )

    # -- the batched voltage step --------------------------------------------
    def set_voltage(self, v: float, ecc: bool = True):
        """One fused inject+scrub launch for the whole store.

        Returns (faulty_leaves, FaultStats): the leaves with lo/hi/parity
        replaced by arena slices at rail voltage ``v``."""
        if self.n_words == 0:
            return list(self._leaves), FaultStats()
        mlo, mhi, mpar = self.host_masks(v)
        flo, fhi, fpar, cnt = kops.inject_scrub(
            self.lo, self.hi, self.parity, mlo, mhi, mpar,
            codec=self.codec.name, reencode=not ecc,
        )
        stats = FaultStats.from_counters(cnt.cpu().numpy(), words=self.n_words)
        return self._slice_leaves(flo, fhi, fpar), stats

    def set_rails(self, volts: dict, ecc: bool = True):
        """One fused inject+scrub launch with a separate rail per domain.

        ``volts`` maps every domain to its voltage. Returns (faulty_leaves,
        DomainFaultStats); a uniform schedule gives the planes and total
        counters of ``set_voltage``."""
        missing = set(self.domains) - set(volts)
        assert not missing, f"rails missing for domains: {sorted(missing)}"
        if self.n_words == 0:
            return list(self._leaves), DomainFaultStats()
        mlo, mhi, mpar = self.host_masks(dict(volts))
        flo, fhi, fpar, cnt = kops.inject_scrub_domains(
            self.lo, self.hi, self.parity, mlo, mhi, mpar, self.dom_ids,
            len(self.domains), codec=self.codec.name, reencode=not ecc,
        )
        stats = FaultStats.from_counter_matrix(
            cnt.cpu().numpy(), self.domains, self.words_by_domain()
        )
        return self._slice_leaves(flo, fhi, fpar), stats

    def _slice_leaves(self, flo, fhi, fpar):
        """Per-leaf EccWeight views of the faulty arena planes."""
        return [
            dataclasses.replace(
                leaf,
                lo=flo[s.offset : s.offset + s.size].reshape(s.shape),
                hi=fhi[s.offset : s.offset + s.size].reshape(s.shape),
                parity=fpar[s.offset : s.offset + s.size].reshape(s.shape),
            )
            for s, leaf in zip(self.slots, self._leaves)
        ]
