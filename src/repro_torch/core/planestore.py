"""Batched plane store: every EccWeight plane of a model in one flat arena.

The clean (lo, hi, check) planes of all protected leaves are concatenated at
protect time into flat (n_words,) arenas on the model's device, with a leaf
-> [offset, offset+size) slot index. A voltage step is one fused
``inject_scrub`` launch over the whole arena (``inject_scrub_domains`` with a
per-domain rail schedule), and only the counter block crosses to the host.

Masks come from the host numpy ``FaultField``, one field per leaf keyed by
``leaf_seed(seed, key)`` with the leaf's codec's check bits, so the faulty
planes are bit-identical to the reference store's.

Codecs: every memory domain selects a registered ECC scheme (``codecs`` maps
domain -> codec name; default the built-in ``secded72``). Slots sharing a
codec form one *group* with its own concatenated planes, check plane (encoded
under the group's codec from the clean data) and domain ids, and a voltage
step is one fused launch per group with the counters summed over groups. A
store of one codec is one group whose planes alias the master arenas (and,
under SECDED, the check plane the leaves arrived with).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch import codes
from repro_torch.codes import DEFAULT_CODEC
from repro_torch.codes.base import as_words
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


@dataclasses.dataclass(eq=False)
class CodecGroup:
    """Slots sharing one ECC scheme: one fused launch per voltage step."""

    name: str
    codec: codes.Codec
    slot_ids: tuple  # indices into store.slots, arena order
    offsets: tuple  # per-slot word offset inside the group's planes
    n_words: int
    lo: torch.Tensor  # (n_words,) int32 clean data
    hi: torch.Tensor
    check: torch.Tensor  # (n_words,) the codec's check dtype
    dom_ids: torch.Tensor  # (n_words,) int32 store-global domain indices


class PlaneStore:
    """Flat arena over a sequence of EccWeight leaves (clean planes).

    With a ``domain_key`` classifier the arena is partitioned into named
    memory domains; ``set_rails`` drives one rail voltage per domain and
    returns one counter row per domain. ``profiles`` optionally gives a
    domain its own PlatformProfile; ``codecs`` (a name, or {domain: name})
    its ECC scheme.
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
            self.parity = torch.cat(pars).to(self.device)  # SECDED, as packed
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
        for name in self._codecs.values():
            codes.get(name)  # fail fast on unknown codecs
        self._external_words: dict = {}
        self._external_codecs: dict = {}
        self._build_groups()

    # -- codec groups --------------------------------------------------------
    def codec_of(self, domain: str) -> str:
        return self._codecs.get(domain, DEFAULT_CODEC)

    def _build_groups(self) -> None:
        """(Re)build the per-codec groups from the master clean planes, and
        the per-leaf host fields with each group's check bits. One codec:
        one group aliasing the master planes (and SECDED's check plane)."""
        by_codec: dict = {}
        for si, s in enumerate(self.slots):
            by_codec.setdefault(self.codec_of(s.domain), []).append(si)
        single = len(by_codec) == 1
        groups = []
        for name, slot_ids in by_codec.items():
            codec = codes.get(name)
            offsets, off = [], 0
            for si in slot_ids:
                offsets.append(off)
                off += self.slots[si].size
            if single:
                lo, hi, dom = self.lo, self.hi, self.dom_ids
            else:
                cut = lambda t: torch.cat(
                    [t[self.slots[si].offset : self.slots[si].offset + self.slots[si].size]
                     for si in slot_ids]
                )
                lo, hi, dom = cut(self.lo), cut(self.hi), cut(self.dom_ids)
            if single and name == DEFAULT_CODEC:
                check = self.parity  # the leaves arrived SECDED-encoded
            else:
                check = kops.encode(lo, hi, codec=name)
            groups.append(CodecGroup(name, codec, tuple(slot_ids), tuple(offsets), off,
                                     lo, hi, check, dom))
        self.groups = tuple(groups)
        self._host_fields = {
            self.slots[si].key: FaultField(
                self.domain_profile(self.slots[si].domain), self.slots[si].size,
                seed=leaf_seed(self.seed, self.slots[si].key), n_check=g.codec.n_check,
            )
            for g in self.groups for si in g.slot_ids
        }

    def set_domain_codec(self, domain: str, codec_name: str) -> None:
        """Re-protect ``domain`` under another registered code: the groups
        are rebuilt from the clean master data (check planes re-encoded, host
        fields with the new check bits); the other domains' groups keep
        their membership and masks."""
        codes.get(codec_name)  # validate early
        assert domain in self.domains, (domain, self.domains)
        if self.codec_of(domain) == codec_name:
            return
        self._codecs[domain] = str(codec_name)
        self._build_groups()

    def codecs_by_domain(self) -> dict:
        out = {d: self.codec_of(d) for d in self.domains}
        out.update(self._external_codecs)
        return out

    def check_bits_by_domain(self) -> dict:
        """Check bits per 64-bit word for every domain (power weighting)."""
        return {d: codes.get(c).n_check for d, c in self.codecs_by_domain().items()}

    # -- domains -------------------------------------------------------------
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
    def group_host_masks(self, v) -> list:
        """Per group, its arena-order (mask_lo, mask_hi, mask_check) at rail
        voltage ``v`` (a float or a {domain: voltage} schedule), on the
        store's device. A group whose rails all lie at or above V_min gets
        zero masks made on the device (no host arrays, no copy); the others'
        fields are drawn together on the thread pool."""
        volts = v if isinstance(v, dict) else {d: v for d in self.domains}
        zero_rate = lambda si: self.domain_profile(self.slots[si].domain).fault_rate(
            float(volts[self.slots[si].domain])) == 0.0
        drawn = [not all(map(zero_rate, g.slot_ids)) for g in self.groups]
        fields = [(self._host_fields[self.slots[si].key], volts[self.slots[si].domain])
                  for g, d in zip(self.groups, drawn) if d for si in g.slot_ids]
        masks = iter(gather_masks(fields)) if fields else iter(())
        out = []
        for g, d in zip(self.groups, drawn):
            if not d:
                z = lambda dt: torch.zeros(g.n_words, dtype=dt, device=self.device)
                out.append((z(torch.int32), z(torch.int32), z(g.codec.check_torch_dtype)))
                continue
            ms = [next(masks) for _ in g.slot_ids]
            cat = lambda xs: torch.from_numpy(as_words(np.concatenate(xs))).to(self.device)
            out.append((cat([m.lo for m in ms]), cat([m.hi for m in ms]),
                        cat([m.parity for m in ms])))
        return out

    def host_masks(self, v):
        """(mask_lo, mask_hi, mask_check) of a single-group store at ``v``."""
        assert len(self.groups) == 1, "host_masks is a single-group helper"
        return self.group_host_masks(v)[0]

    # -- the batched voltage step --------------------------------------------
    def set_voltage(self, v: float, ecc: bool = True):
        """One fused inject+scrub launch per codec group.

        Returns (faulty_leaves, FaultStats): the leaves with lo/hi/parity
        replaced by group slices at rail voltage ``v``."""
        if self.n_words == 0:
            return list(self._leaves), FaultStats()
        outs = [
            kops.inject_scrub(g.lo, g.hi, g.check, *m, codec=g.name, reencode=not ecc)
            for g, m in zip(self.groups, self.group_host_masks(v))
        ]
        cnt = torch.stack([o[3] for o in outs]).sum(dim=0)
        stats = FaultStats.from_counters(cnt.cpu().numpy(), words=self.n_words)
        return self._slice_leaves([o[:3] for o in outs]), stats

    def set_rails(self, volts: dict, ecc: bool = True):
        """One fused inject+scrub launch per codec group with a separate rail
        per domain.

        ``volts`` maps every domain to its voltage. Returns (faulty_leaves,
        DomainFaultStats); a uniform schedule gives the planes and total
        counters of ``set_voltage``."""
        missing = set(self.domains) - set(volts)
        assert not missing, f"rails missing for domains: {sorted(missing)}"
        if self.n_words == 0:
            return list(self._leaves), DomainFaultStats()
        outs = [
            kops.inject_scrub_domains(
                g.lo, g.hi, g.check, *m, g.dom_ids, len(self.domains),
                codec=g.name, reencode=not ecc,
            )
            for g, m in zip(self.groups, self.group_host_masks(dict(volts)))
        ]
        cnt = torch.stack([o[3] for o in outs]).sum(dim=0)
        stats = FaultStats.from_counter_matrix(
            cnt.cpu().numpy(), self.domains, self.words_by_domain()
        )
        return self._slice_leaves([o[:3] for o in outs]), stats

    def _slice_leaves(self, planes) -> list:
        """Per-leaf EccWeight views of the groups' faulty planes, ``planes``
        one (lo, hi, check) per group."""
        out: list = [None] * len(self.slots)
        for g, (flo, fhi, fpar) in zip(self.groups, planes):
            for si, off in zip(g.slot_ids, g.offsets):
                s = self.slots[si]
                out[si] = dataclasses.replace(
                    self._leaves[si],
                    lo=flo[off : off + s.size].reshape(s.shape),
                    hi=fhi[off : off + s.size].reshape(s.shape),
                    parity=fpar[off : off + s.size].reshape(s.shape),
                )
        return out
