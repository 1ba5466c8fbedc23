"""Fault telemetry: ECC outcomes vs ground truth (paper Fig. 1/2 counters)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import codes

# Lane order of the counter rows the fused inject+scrub kernel reduces.
COUNTER_FIELDS = (
    "clean", "corrected", "detected", "silent",
    "words_1bit", "words_2bit", "words_multi", "faulty_bits",
)


def counter_lanes(status: torch.Tensor, flips: torch.Tensor, genuine=None) -> list:
    """Per-word int64 lanes in ``COUNTER_FIELDS`` order, from ECC status
    codes and ground-truth flip counts of the same words.

    ``genuine`` (codecs with ``exact_tallies``) marks the words whose
    correction restored the clean data; without it a correction counts when
    the word had one flip, which is exact for SEC codes (a mis-correction
    needs >= 2 flips and lands in the silent lane)."""
    detected = status == codes.STATUS_DETECTED
    if genuine is None:
        corrected = (status == codes.STATUS_CORRECTED) & (flips == 1)
        silent = (flips >= 2) & ~detected
    else:
        corrected = genuine
        silent = (flips >= 1) & ~detected & ~genuine
    lanes = (
        (status == codes.STATUS_CLEAN) & (flips == 0),
        corrected,
        detected,
        silent,
        flips == 1,
        flips == 2,
        flips >= 3,
        flips,
    )
    return [t.to(torch.int64) for t in lanes]


@dataclasses.dataclass
class FaultStats:
    """Aggregated per-read fault statistics for one memory domain.

    ``shard`` is bookkeeping (-1: unsharded or aggregated), never summed."""

    words: int = 0
    clean: int = 0  # syndrome 0, no ground-truth flips
    corrected: int = 0  # ECC corrected a genuine single-bit fault
    detected: int = 0  # ECC raised the uncorrectable (DED) flag
    silent: int = 0  # >= 2 flips that ECC mis-corrected or aliased to clean
    words_1bit: int = 0
    words_2bit: int = 0
    words_multi: int = 0
    faulty_bits: int = 0
    shard: int = -1

    def accumulate(self, other: "FaultStats") -> None:
        """Add ``other``'s counters into ``self``, in place (returns None)."""
        for f in ("words",) + COUNTER_FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        if self.shard != other.shard:
            self.shard = -1

    @classmethod
    def summed(cls, stats) -> "FaultStats":
        """Pure merge of an iterable of FaultStats (or containers with
        ``total()``) into a fresh FaultStats."""
        out = cls()
        first = True
        for s in stats:
            if not isinstance(s, FaultStats):
                s = s.total()
            if first:
                out.shard = s.shard
                first = False
            out.accumulate(s)
        return out

    @property
    def faulty_words(self) -> int:
        return self.words_1bit + self.words_2bit + self.words_multi

    def coverage(self) -> dict:
        """Fractions of faulty words by ECC outcome."""
        n = max(self.faulty_words, 1)
        return {
            "correctable": self.corrected / n,
            "detectable": self.detected / n,
            "silent": self.silent / n,
        }

    def coverage_row(self) -> dict:
        """The sweep row: raw counters and the per-outcome coverage
        fractions (``coverage_<outcome>``)."""
        return {
            "words": self.words,
            "faulty_words": self.faulty_words,
            "faulty_bits": self.faulty_bits,
            "corrected": self.corrected,
            "detected": self.detected,
            "silent": self.silent,
            **{f"coverage_{k}": v for k, v in self.coverage().items()},
        }

    def to_dict(self) -> dict:
        out = {"words": self.words}
        out.update({f: getattr(self, f) for f in COUNTER_FIELDS})
        out["faulty_words"] = self.faulty_words
        if self.shard >= 0:
            out["shard"] = self.shard
        return out

    @classmethod
    def from_counters(cls, counters, words: int, shard: int = -1) -> "FaultStats":
        """Build stats from one counter row (COUNTER_FIELDS order)."""
        c = np.asarray(counters).reshape(-1)
        assert c.size >= len(COUNTER_FIELDS), c.shape
        return cls(words=int(words), shard=int(shard), **{
            f: int(c[i]) for i, f in enumerate(COUNTER_FIELDS)
        })

    def counters(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in COUNTER_FIELDS], np.int64)

    @classmethod
    def from_counter_matrix(
        cls, counters, names, words_by_domain, shard: int = -1
    ) -> "DomainFaultStats":
        """Per-domain stats from an (n_domains, 8) counter block whose row
        order is ``names``."""
        c = np.asarray(counters)
        assert c.shape[0] == len(names) and c.shape[1] >= len(COUNTER_FIELDS), c.shape
        return DomainFaultStats(
            {
                d: cls.from_counters(c[i], words=words_by_domain[d], shard=shard)
                for i, d in enumerate(names)
            },
            shard=int(shard),
        )

    @classmethod
    def from_decode(cls, status, flip_counts) -> "FaultStats":
        """Stats from per-word ECC status codes and ground-truth flip counts
        (numpy arrays or tensors; tensors are reduced on their device and
        only the counter row crosses to the host)."""
        status = torch.as_tensor(status).reshape(-1)
        flips = torch.as_tensor(flip_counts, device=status.device).reshape(-1)
        row = torch.stack([t.sum() for t in counter_lanes(status, flips)])
        return cls.from_counters(row.cpu().numpy(), words=status.numel())

    @classmethod
    def from_flips(cls, flip_counts) -> "FaultStats":
        """Stats of a read without ECC: ground truth only (``words`` and the
        flip-count lanes; no ECC outcome is counted)."""
        flips = torch.as_tensor(flip_counts).reshape(-1)
        row = torch.stack(
            [(flips == 1).sum(), (flips == 2).sum(), (flips >= 3).sum(),
             flips.to(torch.int64).sum()]
        ).cpu().numpy()
        return cls(words=flips.numel(), words_1bit=int(row[0]), words_2bit=int(row[1]),
                   words_multi=int(row[2]), faulty_bits=int(row[3]))


@dataclasses.dataclass
class DomainFaultStats:
    """Ordered mapping domain name -> FaultStats (multi-rail telemetry);
    iteration order is the store's domain order (the counter row order)."""

    by_domain: dict = dataclasses.field(default_factory=dict)
    shard: int = -1

    def __getitem__(self, domain: str) -> FaultStats:
        return self.by_domain[domain]

    def __contains__(self, domain: str) -> bool:
        return domain in self.by_domain

    @property
    def domains(self) -> tuple:
        return tuple(self.by_domain)

    def get(self, domain: str) -> FaultStats:
        return self.by_domain.get(domain, FaultStats())

    def total(self) -> FaultStats:
        return FaultStats.summed(self.by_domain.values())

    def accumulate(self, other: "DomainFaultStats") -> None:
        for d, st in other.by_domain.items():
            self.by_domain.setdefault(d, FaultStats(shard=st.shard)).accumulate(st)
        if self.shard != other.shard:
            self.shard = -1

    @classmethod
    def summed(cls, stats) -> "DomainFaultStats":
        """Pure cross-shard reduction of DomainFaultStats into a fresh
        per-domain view: domain rows keep their identity, the shard tag
        collapses to -1 unless every input carries the same one."""
        out = cls()
        first = True
        for s in stats:
            if first:
                out.shard = s.shard
                first = False
            out.accumulate(s)
        return out

    def coverage(self) -> dict:
        return {d: st.coverage() for d, st in self.by_domain.items()}


@dataclasses.dataclass
class ShardFaultStats:
    """Per-shard, per-domain fault statistics of a mesh: one
    DomainFaultStats per reliability shard, in shard order (the host view of
    an (n_shards, n_domains, 8) counter block). ``reduced()`` is the
    explicit cross-shard reduction; the per-shard rows are never collapsed
    on their own, since a `per_shard` rail walk needs each shard's row."""

    by_shard: list = dataclasses.field(default_factory=list)

    @property
    def n_shards(self) -> int:
        return len(self.by_shard)

    @property
    def domains(self) -> tuple:
        return self.by_shard[0].domains if self.by_shard else ()

    def __getitem__(self, shard: int) -> DomainFaultStats:
        return self.by_shard[shard]

    @classmethod
    def from_counter_blocks(cls, counters, names, words_by_shard) -> "ShardFaultStats":
        """Build from an (n_shards, n_domains, 8) counter block;
        ``words_by_shard`` is one {domain: words} dict per shard."""
        c = np.asarray(counters)
        assert c.ndim == 3 and c.shape[0] == len(words_by_shard), c.shape
        return cls([FaultStats.from_counter_matrix(c[s], names, words_by_shard[s], shard=s)
                    for s in range(c.shape[0])])

    def reduced(self) -> DomainFaultStats:
        """The cross-shard reduction to one per-domain view."""
        return DomainFaultStats.summed(self.by_shard)

    def total(self) -> FaultStats:
        return self.reduced().total()

    def accumulate(self, other: "ShardFaultStats") -> None:
        """Add ``other`` row by row (aligned by shard index); a row beyond
        this one's shards is adopted as a fresh copy, so its shard tags stay
        as they were."""
        for s, st in enumerate(other.by_shard):
            if s < len(self.by_shard):
                self.by_shard[s].accumulate(st)
            else:
                self.by_shard.append(DomainFaultStats.summed([st]))

    @classmethod
    def summed(cls, stats) -> "ShardFaultStats":
        """Pure cross-run reduction: an iterable of ShardFaultStats summed
        into a fresh one, row-aligned by shard index."""
        out = cls()
        for s in stats:
            out.accumulate(s)
        return out
