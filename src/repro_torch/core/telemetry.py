"""Fault telemetry: ECC outcomes vs ground truth (paper Fig. 1/2 counters)."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import codes

# Lane order of the counter rows the fused inject+scrub kernel reduces.
COUNTER_FIELDS = (
    "clean", "corrected", "detected", "silent",
    "words_1bit", "words_2bit", "words_multi", "faulty_bits",
)


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
    def from_decode(cls, status: np.ndarray, flip_counts: np.ndarray) -> "FaultStats":
        """Stats from per-word ECC status codes + ground-truth flip counts."""
        status = np.asarray(status).reshape(-1)
        flips = np.asarray(flip_counts).reshape(-1)
        detected = status == codes.STATUS_DETECTED
        return cls(
            words=int(status.size),
            clean=int(((status == codes.STATUS_CLEAN) & (flips == 0)).sum()),
            corrected=int(((status == codes.STATUS_CORRECTED) & (flips == 1)).sum()),
            detected=int(detected.sum()),
            silent=int(((flips >= 2) & ~detected).sum()),
            words_1bit=int((flips == 1).sum()),
            words_2bit=int((flips == 2).sum()),
            words_multi=int((flips >= 3).sum()),
            faulty_bits=int(flips.sum()),
        )


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

    def coverage(self) -> dict:
        return {d: st.coverage() for d, st in self.by_domain.items()}
