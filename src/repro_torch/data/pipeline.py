"""Deterministic synthetic LM data pipeline.

Batches are a pure function of (seed, step): any worker can reproduce any
step's batch with no shared state, so a trainer restored from a checkpoint
consumes the exact same stream. Per-host sharding slices the global batch
by host id. The batches are numpy arrays drawn with numpy's Philox, the
same bits as the reference's pipeline.

The token stream is a noisy affine-recurrence language (x_{t+1} = a*x_t + b
mod V with structured noise), so small models show a clearly decreasing loss.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    noise: float = 0.1
    n_codebooks: int = 0  # musicgen-style multi-stream tokens
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=(self.cfg.seed ^ (0xDA7A << 40), (step << 16) | self.cfg.host_id))
        )

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for ``step`` (host-local slice): int32
        "tokens" and "labels" of (B, S), or (B, K, S) with codebooks."""
        c = self.cfg
        rng = self._rng(step)
        shape = (
            (self.local_batch, c.n_codebooks, c.seq_len + 1)
            if c.n_codebooks
            else (self.local_batch, c.seq_len + 1)
        )
        v = max(c.vocab - 1, 2)
        x = np.empty(shape, np.int64)
        x[..., 0] = rng.integers(0, v, size=shape[:-1])
        a, b = 5, 7
        noise = rng.random(shape) < c.noise
        jumps = rng.integers(0, v, size=shape)
        for t in range(1, shape[-1]):
            nxt = (a * x[..., t - 1] + b) % v
            x[..., t] = np.where(noise[..., t], jumps[..., t], nxt)
        tokens = x[..., :-1].astype(np.int32)
        labels = x[..., 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
