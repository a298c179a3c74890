"""Synthetic LM token stream — deterministic, sharded (the port's own
copy of ``repro/data/synthetic.py``, numpy only: ``batch_at`` gives the
JAX package's batches bit for bit).

Every batch is a pure function of (seed, step, shard), so the iterator
"state" is the integer step.

The stream has learnable bigram structure (token t+1 depends on token t)
so short training runs show decreasing loss rather than plateauing at
log(V).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0            # this host's shard index
    num_shards: int = 1
    structured: bool = True   # bigram structure vs uniform noise

    def __post_init__(self):
        assert self.global_batch % self.num_shards == 0
        self.local_batch = self.global_batch // self.num_shards
        rng = np.random.default_rng(self.seed)
        if self.structured:
            # sparse deterministic bigram table: each token has 8 likely
            # successors — enough structure for loss to fall fast.
            self._next = rng.integers(
                0, self.vocab_size, (self.vocab_size, 8), dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a global step — pure function of (seed, step, shard)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, t = self.local_batch, self.seq_len
        if not self.structured:
            toks = rng.integers(0, self.vocab_size, (b, t + 1), np.int32)
        else:
            toks = np.empty((b, t + 1), np.int32)
            toks[:, 0] = rng.integers(0, self.vocab_size, b)
            choices = rng.integers(0, 8, (b, t))
            noise = rng.random((b, t)) < 0.05
            rand = rng.integers(0, self.vocab_size, (b, t), dtype=np.int32)
            for i in range(t):
                nxt = self._next[toks[:, i], choices[:, i]]
                toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iter_from(self, step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1
