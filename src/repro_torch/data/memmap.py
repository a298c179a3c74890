"""Binary token-file dataset (np.memmap), the production input format
(the port's own copy of ``repro/data/memmap.py``, numpy only: the same
file, seed and shard give the JAX package's batches bit for bit).

File layout: a flat little-endian int32 token stream (MaxText/nanoGPT
style). The dataset cuts it into ``seq_len+1`` windows, shuffles window
order deterministically per epoch, shards windows across hosts, and
exposes ``state()``/``restore()`` so the training loop can checkpoint the
exact read position.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import numpy as np


def write_token_file(path: str, tokens: np.ndarray) -> None:
    tokens.astype(np.int32).tofile(path + ".tmp")
    os.replace(path + ".tmp", path)


class TokenFileDataset:
    def __init__(self, path: str, seq_len: int, global_batch: int,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        assert global_batch % num_shards == 0
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.n_windows = len(self.tokens) // (seq_len + 1)
        if self.n_windows < self.local_batch:
            raise ValueError(
                f"token file too small: {self.n_windows} windows "
                f"< local batch {self.local_batch}")
        self._epoch = 0
        self._cursor = 0      # window index within this shard's permutation
        self._perm = self._make_perm(0)

    # -- determinism / checkpointing ---------------------------------------

    def _make_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 9_176_723 + epoch)
        perm = rng.permutation(self.n_windows)
        return perm[self.shard::self.num_shards]

    def state(self) -> Tuple[int, int]:
        return (self._epoch, self._cursor)

    def restore(self, state: Tuple[int, int]) -> None:
        self._epoch, self._cursor = int(state[0]), int(state[1])
        self._perm = self._make_perm(self._epoch)

    # -- iteration -----------------------------------------------------------

    def next_batch(self) -> Dict[str, np.ndarray]:
        b, t = self.local_batch, self.seq_len
        idx = np.empty(b, np.int64)
        for i in range(b):
            if self._cursor >= len(self._perm):
                self._epoch += 1
                self._cursor = 0
                self._perm = self._make_perm(self._epoch)
            idx[i] = self._perm[self._cursor]
            self._cursor += 1
        rows = np.stack([
            self.tokens[j * (t + 1):(j + 1) * (t + 1)] for j in idx])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
