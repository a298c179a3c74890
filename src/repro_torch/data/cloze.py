"""Synthetic CNN-style cloze QA task, the paper's §5 data (the port's
own copy of ``repro/data/cloze.py``, numpy only: the same task seed and
step give the JAX package's batches bit for bit).

The paper evaluates on the CNN dataset of Hermann et al. (2015):
entity-anonymised news articles with Cloze questions. That corpus cannot
ship inside this container, so we generate a synthetic task with the same
*structure* and the same property that makes attention matter:

* a document is a sequence of FACTS  "e_i  rel_j  e_k ." over anonymised
  entity tokens @entityN (entity ids are shuffled per document, exactly
  like the original dataset's anonymisation, so models cannot memorise
  entities — they must read the document);
* a query repeats one fact with the object replaced by a @placeholder;
* the answer is the replaced entity.

A no-attention model must carry every fact through the fixed final GRU
state; attention models can look facts up — which reproduces the paper's
Figure-1 ordering (softmax > gated linear > linear > none).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


class ClozeBatch(NamedTuple):
    doc: np.ndarray       # (B, n) int32
    query: np.ndarray     # (B, m) int32
    answer: np.ndarray    # (B,) int32 — entity id in [0, n_entities)


@dataclasses.dataclass
class ClozeTask:
    """Token map: [0] pad, [1] placeholder, [2] period,
    [3, 3+E) entities, [3+E, 3+E+R) relation words."""
    n_entities: int = 50
    n_relations: int = 40
    n_facts: int = 30          # facts per document
    seed: int = 0

    @property
    def vocab_size(self) -> int:
        return 3 + self.n_entities + self.n_relations

    @property
    def doc_len(self) -> int:
        return self.n_facts * 4

    @property
    def query_len(self) -> int:
        return 4

    def entity_token(self, e: int) -> int:
        return 3 + e

    def batch(self, batch_size: int, step: int) -> ClozeBatch:
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        b, f = batch_size, self.n_facts
        # subject, relation, object per fact; objects unique per (doc,
        # subject·relation) so the answer is unambiguous: enforce by
        # making (subject, relation) pairs unique within a document.
        sub = np.empty((b, f), np.int64)
        rel = np.empty((b, f), np.int64)
        for i in range(b):
            pairs = rng.choice(self.n_entities * self.n_relations, f,
                               replace=False)
            sub[i] = pairs % self.n_entities
            rel[i] = pairs // self.n_entities
        obj = rng.integers(0, self.n_entities, (b, f))

        doc = np.empty((b, f, 4), np.int64)
        doc[..., 0] = 3 + sub
        doc[..., 1] = 3 + self.n_entities + rel
        doc[..., 2] = 3 + obj
        doc[..., 3] = 2  # period
        doc = doc.reshape(b, -1)

        pick = rng.integers(0, f, b)
        ar = np.arange(b)
        query = np.stack([
            3 + sub[ar, pick],
            3 + self.n_entities + rel[ar, pick],
            np.ones(b, np.int64),          # @placeholder
            np.full(b, 2, np.int64),
        ], axis=1)
        answer = obj[ar, pick]
        return ClozeBatch(doc=doc.astype(np.int32),
                          query=query.astype(np.int32),
                          answer=answer.astype(np.int32))
