"""Fixed-size document representations, the paper's k×k store (port of
``repro/core/state.py``).

``DocumentState`` is a document compressed to C = HᵀH (optionally with a
key-sum normaliser z). States merge (C = C_a + C_b for concatenated or
sharded documents: C is a sum of outer products) and answer a query in
O(k²) whatever the document's length.

``DocumentStore`` maps document ids to states and persists them in the
JAX package's archive format, bit for bit: a store written by one package
loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core.linear_attention import safe_denom
from repro_torch.device import resolve_device

Tensor = torch.Tensor
Device = Optional[Union[str, torch.device]]


def gram(h: Tensor) -> Tensor:
    """Σ_n h_n h_nᵀ over the token axis: (..., n, k) -> (..., k, k)."""
    return torch.einsum("...nk,...nl->...kl", h, h)


@dataclasses.dataclass
class DocumentState:
    """Fixed-size representation of one (batch of) document(s).

    c: (..., k, k) non-centred covariance of hidden states (paper §3.1).
    z: (..., k) optional key-sum normaliser.
    n_tokens: tokens folded into the state (for diagnostics: the
       representation is O(k²) whatever n is).
    """

    c: Tensor
    z: Optional[Tensor]
    n_tokens: int

    @property
    def k(self) -> int:
        return self.c.shape[-1]

    @property
    def nbytes(self) -> int:
        n = self.c.numel() * self.c.element_size()
        if self.z is not None:
            n += self.z.numel() * self.z.element_size()
        return n

    # -- construction ------------------------------------------------------

    @classmethod
    def from_hidden_states(cls, h: Tensor, with_normalizer: bool = False
                           ) -> "DocumentState":
        z = h.sum(dim=-2) if with_normalizer else None
        return cls(c=gram(h), z=z, n_tokens=h.shape[-2])

    @classmethod
    def zeros(cls, k: int, batch_shape=(), dtype=torch.float32,
              with_normalizer: bool = False, *, device: Device = None
              ) -> "DocumentState":
        dev = resolve_device(device)
        c = torch.zeros((*batch_shape, k, k), dtype=dtype, device=dev)
        z = (torch.zeros((*batch_shape, k), dtype=dtype, device=dev)
             if with_normalizer else None)
        return cls(c=c, z=z, n_tokens=0)

    # -- the paper's operations --------------------------------------------

    def update(self, h_t: Tensor) -> "DocumentState":
        """C_{t+1} = C_t + h hᵀ (paper §3.2 streaming update); returns a
        new state, as the JAX method does."""
        c = self.c + torch.einsum("...k,...l->...kl", h_t, h_t)
        z = None if self.z is None else self.z + h_t
        return DocumentState(c=c, z=z, n_tokens=self.n_tokens + 1)

    def lookup(self, q: Tensor, normalize: bool = False,
               eps: float = 1e-6) -> Tensor:
        """R(D, Q) = Cq, O(k²) whatever the document's length.

        q: (..., k) one query or (..., m, k) m queries. ``normalize=True``
        needs the key-sum normaliser z and raises without it.
        """
        if normalize and self.z is None:
            raise ValueError(
                "lookup(normalize=True) on a DocumentState without a "
                "normalizer: encode with with_normalizer=True (z is None)")
        if q.ndim == self.c.ndim - 1:
            out = torch.einsum("...kl,...l->...k", self.c, q)
            if normalize:
                denom = torch.einsum("...k,...k->...", self.z, q)
                out = out / safe_denom(denom, eps)[..., None]
            return out
        out = torch.einsum("...kl,...ml->...mk", self.c, q)
        if normalize:
            denom = torch.einsum("...k,...mk->...m", self.z, q)
            out = out / safe_denom(denom, eps)[..., None]
        return out

    def merge(self, other: "DocumentState") -> "DocumentState":
        """States of document shards sum: C is a sum of outer products."""
        z = None
        if self.z is not None and other.z is not None:
            z = self.z + other.z
        return DocumentState(c=self.c + other.c, z=z,
                             n_tokens=self.n_tokens + other.n_tokens)


class DocumentStore:
    """Document id -> DocumentState, with npz persistence.

    ``batched_lookup`` answers a wave against a cached stacked (N, k, k)
    tensor; ``lookup_dispatches`` counts its calls, one per wave.
    """

    def __init__(self) -> None:
        self._docs: Dict[str, DocumentState] = {}
        self._stack_cache = None   # (id -> row, (N,k,k) C, (N,k) z | None)
        self.lookup_dispatches = 0

    def __len__(self) -> int:
        return len(self._docs)

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._docs

    def add(self, doc_id: str, state: DocumentState) -> None:
        self._docs[doc_id] = state
        self._stack_cache = None

    def get(self, doc_id: str) -> DocumentState:
        return self._docs[doc_id]

    def ids(self) -> Iterable[str]:
        return self._docs.keys()

    def _stacked(self):
        if self._stack_cache is None:
            ids = list(self._docs)
            rows = {d: i for i, d in enumerate(ids)}
            cs = torch.stack([self._docs[d].c for d in ids])
            zs = (torch.stack([self._docs[d].z for d in ids])
                  if all(self._docs[d].z is not None for d in ids)
                  else None)
            self._stack_cache = (rows, cs, zs)
        return self._stack_cache

    def batched_lookup(self, doc_ids, queries: Tensor,
                       normalize: bool = False) -> Tensor:
        """Answer queries[i] against doc_ids[i]: gather, contract and
        (optionally) normalise.

        ``queries``: (B, k), one query per document, or (B, m, k).
        ``normalize=True`` needs every stored state to carry z.
        """
        rows, cs, zs = self._stacked()
        if normalize and zs is None:
            raise ValueError(
                "batched_lookup(normalize=True) but not every stored "
                "DocumentState carries a normalizer (z is None); encode "
                "with with_normalizer=True")
        idx = torch.tensor([rows[d] for d in doc_ids], dtype=torch.long,
                           device=cs.device)
        self.lookup_dispatches += 1
        out = torch.einsum("bkl,b...l->b...k", cs[idx], queries)
        if normalize:
            denom = torch.einsum("bk,b...k->b...", zs[idx], queries)
            out = out / safe_denom(denom)[..., None]
        return out

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self._docs.values())

    def save(self, path: str) -> None:
        """Persist atomically, in the JAX package's format: ids in ONE
        indexed string array ``__ids__``, each document's payload under
        row-numbered keys ``c_%06d``, ``n_%06d`` and ``z_%06d``."""
        ids = list(self._docs)
        arrays = {"__ids__": np.asarray(ids)}
        for i, doc_id in enumerate(ids):
            st = self._docs[doc_id]
            arrays[f"c_{i:06d}"] = st.c.detach().cpu().numpy()
            arrays[f"n_{i:06d}"] = np.asarray(st.n_tokens)
            if st.z is not None:
                arrays[f"z_{i:06d}"] = st.z.detach().cpu().numpy()
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, *, device: Device = None) -> "DocumentStore":
        """Load a store written by :meth:`save` (either package's) onto
        ``device`` (CUDA unless the caller asks for another). The archive
        is closed on every exit path; a malformed archive raises
        ``ValueError`` naming the path instead of half-loading."""
        dev = resolve_device(device)
        store = cls()
        with np.load(path, allow_pickle=False) as data:
            if "__ids__" not in data.files:
                raise ValueError(
                    f"{path!r} is not a DocumentStore archive "
                    f"(missing '__ids__' index; members: "
                    f"{sorted(data.files)[:8]})")
            ids = [str(d) for d in data["__ids__"]]
            for i, doc_id in enumerate(ids):
                for member in (f"c_{i:06d}", f"n_{i:06d}"):
                    if member not in data.files:
                        raise ValueError(
                            f"malformed DocumentStore archive {path!r}: "
                            f"doc {doc_id!r} is missing member "
                            f"{member!r}")
                z_key = f"z_{i:06d}"
                store.add(doc_id, DocumentState(
                    c=torch.tensor(data[f"c_{i:06d}"], device=dev),
                    z=(torch.tensor(data[z_key], device=dev)
                       if z_key in data.files else None),
                    n_tokens=int(data[f"n_{i:06d}"])))
        return store
