"""Prefix caching for the serving engine (port of
``repro/serving/prefix_cache.py``): content hash → decode state.

The paper's fixed-size representation makes prefix caching almost
degenerate: a whole shared prompt prefix (system prompt, few-shot header,
multi-turn history) compresses to one O(k²)-per-layer state, so the cache
is a hash table from token content to a small state tree and a hit is
ONE ``restore_state_rows`` copy into the slot: no block tables, no
paging. :class:`FixedStatePrefixCache` is exactly that, with LRU eviction
under a byte budget.

The softmax baseline needs the machinery the paper lets one delete.
:class:`PagedKVCache` keeps KV rows in fixed-size, content-hashed,
refcounted blocks: a block is pinned while a live slot was admitted from
it, drops into an LRU evictor at refcount 0 (still matchable: a later hit
revives it) and is evicted only under byte pressure. A hit materialises
the matched blocks into one new row-ranged state that the engine copies
into the slot's private cache: copy-on-write resolved at admission, so
the suffix's writes never touch a shared block and the tokens are those
of the dense cache (greedy).

Both caches key entries by the same chained content hash over
chunk-sized token blocks (``chain_digests``, blake2b through
``hashlib``: JAX's hex digests). Boundaries land on multiples of the
engine's ``prefill_chunk``, so a hit leaves the suffix on the chunk grid
a cold admission uses, which is what makes hit admission give the cold
tokens. A match is capped at the largest boundary ≤ len(prompt) − 1: at
least one suffix token is always ingested, so the engine's first-token
sampling runs unchanged on hits.

The port's engine updates its state in place where JAX's arrays are
immutable, so nothing here is shared with a slot: an entry owns the
tensors of the snapshot it was given (the engine clones it), a block
owns a copy of its rows, and a hit's state is copied into the slot,
never handed to it. Entries live on the device of the snapshots inserted.

Persistence rides the atomic checkpoint writer in JAX's format:
``save``/``load`` round-trip the cache through a
:class:`~repro_torch.checkpoint.CheckpointManager` (tree keys ``e{i}`` or
``b{i}``, the entry list in ``extra``), so either package loads the
other's cache; a missing or corrupt file leaves the cache empty (cold),
never wrong.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.attention import AttnState
from repro_torch.tree import leaves

__all__ = [
    "FixedStatePrefixCache",
    "PagedKVCache",
    "PrefixCache",
    "PrefixHit",
    "chain_digests",
    "tree_nbytes",
]


def chain_digests(prompt, chunk: int) -> List[Tuple[int, str]]:
    """Chained blake2b content digests of ``prompt`` at every full
    ``chunk`` boundary: ``d_j = H(d_{j-1} ‖ tokens[j·c:(j+1)·c])`` over
    the int32 bytes. Chaining makes each digest cover the whole prefix up
    to its boundary, so two prompts share a boundary's digest exactly
    when their prefixes match token for token. Returns
    ``[(boundary, hex digest), ...]`` for boundaries c, 2c, …"""
    arr = np.asarray(prompt, np.int32).reshape(-1)
    out: List[Tuple[int, str]] = []
    h = b""
    for i in range(chunk, len(arr) + 1, chunk):
        h = hashlib.blake2b(h + arr[i - chunk:i].tobytes(),
                            digest_size=16).digest()
        out.append((i, h.hex()))
    return out


def tree_nbytes(tree: Any) -> int:
    """Total bytes of every array leaf of a state tree (None skipped)."""
    return sum(int(x.nbytes) for x in leaves(tree) if hasattr(x, "dtype"))


@dataclasses.dataclass
class PrefixHit:
    """A longest-cached-prefix match: ``state`` is a batch-1 (possibly
    row-ranged) decode-state snapshot of the first ``n_tokens`` prompt
    tokens; ``keys`` the entries backing it (one state digest, or one
    digest per KV block), which ``release`` unpins when the admitted slot
    is torn down."""
    n_tokens: int
    state: Any
    keys: Tuple[str, ...] = ()


class PrefixCache:
    """Shared surface of both kinds: chained-hash matching, counters, a
    byte budget and checkpoint persistence."""

    name = "base"

    def __init__(self, max_bytes: int, chunk: int):
        if max_bytes <= 0 or chunk < 1:
            raise ValueError(f"max_bytes must be > 0 and chunk >= 1, got "
                             f"{max_bytes}, {chunk}")
        self.max_bytes = int(max_bytes)
        self.chunk = int(chunk)
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.cow_copies = 0

    def counters(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "inserts": self.inserts, "evictions": self.evictions,
                "cow_copies": self.cow_copies,
                "bytes_used": self.bytes_used}

    # -- subclass surface ----------------------------------------------
    @property
    def bytes_used(self) -> int:
        raise NotImplementedError

    def match(self, prompt) -> Optional[PrefixHit]:
        raise NotImplementedError

    def wants(self, prompt, n_tokens: int) -> bool:
        """Would ``insert(prompt, n_tokens, …)`` store anything new? The
        engine asks before it pays for a snapshot."""
        raise NotImplementedError

    def insert(self, prompt, n_tokens: int, snapshot: Any) -> None:
        raise NotImplementedError

    def release(self, hit: PrefixHit) -> None:
        """Drop the pins a hit took (no-op unless refcounted)."""

    def prefix_nbytes(self, prompt, n_tokens: int) -> int:
        """Bytes this cache holds for the prefix ``prompt[:n_tokens]``:
        flat in ``n_tokens`` for fixed-size states, ∝ ``n_tokens`` for KV
        blocks."""
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def save(self, manager, step: int) -> None:
        raise NotImplementedError

    def load(self, manager, template_fn: Callable[[int], Any]) -> bool:
        """Restore from ``manager`` (newest retained step). False, with
        the cache left empty, when nothing restorable exists; a corrupt
        newest step falls back as engine checkpoints do.
        ``template_fn(n_tokens)`` gives a tree of an ``n_tokens``-row
        snapshot whose leaves name the device and dtype to load onto."""
        raise NotImplementedError


def _restore(manager, like_fn) -> Optional[Tuple[Any, Dict]]:
    try:
        tree, extra, _ = manager.restore_with(like_fn)
    except (FileNotFoundError, ValueError):
        return None
    return tree, extra


class FixedStatePrefixCache(PrefixCache):
    """digest → fixed-size state: one entry is O(k²) per layer whatever
    the prefix length it encodes, so the byte budget holds the same
    number of entries however long the shared prefixes grow, and a hit
    costs one slot copy. A hit's state is copied into the slot, never
    aliased, so entries need no refcounts: eviction is plain LRU."""

    name = "fixed_state"

    def __init__(self, max_bytes: int, chunk: int):
        super().__init__(max_bytes, chunk)
        # digest → {"n_tokens", "state", "nbytes"}; the order is the LRU
        # order (oldest first)
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()
        self._bytes = 0

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt) -> Optional[PrefixHit]:
        limit = len(np.asarray(prompt).reshape(-1)) - 1
        for n, digest in reversed(chain_digests(prompt, self.chunk)):
            if n > limit:
                continue
            ent = self._entries.get(digest)
            if ent is not None:
                self._entries.move_to_end(digest)
                self.hits += 1
                return PrefixHit(n_tokens=n, state=ent["state"],
                                 keys=(digest,))
        self.misses += 1
        return None

    def _digest_at(self, prompt, n_tokens: int) -> str:
        for n, digest in chain_digests(prompt, self.chunk):
            if n == n_tokens:
                return digest
        raise ValueError(
            f"n_tokens {n_tokens} is not a chunk ({self.chunk}) boundary "
            f"of a {len(np.asarray(prompt).reshape(-1))}-token prompt")

    def wants(self, prompt, n_tokens: int) -> bool:
        if n_tokens % self.chunk != 0:
            return False
        return self._digest_at(prompt, n_tokens) not in self._entries

    def insert(self, prompt, n_tokens: int, snapshot: Any) -> None:
        digest = self._digest_at(prompt, n_tokens)
        if digest in self._entries:
            self._entries.move_to_end(digest)
            return
        nbytes = tree_nbytes(snapshot)
        self._entries[digest] = {"n_tokens": int(n_tokens),
                                 "state": snapshot, "nbytes": nbytes}
        self._bytes += nbytes
        self.inserts += 1
        while self._bytes > self.max_bytes and self._entries:
            _, ev = self._entries.popitem(last=False)
            self._bytes -= ev["nbytes"]
            self.evictions += 1

    def prefix_nbytes(self, prompt, n_tokens: int) -> int:
        ent = self._entries.get(self._digest_at(prompt, n_tokens))
        return 0 if ent is None else ent["nbytes"]

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0

    def save(self, manager, step: int) -> None:
        tree = {f"e{i}": ent["state"]
                for i, ent in enumerate(self._entries.values())}
        extra = {"kind": self.name, "chunk": self.chunk,
                 "entries": [{"key": k, "n_tokens": ent["n_tokens"],
                              "nbytes": ent["nbytes"]}
                             for k, ent in self._entries.items()]}
        manager.save(step, tree, extra, blocking=True)

    def load(self, manager, template_fn) -> bool:
        got = _restore(manager, lambda extra: {
            f"e{i}": template_fn(ent["n_tokens"])
            for i, ent in enumerate(extra["entries"])})
        self.clear()
        if got is None:
            return False
        tree, extra = got
        for i, ent in enumerate(extra["entries"]):
            self._entries[ent["key"]] = {
                "n_tokens": int(ent["n_tokens"]), "state": tree[f"e{i}"],
                "nbytes": int(ent["nbytes"])}
            self._bytes += int(ent["nbytes"])
        return True


@dataclasses.dataclass
class _Block:
    """One fixed-size KV block: rows [depth·c, (depth+1)·c) of every KV
    leaf, plus the whole non-KV leaves at its boundary (the chained digest
    covers the whole prefix, so a hybrid stack's recurrent residue is
    content-correct per block; a pure-softmax stack has none).
    ``refcount`` counts live slots admitted from the block; at 0 it sits
    in the LRU evictor, still matchable, until byte pressure evicts it."""
    payload: Any
    nbytes: int
    depth: int
    refcount: int = 0


def _map_states(fn, *trees):
    """``fn`` over the per-block states of trees of one structure (dicts
    and sequences of state NamedTuples; JAX's ``tree.map`` with AttnState
    as a leaf). Every state NamedTuple is passed whole."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map_states(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)) and not hasattr(t, "_fields"):
        return type(t)(_map_states(fn, *(x[i] for x in trees))
                       for i in range(len(t)))
    return fn(*trees)


def _is_kv(st: Any) -> bool:
    return isinstance(st, AttnState) and st.k_cache is not None


def _block_payload(snapshot: Any, lo: int, hi: int) -> Any:
    """A copy of rows [lo, hi) of every KV leaf (the time axis is
    ndim − 3); every other leaf passes whole."""
    def cut(st):
        if not _is_kv(st):
            return st
        t = st.k_cache.ndim - 3
        return st._replace(
            k_cache=st.k_cache.narrow(t, lo, hi - lo).clone(),
            v_cache=st.v_cache.narrow(t, lo, hi - lo).clone())
    return _map_states(cut, snapshot)


def _materialize(payloads: List[Any]) -> Any:
    """A run of block payloads as one new row-ranged snapshot: KV leaves
    concatenated along the time axis; non-KV leaves (stored per boundary)
    from the last block."""
    def merge(*sts):
        if _is_kv(sts[0]):
            t = sts[0].k_cache.ndim - 3
            return sts[-1]._replace(
                k_cache=torch.cat([s.k_cache for s in sts], dim=t),
                v_cache=torch.cat([s.v_cache for s in sts], dim=t))
        return sts[-1]
    return _map_states(merge, *payloads)


class PagedKVCache(PrefixCache):
    """Content-hashed, refcounted, fixed-size KV blocks for the softmax
    baseline: the block-table machinery a growing representation forces.
    A prefix of n tokens costs n/c blocks of O(c·k) bytes each (∝ n,
    against the linear family's flat O(k²) entry); a match walks the
    chained digests block by block and stops at the first gap, so a
    partial eviction truncates matches instead of corrupting them.

    Copy-on-write: a shared block is never written. A hit copies the
    matched run into one new state (``cow_copies`` counts the blocks
    copied) that the engine copies into the slot's private cache."""

    name = "paged_kv"

    def __init__(self, max_bytes: int, chunk: int):
        super().__init__(max_bytes, chunk)
        self._blocks: Dict[str, _Block] = {}
        # refcount-0 blocks, oldest released first (the evictor)
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._bytes = 0

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._blocks)

    def refcount(self, digest: str) -> int:
        return self._blocks[digest].refcount

    def match(self, prompt) -> Optional[PrefixHit]:
        limit = len(np.asarray(prompt).reshape(-1)) - 1
        run: List[str] = []
        for n, digest in chain_digests(prompt, self.chunk):
            if n > limit or digest not in self._blocks:
                break
            run.append(digest)
        if not run:
            self.misses += 1
            return None
        for digest in run:
            self._blocks[digest].refcount += 1
            self._lru.pop(digest, None)
        state = _materialize([self._blocks[d].payload for d in run])
        self.hits += 1
        self.cow_copies += len(run)
        return PrefixHit(n_tokens=len(run) * self.chunk, state=state,
                         keys=tuple(run))

    def release(self, hit: PrefixHit) -> None:
        for digest in hit.keys:
            blk = self._blocks.get(digest)
            if blk is None:
                continue
            blk.refcount -= 1
            if blk.refcount < 0:
                raise RuntimeError(f"block {digest} released more often "
                                   f"than matched")
            if blk.refcount == 0:
                self._lru[digest] = None
                self._lru.move_to_end(digest)

    def wants(self, prompt, n_tokens: int) -> bool:
        if n_tokens % self.chunk != 0 or n_tokens == 0:
            return False
        digests = chain_digests(prompt, self.chunk)
        return digests[n_tokens // self.chunk - 1][1] not in self._blocks

    @staticmethod
    def _has_residue(snapshot: Any) -> bool:
        """Any non-KV content (a hybrid stack's recurrent states)? Residue
        is only content-correct at the snapshot's own boundary, so it
        restricts an insert to the last block."""
        found: List[bool] = []

        def probe(st):
            if isinstance(st, AttnState) and st.k_cache is not None:
                if st.s is not None or st.z is not None:
                    found.append(True)
            elif isinstance(st, AttnState) or leaves(st):
                found.append(True)
            return st

        _map_states(probe, snapshot)
        return bool(found)

    def insert(self, prompt, n_tokens: int, snapshot: Any) -> None:
        if n_tokens % self.chunk != 0:
            raise ValueError(f"n_tokens {n_tokens} is not a multiple of the "
                             f"block size {self.chunk}")
        last_only = self._has_residue(snapshot)
        for j, (n, digest) in enumerate(chain_digests(prompt, self.chunk)):
            if n > n_tokens:
                break
            if digest in self._blocks:
                continue
            if last_only and n != n_tokens:
                continue   # residue is only correct at the last block
            payload = _block_payload(snapshot, n - self.chunk, n)
            nbytes = tree_nbytes(payload)
            self._blocks[digest] = _Block(payload=payload, nbytes=nbytes,
                                          depth=j)
            self._lru[digest] = None
            self._lru.move_to_end(digest)
            self._bytes += nbytes
            self.inserts += 1
        # byte pressure: evict refcount-0 blocks oldest first. Pinned
        # blocks (live slots) are never evicted, so usage may pass the
        # budget while every block is held.
        while self._bytes > self.max_bytes and self._lru:
            digest, _ = self._lru.popitem(last=False)
            self._bytes -= self._blocks.pop(digest).nbytes
            self.evictions += 1

    def prefix_nbytes(self, prompt, n_tokens: int) -> int:
        total = 0
        for n, digest in chain_digests(prompt, self.chunk):
            if n > n_tokens:
                break
            blk = self._blocks.get(digest)
            if blk is None:
                return 0            # a gap: the prefix is not resident
            total += blk.nbytes
        return total

    def clear(self) -> None:
        self._blocks.clear()
        self._lru.clear()
        self._bytes = 0

    def save(self, manager, step: int) -> None:
        keys = list(self._blocks)
        tree = {f"b{i}": self._blocks[k].payload
                for i, k in enumerate(keys)}
        extra = {"kind": self.name, "chunk": self.chunk,
                 "blocks": [{"key": k, "depth": self._blocks[k].depth,
                             "nbytes": self._blocks[k].nbytes}
                            for k in keys]}
        manager.save(step, tree, extra, blocking=True)

    def load(self, manager, template_fn) -> bool:
        def like_fn(extra):
            tpl = template_fn(extra["chunk"])
            return {f"b{i}": tpl for i in range(len(extra["blocks"]))}

        got = _restore(manager, like_fn)
        self.clear()
        if got is None:
            return False
        tree, extra = got
        for i, meta in enumerate(extra["blocks"]):
            self._blocks[meta["key"]] = _Block(
                payload=tree[f"b{i}"], nbytes=int(meta["nbytes"]),
                depth=int(meta["depth"]))
            self._lru[meta["key"]] = None
            self._bytes += int(meta["nbytes"])
        return True
