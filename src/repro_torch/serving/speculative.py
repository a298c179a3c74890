"""Draft providers for speculative decoding (port of
``repro/serving/speculative.py``).

Speculative decoding splits a greedy step into a draft (cheap, K tokens
proposed) and a verify (the target model scores all K+1 window positions
in one masked ``lm.decode_window_varlen`` pass: one B1/B7 launch per
layer on CUDA tensors). The paper's fixed-size state is what makes the
verify and rewind cheap: undoing a rejected suffix copies one k×k state
per layer back instead of replaying a KV cache.

A draft provider implements the protocol the engine drives:

* ``admit(slot, context)`` — a request enters ``slot``; ``context`` is
  every token known so far, the current input token included (prompt +
  the first sampled token, or + every emitted token on a resume).
* ``propose(tok, pos, mask, k)`` — up to ``k`` continuation tokens per
  slot where ``mask`` is True; ``tok`` / ``pos`` are the engine's
  per-slot input token and its position. Returns (S, k) int32; rows of
  unmasked slots are ignored.
* ``commit(slot, emitted)`` — the verifier emitted these tokens for
  ``slot`` (the last one is its next input token).
* ``release(slot)`` — the slot's request left it (finished, preempted,
  evicted or turned plain).
* ``reset()`` — forget every slot.

Three providers:

* :class:`NgramDraft` — prompt lookup over the request's own history; no
  device work.
* :class:`ModelDraft` — a second LM drafting through its own slot states:
  one masked ``lm.generate_segment`` a round (B1/B7 once per layer and
  step), its commits applied as one masked ``lm.decode_window_varlen``
  at the next ``propose``.
* :class:`ReplayDraft` — replays known continuations (an oracle that pins
  the acceptance rate near 1).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class DraftProvider(Protocol):
    def admit(self, slot: int, context: np.ndarray) -> None: ...

    def propose(self, tok: np.ndarray, pos: np.ndarray,
                mask: np.ndarray, k: int) -> np.ndarray: ...

    def commit(self, slot: int, emitted: np.ndarray) -> None: ...

    def release(self, slot: int) -> None: ...

    def reset(self) -> None: ...


class NgramDraft:
    """Prompt-lookup drafting: propose what followed the most recent
    earlier occurrence of the current suffix n-gram (longest first, down
    to 1), else repeat the last token. Host only; acceptance is high
    where the target's output repeats itself, and a miss costs the round
    its lookahead, never a token."""

    def __init__(self, max_ngram: int = 3):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        self.max_ngram = max_ngram
        self._hist: Dict[int, List[int]] = {}

    def admit(self, slot: int, context: np.ndarray) -> None:
        self._hist[slot] = [int(t) for t in context]

    def _lookup(self, h: List[int], k: int) -> np.ndarray:
        for n in range(min(self.max_ngram, len(h) - 1), 0, -1):
            suffix = h[-n:]
            for i in range(len(h) - n - 1, -1, -1):   # most recent first
                if h[i:i + n] == suffix:
                    cont = h[i + n:i + n + k]
                    if cont:
                        pad = [cont[-1]] * (k - len(cont))
                        return np.asarray(cont + pad, np.int32)
        return np.full((k,), h[-1], np.int32)

    def propose(self, tok: np.ndarray, pos: np.ndarray,
                mask: np.ndarray, k: int) -> np.ndarray:
        out = np.zeros((len(tok), k), np.int32)
        for s in np.nonzero(mask)[0]:
            out[s] = self._lookup(self._hist[int(s)], k)
        return out

    def commit(self, slot: int, emitted: np.ndarray) -> None:
        self._hist[slot].extend(int(t) for t in emitted)

    def release(self, slot: int) -> None:
        self._hist.pop(slot, None)

    def reset(self) -> None:
        self._hist.clear()


class ReplayDraft:
    """Oracle drafting from known continuations, keyed by prompt:
    ``continuations[ReplayDraft.key(prompt)]`` is the request's whole
    greedy output (its first element the first sampled token). A desync
    only makes drafts wrong, never tokens: the verifier owns them."""

    @staticmethod
    def key(prompt: np.ndarray) -> bytes:
        return np.asarray(prompt, np.int32).tobytes()

    def __init__(self, continuations: Dict[bytes, np.ndarray]):
        self._seqs = {k: np.asarray(v, np.int32).reshape(-1)
                      for k, v in continuations.items()}
        self._slot_seq: Dict[int, np.ndarray] = {}
        self._cursor: Dict[int, int] = {}

    def admit(self, slot: int, context: np.ndarray) -> None:
        # context = prompt + [first sampled token]
        seq = self._seqs.get(self.key(context[:-1]))
        self._slot_seq[slot] = (seq if seq is not None
                                else np.zeros((0,), np.int32))
        self._cursor[slot] = 1        # seq[0] is the known first token

    def propose(self, tok: np.ndarray, pos: np.ndarray,
                mask: np.ndarray, k: int) -> np.ndarray:
        out = np.zeros((len(tok), k), np.int32)
        for s in np.nonzero(mask)[0]:
            s = int(s)
            seq, c = self._slot_seq[s], self._cursor[s]
            cont = seq[c:c + k]
            out[s, :len(cont)] = cont
        return out

    def commit(self, slot: int, emitted: np.ndarray) -> None:
        self._cursor[slot] += len(emitted)

    def release(self, slot: int) -> None:
        self._slot_seq.pop(slot, None)
        self._cursor.pop(slot, None)

    def reset(self) -> None:
        self._slot_seq.clear()
        self._cursor.clear()


class ModelDraft:
    """A second LM drafting through its own slot states (the two-model
    setup), with the target engine's slot discipline: one whole-stack
    state of ``n_slots`` rows, admission = prefill + slot write.

    A round drafts with ONE masked ``lm.generate_segment`` of K steps
    over every speculative slot. Its windows update the state in place,
    so ``propose`` first copies each drafting slot's fixed-size state
    (``snapshot_state_rows`` with no KV rows: a softmax draft's cache
    rows at or past the round's start are rewritten before they are
    read). After the verify, a full acceptor's trajectory already
    consumed the accepted tokens but the last; a partial acceptor gets
    its round-start copy back and must re-advance its accepted prefix.
    Both kinds are buffered, and ALL of a round's commits are applied in
    ONE masked ``lm.decode_window_varlen`` at the next ``propose`` (JAX
    applies its full acceptors so and rewinds each partial acceptor with
    a batch-1 window of its own). ``dispatches`` counts the model
    passes: ``prefills``, drafting ``steps`` and the ``flushes`` of
    buffered commits."""

    def __init__(self, params: Any, cfg: Any, *, n_slots: int = 4,
                 max_len: int = 512, backend: Any = None):
        from repro_torch.serving.backends import backend_for_config

        self.params = params
        self.cfg = cfg
        self.backend = (backend if backend is not None
                        else backend_for_config(cfg))
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.reset()

    def reset(self) -> None:
        self.state = self.backend.init_slots(self.n_slots, self.max_len,
                                             device=self.device)
        self._pos = np.zeros((self.n_slots,), np.int32)
        self._round_tok: Optional[np.ndarray] = None
        self._round_pos: Optional[np.ndarray] = None
        self._round_k = 0
        self._pre: Dict[int, Any] = {}
        # commits applied at the next propose: slot -> (tokens, start)
        self._pending: Dict[int, tuple] = {}
        self.dispatches = {"prefills": 0, "steps": 0, "flushes": 0}

    def admit(self, slot: int, context: np.ndarray) -> None:
        # the draft consumes everything BEFORE the current input token
        # (context[-1]), which the next propose feeds
        prompt = np.asarray(context[:-1], np.int64)
        _, st = self.backend.prefill(
            self.params, torch.from_numpy(prompt)[None].to(self.device))
        self.backend.write_slot_state(self.state, st, slot)
        self.dispatches["prefills"] += 1
        self._pending.pop(slot, None)
        self._pos[slot] = len(prompt)

    def propose(self, tok: np.ndarray, pos: np.ndarray,
                mask: np.ndarray, k: int) -> np.ndarray:
        self._flush_pending()
        be, dev = self.backend, self.device
        self._pre = {int(s): be.snapshot_state_rows(self.state, int(s), 0)
                     for s in np.nonzero(mask)[0]}
        self._round_tok = np.asarray(tok, np.int64).copy()
        self._round_pos = self._pos.copy()
        self._round_k = k
        toks, _ = be.generate_segment(
            self.params, self.state,
            torch.from_numpy(self._round_tok).to(dev),
            torch.from_numpy(self._pos).to(dev),
            torch.from_numpy(np.asarray(mask, bool)).to(dev),
            torch.full((self.n_slots,), k + 1, dtype=torch.int32,
                       device=dev), k)
        self.dispatches["steps"] += k
        return toks.cpu().numpy().astype(np.int32)

    def _flush_pending(self) -> None:
        """Apply every buffered commit as ONE masked varlen window."""
        if not self._pending:
            return
        width = max(len(t) for t, _ in self._pending.values())
        tokens = np.zeros((self.n_slots, width), np.int64)
        lens = np.zeros((self.n_slots,), np.int32)
        pos0 = np.zeros((self.n_slots,), np.int32)
        for slot, (t, p) in self._pending.items():
            tokens[slot, :len(t)] = t
            lens[slot] = len(t)
            pos0[slot] = p
        self._pending.clear()
        dev = self.device
        self.backend.decode_window_varlen(
            self.params, self.state, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos0).to(dev), torch.from_numpy(lens).to(dev),
            last_only=True)
        self.dispatches["flushes"] += 1

    def commit(self, slot: int, emitted: np.ndarray) -> None:
        # the verifier accepted [tok0, g1..g_a]; the drafting trajectory
        # consumed [tok0, d1..d_{k-1}], which diverges from it past the
        # accepted prefix
        window = np.concatenate([[self._round_tok[slot]],
                                 np.asarray(emitted[:-1], np.int64)])
        start = int(self._round_pos[slot])
        if len(window) == self._round_k + 1:
            # full acceptance: only the trailing token is unconsumed
            self._pending[slot] = (window[-1:], start + self._round_k)
        else:
            # partial: back to the round start, re-advance the prefix
            self.backend.restore_state_rows(self.state, self._pre[slot],
                                            slot)
            self._pending[slot] = (window, start)
        self._pos[slot] = start + len(window)

    def release(self, slot: int) -> None:
        # the slot's state is overwritten at the next admit
        self._pending.pop(slot, None)
        self._pre.pop(slot, None)
