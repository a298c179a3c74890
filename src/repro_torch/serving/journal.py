"""Write-ahead request journal, durable serving's source of truth (port of
``repro/serving/journal.py``, byte for byte in its format).

Every externally visible engine transition is appended to the journal
BEFORE the engine changes itself:

* ``submit``: the request's whole identity (uid, prompt, budget,
  arrival, priority, deadline, speculate_k, fork), written after
  validation and before any queue change, so a crash right after
  ``submit()`` returns cannot lose the request;
* ``cancel``: the cancellation intent;
* ``ack``: the completion's delivery record (uid, tokens, status). An
  ack in the journal means the result left the engine; a submit without
  one is work the journal owes the caller;
* ``ckpt``: a marker that an engine checkpoint was taken at this
  position.

Together with engine checkpoints (the paper's fixed-size state makes
one S·k² floats per layer) this gives exactly-once delivery: replaying
a journal into a fresh engine under greedy decoding reproduces the
completion set with no lost and no duplicated ack, because greedy tokens
depend only on (params, prompt) and acked uids are never re-delivered.

On disk (append-only, corruption-evident)::

    magic  b"WAJ1"
    record := header | payload
    header := <u32 payload_len> <u32 crc32(payload)>  (little-endian)
    payload := canonical JSON (utf-8, sorted keys, no spaces)

Every append is flushed and ``os.fsync``-ed by default. A crash mid-
append leaves a truncated or checksum-failing tail: readers stop at the
last valid record and report the bytes that follow, and a writer that
reopens the file truncates them before appending, so the journal can
always be extended after a crash. The bytes are the JAX package's, so
either package reads and extends the other's journal.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"WAJ1"
_HEADER = struct.Struct("<II")          # payload_len, crc32(payload)
MAX_RECORD_BYTES = 1 << 26              # 64 MiB: reject absurd lengths

REC_SUBMIT = "submit"
REC_CANCEL = "cancel"
REC_ACK = "ack"
REC_CKPT = "ckpt"


def encode_record(rec: Dict[str, Any]) -> bytes:
    """One length-prefixed, checksummed record (header + JSON payload)."""
    payload = json.dumps(rec, separators=(",", ":"),
                         sort_keys=True).encode("utf-8")
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def scan_records(blob: bytes) -> Tuple[List[Dict[str, Any]], int]:
    """Decode the records of ``blob`` (past the magic): ``(records,
    valid_bytes)``, ``valid_bytes`` the offset of the first truncated or
    corrupt record (``len(blob)`` for a clean journal). A damaged tail
    never raises: it is the crash mid-append that recovery is for."""
    records: List[Dict[str, Any]] = []
    off, n = 0, len(blob)
    while off + _HEADER.size <= n:
        length, crc = _HEADER.unpack_from(blob, off)
        start = off + _HEADER.size
        end = start + length
        if length > MAX_RECORD_BYTES or end > n:
            break                         # truncated tail
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            break                         # corrupt tail
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            break
        records.append(rec)
        off = end
    return records, off


def read_journal(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """A journal file's ``(records, garbage_bytes)``, ``garbage_bytes``
    the trailing bytes past the last valid record (0 for a clean one).
    ``ValueError`` naming the path if the file is not a journal (bad
    magic)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError(f"{path!r} is not a request journal "
                         f"(bad magic {blob[:len(MAGIC)]!r})")
    records, valid = scan_records(blob[len(MAGIC):])
    return records, len(blob) - len(MAGIC) - valid


class Journal:
    """Append-only request journal, file-backed or in memory.

    ``path=None`` keeps the records in memory only (a replica fleet's
    per-replica journals without a durability directory: failover works,
    process death is not survived). With a path the file is created
    (with the magic) or reopened: its valid records are loaded
    (``records()`` serves them to replay) and a torn tail from an earlier
    crash is truncated, so appends continue from the last good record.

    ``fsync=True`` (the default) syncs every append: the write-ahead
    guarantee."""

    def __init__(self, path: Optional[str] = None, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._records: List[Dict[str, Any]] = []
        self._fh = None
        self.recovered_garbage_bytes = 0
        if path is None:
            return
        if os.path.exists(path):
            records, garbage = read_journal(path)
            self._records = records
            self.recovered_garbage_bytes = garbage
            valid_size = os.path.getsize(path) - garbage
            self._fh = open(path, "r+b")
            if garbage:
                self._fh.truncate(valid_size)
            self._fh.seek(0, os.SEEK_END)
        else:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "w+b")
            self._fh.write(MAGIC)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    # -- write side ----------------------------------------------------

    def append(self, rec: Dict[str, Any]) -> int:
        """Append one record; returns its sequence number. A file-backed
        journal flushes (and fsyncs) before returning, so the record is
        durable when the caller goes on."""
        seq = len(self._records)
        self._records.append(rec)
        if self._fh is not None:
            self._fh.write(encode_record(rec))
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        return seq

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read side -----------------------------------------------------

    @property
    def seq(self) -> int:
        """Records appended so far (the next record's sequence number)."""
        return len(self._records)

    def records(self) -> List[Dict[str, Any]]:
        return list(self._records)

    def acked(self) -> Dict[int, Dict[str, Any]]:
        """uid → ack record, for every delivered completion."""
        return {r["uid"]: r for r in self._records if r["t"] == REC_ACK}

    def unacked_submits(self) -> List[Dict[str, Any]]:
        """The submit records still owed an ack, in submission order:
        the work a recovering (or failing-over) engine re-admits."""
        done = {r["uid"] for r in self._records if r["t"] == REC_ACK}
        return [r for r in self._records
                if r["t"] == REC_SUBMIT and r["uid"] not in done]


# ---------------------------------------------------------------------------
# record constructors and converters (the one place field names live)
# ---------------------------------------------------------------------------

def submit_record(uid: int, prompt, max_new_tokens: int, arrival: float,
                  speculate_k: int, priority: int,
                  deadline_s: Optional[float],
                  fork: int = 1) -> Dict[str, Any]:
    return {"t": REC_SUBMIT, "uid": int(uid),
            "prompt": np.asarray(prompt, np.int32).tolist(),
            "max_new_tokens": int(max_new_tokens),
            "arrival": float(arrival), "speculate_k": int(speculate_k),
            "priority": int(priority),
            "deadline_s": (None if deadline_s is None
                           else float(deadline_s)),
            "fork": int(fork)}


def cancel_record(uid: int) -> Dict[str, Any]:
    return {"t": REC_CANCEL, "uid": int(uid)}


def ack_record(completion) -> Dict[str, Any]:
    return {"t": REC_ACK, "uid": int(completion.uid),
            "prompt_len": int(completion.prompt_len),
            "tokens": np.asarray(completion.tokens, np.int32).tolist(),
            "finish_reason": completion.finish_reason,
            "admitted_step": int(completion.admitted_step),
            "finished_step": int(completion.finished_step),
            "status": completion.status,
            "retries": int(completion.retries)}


def ckpt_record(step: int, seq: int) -> Dict[str, Any]:
    return {"t": REC_CKPT, "step": int(step), "seq": int(seq)}


def completion_from_ack(rec: Dict[str, Any]):
    """The :class:`~repro_torch.serving.engine.Completion` of a journaled
    ack (the delivery record a recovered engine serves instead of acking
    again)."""
    from repro_torch.serving.engine import Completion
    return Completion(
        uid=rec["uid"], prompt_len=rec["prompt_len"],
        tokens=np.asarray(rec["tokens"], np.int32),
        finish_reason=rec["finish_reason"],
        admitted_step=rec["admitted_step"],
        finished_step=rec["finished_step"],
        status=rec["status"], retries=rec.get("retries", 0))
