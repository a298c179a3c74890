"""The port's write-ahead request journal against the JAX package's:

* the same record sequence gives byte-identical files from both
  packages, and so does the same engine run (``fleet_demo_config``'s
  linear smoke config, converted weights, fp32): every submit, cancel
  and ack record equal;
* a journal that either package wrote, with a CRC-corrupted record and
  a torn tail, reads in the other the way the writer's own package reads
  it, and the other extends it;
* JAX's ``tests/test_journal.py`` within torch: the format, corruption,
  the record semantics, write-ahead ordering and one ack per uid across
  replay;
* ``serve --mode stream``'s durability: ``--crash-at-event`` exits 3 and
  ``--recover`` completes every request, acked once (subprocesses pinned
  to two threads); a SIGTERM drain, driven in process from inside a
  step, checkpoints, puts the previous handlers back, and ``--recover``
  finishes the stream with the undrained run's tokens.
"""

import os
import signal
import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import Journal as JaxJournal
from repro.serving import fleet_demo_config as jax_fleet_config
from repro.serving import read_journal as jax_read_journal
from repro.serving.engine import Completion as JaxCompletion
from repro.serving.journal import ack_record as jax_ack_record
from repro.serving.journal import cancel_record as jax_cancel_record
from repro.serving.journal import ckpt_record as jax_ckpt_record
from repro.serving.journal import submit_record as jax_submit_record
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.serving import (Completion, DecodeEngine, Journal,
                                 fleet_demo_config, read_journal)
from repro_torch.serving.journal import (MAGIC, REC_ACK, REC_CANCEL,
                                         REC_SUBMIT, ack_record,
                                         cancel_record, ckpt_record,
                                         completion_from_ack, encode_record,
                                         scan_records, submit_record)

ROOT = Path(__file__).resolve().parents[1]
ENGINE_KW = dict(n_slots=2, segment_len=4, max_len=64)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _submit(uid, make=submit_record, **kw):
    base = dict(uid=uid, prompt=[1, 2, 3], max_new_tokens=4, arrival=0.0,
                speculate_k=0, priority=0, deadline_s=None)
    base.update(kw)
    return make(**base)


def _completion(uid, cls=Completion, tokens=(5, 6), status="ok"):
    return cls(uid=uid, prompt_len=3, tokens=np.asarray(tokens, np.int32),
               finish_reason="length" if status == "ok" else status,
               admitted_step=1, finished_step=3, status=status, retries=0)


def _records(submit, cancel, ack, ckpt, completion_cls):
    """One sequence of every record kind, built by one package."""
    return [submit(**dict(uid=0, prompt=[1, 2, 3], max_new_tokens=4,
                          arrival=0.0, speculate_k=0, priority=0,
                          deadline_s=None)),
            submit(**dict(uid=1, prompt=np.arange(7, dtype=np.int64),
                          max_new_tokens=9, arrival=2.75, speculate_k=3,
                          priority=-2, deadline_s=40.5, fork=3)),
            cancel(0),
            ack(_completion(0, completion_cls, (), "cancelled")),
            ckpt(8, 4),
            ack(_completion(1, completion_cls, (4, 255, 0)))]


PORT_RECORDS = (submit_record, cancel_record, ack_record, ckpt_record,
                Completion)
JAX_RECORDS = (jax_submit_record, jax_cancel_record, jax_ack_record,
               jax_ckpt_record, JaxCompletion)


def _write(journal_cls, path, records):
    with journal_cls(str(path)) as j:
        for r in records:
            j.append(r)


# ---------------------------------------------------------------------------
# both packages, byte for byte
# ---------------------------------------------------------------------------

class TestJournalBytes:
    def test_the_same_records_give_the_same_file(self, tmp_path):
        port, jax_ = _records(*PORT_RECORDS), _records(*JAX_RECORDS)
        assert port == jax_
        _write(Journal, tmp_path / "port.journal", port)
        _write(JaxJournal, tmp_path / "jax.journal", jax_)
        a = (tmp_path / "port.journal").read_bytes()
        assert a == (tmp_path / "jax.journal").read_bytes()
        assert a.startswith(MAGIC)
        assert b"".join(map(encode_record, port)) == a[len(MAGIC):]

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_damaged_journal_reads_and_extends_across(self, tmp_path,
                                                      writer):
        """A CRC-corrupted record and a torn tail, written by one package:
        the other reads what the writer's package reads, truncates the
        tail on reopen and extends the file, which both then read
        alike."""
        own_cls, own_read = ((JaxJournal, jax_read_journal)
                             if writer == "jax" else (Journal, read_journal))
        other_cls, other_read = ((Journal, read_journal) if writer == "jax"
                                 else (JaxJournal, jax_read_journal))
        recs = _records(*PORT_RECORDS)
        p = tmp_path / "j.journal"
        _write(own_cls, p, recs[:3])
        size3 = p.stat().st_size
        _write(own_cls, p, recs[3:5])
        blob = bytearray(p.read_bytes())
        blob[size3 + 10] ^= 0xFF              # inside record 4's payload
        blob += encode_record(recs[5])[:-7]   # a torn append
        p.write_bytes(bytes(blob))
        want = own_read(str(p))
        assert want[0] == recs[:3] and want[1] == len(blob) - size3
        assert other_read(str(p)) == want
        j = other_cls(str(p))
        assert j.recovered_garbage_bytes == want[1]
        assert j.records() == recs[:3] and j.seq == 3
        j.append(recs[5])
        j.close()
        assert p.stat().st_size == size3 + len(encode_record(recs[5]))
        assert own_read(str(p)) == other_read(str(p)) == (
            recs[:3] + [recs[5]], 0)

    def test_an_engine_run_journals_jax_bytes(self, tmp_path):
        """The same submissions on JAX's engine and the port's (converted
        weights, greedy): byte-identical journals, submit for submit and
        ack for ack."""
        jcfg, tcfg = jax_fleet_config("linear"), fleet_demo_config("linear")
        pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg,
                                     device=torch.device("cpu"))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
                   for n in (8, 5, 11, 8)]
        paths = {}
        for name, cls, params, cfg in (("jax", JaxEngine, pj, jcfg),
                                       ("port", DecodeEngine, pt, tcfg)):
            paths[name] = tmp_path / f"{name}.journal"
            eng = cls(params, cfg, journal=str(paths[name]), **ENGINE_KW)
            for i, p in enumerate(prompts):
                eng.submit(p, (6, 1, 9, 3)[i], arrival=float(i),
                           priority=i % 2, fork=2 if i == 2 else 1)
            eng.cancel(3)
            eng.run()
            eng.journal.close()
        recs, garbage = read_journal(str(paths["port"]))
        assert garbage == 0
        assert [r["t"] for r in recs].count(REC_ACK) == 5
        assert paths["port"].read_bytes() == paths["jax"].read_bytes()


# ---------------------------------------------------------------------------
# JAX's tests/test_journal.py, within torch
# ---------------------------------------------------------------------------

class TestFormat:
    def test_roundtrip_file(self, tmp_path):
        p = str(tmp_path / "j.journal")
        with Journal(p) as j:
            j.append(_submit(0))
            j.append(cancel_record(0))
        recs, garbage = read_journal(p)
        assert garbage == 0
        assert [r["t"] for r in recs] == [REC_SUBMIT, REC_CANCEL]
        assert recs[0]["uid"] == 0 and recs[0]["prompt"] == [1, 2, 3]

    def test_seq_monotonic(self, tmp_path):
        j = Journal(str(tmp_path / "j.journal"))
        assert j.append(_submit(0)) == 0
        assert j.append(_submit(1)) == 1
        assert j.seq == 2
        j.close()

    def test_bad_magic_names_path(self, tmp_path):
        p = str(tmp_path / "bad.journal")
        with open(p, "wb") as f:
            f.write(b"NOPE" + b"\x00" * 16)
        with pytest.raises(ValueError, match="bad.journal"):
            read_journal(p)

    def test_in_memory_mode(self):
        j = Journal(None)
        j.append(_submit(0))
        j.append(ack_record(_completion(0)))
        assert j.seq == 2
        assert list(j.acked()) == [0]
        assert j.unacked_submits() == []


class TestCorruption:
    def test_crc_corruption_stops_reader(self, tmp_path):
        p = str(tmp_path / "j.journal")
        with Journal(p) as j:
            j.append(_submit(0))
            j.append(_submit(1))
        with open(p, "r+b") as f:
            data = f.read()
            f.seek(len(data) - 2)
            f.write(bytes([data[-2] ^ 0xFF]))
        recs, garbage = read_journal(p)
        assert [r["uid"] for r in recs] == [0]
        assert garbage > 0

    def test_truncated_tail_truncated_and_resumed(self, tmp_path):
        p = str(tmp_path / "j.journal")
        with Journal(p) as j:
            j.append(_submit(0))
        size_one = os.path.getsize(p)
        with Journal(p) as j:
            j.append(_submit(1))
        full = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(size_one + (full - size_one) // 2)
        j = Journal(p)
        assert j.recovered_garbage_bytes > 0
        assert [r["uid"] for r in j.records()] == [0]
        j.append(_submit(2))
        j.close()
        recs, garbage = read_journal(p)
        assert garbage == 0
        assert [r["uid"] for r in recs] == [0, 2]

    def test_scan_ignores_oversized_length_prefix(self):
        blob = encode_record(_submit(0))
        bogus = struct.pack("<II", 1 << 30, 0)
        recs, valid = scan_records(blob + bogus)
        assert [r["uid"] for r in recs] == [0]
        assert valid == len(blob)

    def test_reopen_preserves_existing_records(self, tmp_path):
        p = str(tmp_path / "j.journal")
        with Journal(p) as j:
            j.append(_submit(0))
        with Journal(p) as j:
            assert j.seq == 1
            j.append(_submit(1))
        recs, _ = read_journal(p)
        assert [r["uid"] for r in recs] == [0, 1]
        with open(p, "rb") as f:
            assert f.read(len(MAGIC)) == MAGIC


class TestSemantics:
    def test_ack_roundtrips_completion(self):
        c = _completion(7)
        rec = ack_record(c)
        assert rec["t"] == REC_ACK
        back = completion_from_ack(rec)
        assert isinstance(back, Completion)
        assert (back.uid, back.finish_reason, back.status) == (
            c.uid, c.finish_reason, c.status)
        np.testing.assert_array_equal(back.tokens, c.tokens)

    def test_unacked_submits(self):
        j = Journal(None)
        j.append(_submit(0))
        j.append(_submit(1))
        j.append(ack_record(_completion(0)))
        assert [r["uid"] for r in j.unacked_submits()] == [1]

    def test_cancelled_submit_still_listed_as_unacked(self):
        # cancels replay as cancels; the submit stays visible so that
        # replay can re-create and re-cancel the request
        j = Journal(None)
        j.append(_submit(0))
        j.append(cancel_record(0))
        assert [r["uid"] for r in j.unacked_submits()] == [0]


def _smoke_engine(tmp_path, **kw):
    cfg = fleet_demo_config("linear")
    from repro_torch.models import lm
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    return params, cfg, DecodeEngine(params, cfg, **dict(ENGINE_KW, **kw))


class TestWriteAheadOrdering:
    """The engine journals intent before it changes itself, and acks
    before a completion is observable."""

    def test_submit_journaled_before_engine_state(self, tmp_path):
        p = str(tmp_path / "j.journal")
        _, _, eng = _smoke_engine(tmp_path, journal=p)
        seen = []
        orig = eng.journal.append

        def append(rec):
            # the queue and the completions do not show the record's
            # effect yet when it is written
            seen.append((rec["t"], len(eng._queue),
                         rec["uid"] in eng._completions))
            return orig(rec)
        eng.journal.append = append
        uid = eng.submit([3, 1, 4], max_new_tokens=4)
        eng.run()
        assert seen == [(REC_SUBMIT, 0, False), (REC_ACK, 0, False)]
        acks = [r for r in eng.journal.records() if r["t"] == REC_ACK]
        assert [r["uid"] for r in acks] == [uid]
        assert acks[0]["tokens"] == eng.completions()[uid].tokens.tolist()

    def test_ack_unique_per_uid_across_replay(self, tmp_path):
        p = str(tmp_path / "j.journal")
        params, cfg, eng = _smoke_engine(tmp_path, journal=p)
        uid = eng.submit([3, 1, 4], max_new_tokens=4)
        eng.run()
        first = eng.completions()[uid]
        eng.journal.close()
        eng2 = DecodeEngine.recover(params, cfg, journal=Journal(p),
                                    **ENGINE_KW)
        assert not eng2.has_work()
        eng2.run()
        np.testing.assert_array_equal(eng2.completions()[uid].tokens,
                                      first.tokens)
        acks = [r for r in eng2.journal.records() if r["t"] == REC_ACK]
        assert [r["uid"] for r in acks] == [uid]

    def test_replayed_cancel_of_a_running_request(self, tmp_path):
        """A cancel journaled while its request ran replays against the
        requeued request: one cancelled ack, the others' tokens whole."""
        p = str(tmp_path / "j.journal")
        params, cfg, eng = _smoke_engine(tmp_path, journal=p)
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 256, size=6) for _ in range(3)]
        for pr in prompts:
            eng.submit(pr, 12)
        eng.step()
        assert eng.cancel(1)
        eng.journal.close()           # the process dies here
        rec = DecodeEngine.recover(params, cfg, journal=Journal(p),
                                   **ENGINE_KW)
        comps = {c.uid: c for c in rec.run()}
        assert comps[1].status == "cancelled"
        plain = DecodeEngine(params, cfg, **ENGINE_KW)
        for pr in prompts:
            plain.submit(pr, 12)
        ref = {c.uid: c.tokens.tolist() for c in plain.run()}
        assert comps[0].tokens.tolist() == ref[0]
        assert comps[2].tokens.tolist() == ref[2]
        assert sorted(r["uid"] for r in rec.journal.records()
                      if r["t"] == REC_ACK) == [0, 1, 2]


# ---------------------------------------------------------------------------
# serve --mode stream: crash, recover, drain
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return env


STREAM = ["--mode", "stream", "--smoke", "--device", "cpu", "--slots", "4",
          "--n-requests", "12", "--prompt-len", "16", "--gen-len", "16",
          "--arrival-rate", "0.5"]


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *STREAM, *argv],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)


def test_cli_crash_exits_3_and_recover_acks_every_request_once(tmp_path):
    jp, cd = str(tmp_path / "wal.journal"), str(tmp_path / "ck")
    durable = ["--journal", jp, "--checkpoint-dir", cd,
               "--checkpoint-every", "2"]
    out = _cli(*durable, "--crash-at-event", "3")
    assert out.returncode == 3, out.stderr
    assert "crash: injected at event 3" in out.stdout
    recs, _ = read_journal(jp)
    acked = {r["uid"] for r in recs if r["t"] == REC_ACK}
    assert [r["uid"] for r in recs if r["t"] == REC_SUBMIT] == list(range(12))
    assert len(acked) < 12 and os.listdir(cd) == ["step_2"]
    out = _cli(*durable, "--recover")
    assert out.returncode == 0, out.stderr
    assert f"recover: {12 - len(acked)} unacked request(s)" in out.stdout
    assert "acks=12 completions=12 lost=0 zero_loss=PASS" in out.stdout
    recs, garbage = read_journal(jp)
    acks = sorted(r["uid"] for r in recs if r["t"] == REC_ACK)
    assert garbage == 0 and acks == list(range(12))


def test_sigterm_drains_checkpoints_and_recovers(tmp_path, monkeypatch):
    """The drain, driven in process: SIGTERM raised from inside the third
    scheduler step; the segment finishes, the engine checkpoints, the
    previous handlers come back; ``--recover`` then finishes the stream
    with the tokens of an undrained run, each request acked once."""
    argv = STREAM[:]
    plain = serve.stream(serve.parse_args(argv))
    ref = {c.uid: c.tokens.tolist() for c in plain["completions"]}
    jp, cd = str(tmp_path / "wal.journal"), str(tmp_path / "ck")
    durable = argv + ["--journal", jp, "--checkpoint-dir", cd,
                      "--checkpoint-every", "0"]
    steps = []
    orig = DecodeEngine.step

    def step(self, policy="continuous"):
        steps.append(policy)
        if len(steps) == 3:
            signal.raise_signal(signal.SIGTERM)
        return orig(self, policy)
    monkeypatch.setattr(DecodeEngine, "step", step)
    before = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                signal.SIGTERM)}
    res = serve.stream(serve.parse_args(durable))
    monkeypatch.setattr(DecodeEngine, "step", orig)
    assert {s: signal.getsignal(s) for s in before} == before
    assert res["exit_code"] == 0 and res["drained"]
    assert len(steps) == 3 and res["in_flight"] > 0
    assert os.listdir(cd) and res["engine"].has_work()
    res["engine"].journal.close()
    rec = serve.stream(serve.parse_args(durable + ["--recover"]))
    assert rec["exit_code"] == 0 and rec["acks"] == 12
    assert {c.uid: c.tokens.tolist() for c in rec["completions"]} == ref
    recs, _ = read_journal(jp)
    assert sorted(r["uid"] for r in recs if r["t"] == REC_ACK) == \
        list(range(12))
