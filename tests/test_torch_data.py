"""The port's token-file and cloze datasets against the JAX package:
the same file, seed and shard, or the same task seed and step, give the
JAX modules' batches bit for bit; ``state``/``restore`` replays a
stream, and shards read disjoint windows within an epoch."""

import numpy as np
import pytest

from repro.data import ClozeTask as JaxClozeTask
from repro.data import TokenFileDataset as JaxTokenFileDataset
from repro.data import write_token_file as jax_write_token_file
from repro_torch.data import (ClozeBatch, ClozeTask, TokenFileDataset,
                              write_token_file)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 50_000, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2),
                                                   (7, 2, 4)])
def test_token_file_batches_are_jax_s_bit_for_bit(tmp_path, seed, shard,
                                                  num_shards):
    """A file written by either package, read past two epochs."""
    path = str(tmp_path / "tokens.bin")
    jax_write_token_file(path, _tokens(40 * 17))
    kw = dict(seq_len=16, global_batch=4 * num_shards, seed=seed,
              shard=shard, num_shards=num_shards)
    ours, theirs = TokenFileDataset(path, **kw), JaxTokenFileDataset(path,
                                                                     **kw)
    for _ in range(25):
        a, b = ours.next_batch(), theirs.next_batch()
        assert set(a) == {"tokens", "labels"}
        for key in a:
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
        assert ours.state() == theirs.state()
    assert ours.state()[0] >= 2
    write_token_file(path, _tokens(40 * 17, seed=1))
    np.testing.assert_array_equal(np.fromfile(path, np.int32),
                                  _tokens(40 * 17, seed=1))


def test_token_file_state_restore_replays(tmp_path):
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, np.arange(10_000, dtype=np.int32))
    ds = TokenFileDataset(path, seq_len=16, global_batch=4, seed=0)
    for _ in range(150):      # into the second epoch
        ds.next_batch()
    state = ds.state()
    want = [ds.next_batch() for _ in range(3)]
    again = TokenFileDataset(path, seq_len=16, global_batch=4, seed=0)
    again.restore(state)
    for w in want:
        np.testing.assert_array_equal(again.next_batch()["tokens"],
                                      w["tokens"])
    # JAX's dataset restores the port's state to the same place
    theirs = JaxTokenFileDataset(path, seq_len=16, global_batch=4, seed=0)
    theirs.restore(state)
    np.testing.assert_array_equal(theirs.next_batch()["labels"],
                                  want[0]["labels"])


def test_token_file_shards_disjoint_within_epoch(tmp_path):
    path = str(tmp_path / "tokens.bin")
    write_token_file(path, np.arange(32 * 17, dtype=np.int32))
    a = TokenFileDataset(path, 16, 2, shard=0, num_shards=2)
    b = TokenFileDataset(path, 16, 2, shard=1, num_shards=2)
    seen_a = {int(x["tokens"][0, 0]) for x in
              (a.next_batch() for _ in range(4))}
    seen_b = {int(x["tokens"][0, 0]) for x in
              (b.next_batch() for _ in range(4))}
    assert seen_a and not (seen_a & seen_b)


def test_token_file_too_small_raises(tmp_path):
    path = str(tmp_path / "tiny.bin")
    write_token_file(path, np.arange(16, dtype=np.int32))
    with pytest.raises(ValueError, match="too small"):
        TokenFileDataset(path, seq_len=15, global_batch=4)


@pytest.mark.parametrize("seed,step,batch,n_facts", [
    (0, 0, 16, 30), (1, 3, 8, 30), (1, 10_000_000, 256, 30),
    (5, 9, 4, 187), (2, 1, 64, 6)])
def test_cloze_batches_are_jax_s_bit_for_bit(seed, step, batch, n_facts):
    ours = ClozeTask(n_facts=n_facts, seed=seed)
    theirs = JaxClozeTask(n_facts=n_facts, seed=seed)
    assert ours.vocab_size == theirs.vocab_size
    assert ours.doc_len == theirs.doc_len == 4 * n_facts
    a, b = ours.batch(batch, step=step), theirs.batch(batch, step=step)
    assert isinstance(a, ClozeBatch) and a._fields == b._fields
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_cloze_answer_is_the_queried_fact_s_object():
    task = ClozeTask(seed=1)
    b = task.batch(8, step=3)
    for i in range(8):
        doc = b.doc[i].reshape(-1, 4)
        qs, qr = int(b.query[i, 0]), int(b.query[i, 1])
        match = [f for f in doc if int(f[0]) == qs and int(f[1]) == qr]
        assert len(match) == 1
        assert int(match[0][2]) == task.entity_token(int(b.answer[i]))
