"""Port of the memory-serving ``LookupEngine`` and ``serve --mode lookup``
against the JAX package.

Both engines get the same encoder (numpy weights, carried over with
``encoder_from_jax``), the same documents and the same query stream. The
integer counters, resident bytes, statuses and waves must be equal;
answers and resident store rows agree within 1e-4 (an fp32 GRU over a few
dozen steps and Gram sums taken in another order). Properties of the
port alone (the ingest scratch row, keep-last for duplicate pending ids,
wave answers against solo lookups) are asserted within torch, never with
JAX as ground truth.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import LookupEngine as JaxEngine
from repro_torch.convert import encoder_from_jax
from repro_torch.core.state import DocumentState, DocumentStore
from repro_torch.launch import serve
from repro_torch.qa.gru import gru_scan
from repro_torch.serving import (
    LookupEngine, get_lookup_backend, register_lookup_backend,
)
from repro_torch.serving.lookup_engine import LinearLookupBackend

K, VOCAB, D = 16, 50, 8
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_encoder(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return {"embed": f(VOCAB, D) * 0.5,
            "gru": {"w_i": f(D, 3 * K) / D ** 0.5,
                    "w_h": f(K, 3 * K) / K ** 0.5, "b": f(3 * K) * 0.1}}


def _jax_encoder(np_enc):
    return {"embed": jnp.asarray(np_enc["embed"]),
            "gru": {k: jnp.asarray(v) for k, v in np_enc["gru"].items()}}


def _docs(seed=1, n=7):
    rng = np.random.default_rng(seed)
    return {f"doc{i}": rng.integers(0, VOCAB, size=3 + 5 * i)
            for i in range(n)}


def _stream(seed=2, n=23, n_docs=7):
    """(doc id, (M, K) queries with M in 1..4, priority) per request."""
    rng = np.random.default_rng(seed)
    return [(f"doc{int(rng.integers(0, n_docs))}",
             np.abs(rng.standard_normal((int(rng.integers(1, 5)), K))
                    ).astype(np.float32) + 0.1,
             int(rng.integers(0, 3))) for _ in range(n)]


def _engines(backend="linear", normalize=False, **kwargs):
    np_enc = _np_encoder()
    common = dict(backend=backend, normalize=normalize, ingest_wave=4,
                  wave_size=4, **kwargs)
    return (JaxEngine(_jax_encoder(np_enc), **common),
            LookupEngine(encoder_from_jax(np_enc, device=torch.device("cpu")),
                         device="cpu", **common))


def _ingest(engines, docs):
    for eng in engines:
        for d, toks in docs.items():
            eng.ingest(d, toks)
        eng.flush()


def _stats(eng):
    return dataclasses.asdict(eng.stats)


def _same_results(jr, tr):
    assert [(r.uid, r.doc_id, r.status, r.wave) for r in jr] == [
        (r.uid, r.doc_id, r.status, r.wave) for r in tr]
    for a, b in zip(jr, tr):
        assert (a.answers is None) == (b.answers is None)
        if a.answers is not None:
            np.testing.assert_allclose(b.answers, np.asarray(a.answers),
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend,normalize", [
    ("linear", False), ("linear", True), ("softmax", False)])
def test_engine_matches_jax(backend, normalize):
    je, te = _engines(backend, normalize)
    docs = _docs()
    _ingest((je, te), docs)
    for eng in (je, te):
        for d, q, p in _stream():
            eng.submit(d, q, priority=p)
    jr, tr = je.run(), te.run()
    assert _stats(te) == _stats(je)
    assert te.stats.ingest_waves == 2 and te.stats.waves == 6
    assert te.stats.multi_memory_waves > 0
    assert te.resident_bytes == je.resident_bytes
    assert te.rows() == je.rows()
    _same_results(jr, tr)
    rows = list(te.rows().values())
    for key in te.store:
        np.testing.assert_allclose(te.store[key][rows].numpy(),
                                   np.asarray(je.store[key])[rows],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("policy", ["reject_new", "evict_lowest"])
def test_shedding_and_cancel_match_jax(policy):
    je, te = _engines(max_queue=5, shed_policy=policy)
    _ingest((je, te), _docs(n=4))
    stream = _stream(seed=3, n=14, n_docs=4)
    cancelled = []
    for eng in (je, te):
        for d, q, p in stream[:9]:
            eng.submit(d, q, priority=p)
        cancelled.append([eng.cancel(uid) for uid in (2, 7)])
        eng.step()
        for d, q, p in stream[9:]:
            eng.submit(d, q, priority=p)
        assert not eng.cancel(10 ** 6)
    jr, tr = je.run(), te.run()
    assert cancelled[0] == cancelled[1]
    assert _stats(te) == _stats(je)
    assert te.stats.shed > 0
    _same_results(jr, tr)
    assert {r.status for r in tr} >= {"ok", "shed"}


def test_cancel_matches_jax():
    je, te = _engines()
    _ingest((je, te), _docs(n=3))
    for eng in (je, te):
        for d, q, p in _stream(seed=4, n=6, n_docs=3):
            eng.submit(d, q, priority=p)
        assert eng.cancel(3) and not eng.cancel(3)
    jr, tr = je.run(), te.run()
    assert _stats(te) == _stats(je) and te.stats.cancelled == 1
    _same_results(jr, tr)
    assert tr[3].status == "cancelled" and tr[3].answers is None


def test_pinned_store_from_jax_archive_serves_like_jax(tmp_path):
    """A DocumentStore written by the JAX package, pinned in both
    engines, answers alike (normalised)."""
    from repro.core.state import DocumentState as JaxState
    from repro.core.state import DocumentStore as JaxStore
    rng = np.random.default_rng(5)
    jstore = JaxStore()
    for i in range(5):
        h = np.abs(rng.standard_normal((4 + i, K))).astype(np.float32)
        jstore.add(f"m{i}", JaxState.from_hidden_states(
            jnp.asarray(h), with_normalizer=True))
    path = os.path.join(tmp_path, "s.npz")
    jstore.save(path)
    je = JaxEngine(k=K, normalize=True, wave_size=3)
    te = LookupEngine(k=K, normalize=True, wave_size=3, device="cpu")
    loaded = DocumentStore.load(path, device="cpu")
    for d in loaded.ids():
        je.pin(d, jstore.get(d))
        te.pin(d, loaded.get(d))
    for eng in (je, te):
        for d, q, p in _stream(seed=6, n=8, n_docs=5):
            eng.submit(d.replace("doc", "m"), q, priority=p)
    jr, tr = je.run(), te.run()
    assert _stats(te) == _stats(je) and te.stats.pinned == 5
    _same_results(jr, tr)


# -- properties of the port alone -------------------------------------------

def _port_engine(**kwargs):
    return LookupEngine(encoder_from_jax(_np_encoder(),
                                         device=torch.device("cpu")),
                        device="cpu", **kwargs)


def _solo_encode(eng, tokens):
    x = eng.encoder["embed"][torch.as_tensor(tokens).long()]
    hs, _ = gru_scan(eng.encoder["gru"], x[None])
    return DocumentState.from_hidden_states(hs[0])


def test_reingest_wave_padding_never_clobbers_resident_rows():
    """A bucket-padded re-ingest wave writes its padded rows to the
    scratch row past the last live one, never to a resident row."""
    eng = _port_engine()
    docs = _docs(seed=15, n=5)
    for d, t in docs.items():
        eng.ingest(d, t)
    eng.flush()
    before = {d: eng.store["c"][r].clone() for d, r in eng.rows().items()}
    assert before["doc3"].any() and before["doc4"].any()
    for d in ("doc0", "doc1", "doc2"):         # one wave, bucket 4
        eng.ingest(d, docs[d])
    eng.flush()
    assert eng.stats.ingest_waves == 2
    for d in ("doc3", "doc4"):
        assert torch.equal(eng.store["c"][eng.rows()[d]], before[d])
    for d in ("doc0", "doc1", "doc2"):
        torch.testing.assert_close(eng.store["c"][eng.rows()[d]],
                                   _solo_encode(eng, docs[d]).c,
                                   rtol=1e-5, atol=1e-5)
    assert not eng.store["c"][len(eng)].any()          # the scratch row


def test_duplicate_pending_ids_keep_last_payload():
    eng = _port_engine()
    rng = np.random.default_rng(16)
    stale, fresh = (rng.integers(0, VOCAB, size=9),
                    rng.integers(0, VOCAB, size=13))
    eng.ingest("dup", stale)
    eng.ingest("other", rng.integers(0, VOCAB, size=5))
    eng.ingest("dup", fresh)
    eng.flush()
    assert len(eng) == 2 and eng.stats.documents == 2
    row = eng.store["c"][eng.rows()["dup"]]
    torch.testing.assert_close(row, _solo_encode(eng, fresh).c, rtol=1e-5,
                               atol=1e-5)
    assert (row - _solo_encode(eng, stale).c).abs().max() > 1e-2


@pytest.mark.parametrize("use_kernel", [None, False])
def test_wave_answers_equal_solo_lookups(use_kernel):
    """Resident rows from hidden states are bitwise the solo states, and
    mixed-memory wave answers equal solo lookups."""
    rng = np.random.default_rng(11)
    hs = [torch.from_numpy(rng.standard_normal((4 + 3 * i, K)).astype(
        np.float32)) for i in range(6)]
    eng = LookupEngine(k=K, normalize=True, wave_size=4, device="cpu",
                       use_kernel=use_kernel)
    for i, h in enumerate(hs):
        eng.ingest_hidden(f"m{i}", h)
    solo = [DocumentState.from_hidden_states(h, with_normalizer=True)
            for h in hs]
    for i in range(6):
        row = eng.rows()[f"m{i}"]
        assert torch.equal(eng.store["c"][row], solo[i].c)
        assert torch.equal(eng.store["z"][row], solo[i].z)
    submitted = {}
    for i in range(12):
        q = np.abs(rng.standard_normal((1 + i % 2, K))).astype(np.float32)
        submitted[eng.submit(f"m{i % 6}", q)] = (i % 6, q)
    results = eng.run()
    assert len(results) == 12
    for r in results:
        doc, q = submitted[r.uid]
        assert r.status == "ok" and r.answers.shape == q.shape
        torch.testing.assert_close(
            torch.from_numpy(r.answers),
            solo[doc].lookup(torch.from_numpy(q), normalize=True),
            rtol=1e-5, atol=1e-5)
    st = eng.stats
    assert st.lookup_dispatches == st.waves == st.multi_memory_waves == 3


def test_plain_route_equals_wrapper_route_on_cpu():
    """On CPU tensors the wrapper runs the plain version, so
    ``use_kernel=False`` gives the same bits."""
    rng = np.random.default_rng(12)
    hs = [rng.standard_normal((5, K)) for _ in range(3)]
    qs = [rng.standard_normal((1 + i % 3, K)) for i in range(8)]
    out = []
    for use_kernel in (None, False):
        eng = LookupEngine(k=K, wave_size=8, device="cpu",
                           use_kernel=use_kernel)
        for i, h in enumerate(hs):
            eng.ingest_hidden(f"m{i}", h)
        for i, q in enumerate(qs):
            eng.submit(f"m{i % 3}", q)
        out.append([r.answers for r in eng.run()])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_store_growth_priority_order_and_pending_flush():
    eng = _port_engine(capacity=2, wave_size=2)
    for i in range(5):
        eng.ingest(f"d{i}", np.arange(3 + i) % VOCAB)
    assert eng.has_work() and len(eng) == 0
    uids = [eng.submit("d0", np.ones(K), priority=p) for p in (0, 2, 1, 2)]
    eng.step()                                 # flushes pending first
    assert len(eng) == 5 and eng.stats.store_grows == 1   # 2 -> 8 at once
    assert eng.store["c"].shape[0] == 8
    assert eng.resident_bytes == 5 * K * K * 4
    eng.run()
    waves = {r.uid: r.wave for r in eng.results()}
    assert [waves[u] for u in uids] == [1, 0, 1, 0]        # priority, FIFO


def test_contracts_and_registry():
    eng = LookupEngine(k=K, backend="softmax", device="cpu")
    st = DocumentState.from_hidden_states(torch.ones(4, K))
    with pytest.raises(ValueError, match="fixed-size"):
        eng.pin("d", st)
    norm = LookupEngine(k=K, normalize=True, device="cpu")
    with pytest.raises(ValueError, match="no z"):
        norm.pin("d", st)
    with pytest.raises(KeyError, match="unknown document"):
        norm.submit("nope", np.ones((1, K), np.float32))
    with pytest.raises(ValueError, match="encoder"):
        LookupEngine(k=K, device="cpu").ingest("d", [1, 2])
    with pytest.raises(ValueError):
        LookupEngine(device="cpu")
    assert get_lookup_backend("linear") is LinearLookupBackend
    with pytest.raises(KeyError):
        get_lookup_backend("nope")
    with pytest.raises(ValueError, match="duplicate"):
        register_lookup_backend(LinearLookupBackend)
    with pytest.raises(ValueError, match="shed_policy"):
        LookupEngine(k=K, shed_policy="drop_all", device="cpu")
    with pytest.raises(ValueError, match="max_queue"):
        LookupEngine(k=K, max_queue=0, device="cpu")
    with pytest.raises(ValueError, match="hidden states"):
        norm.ingest_hidden("h", torch.ones(3, K + 1))
    with pytest.raises(ValueError, match="k="):
        LookupEngine(k=K + 1, device="cpu").pin("d", st)
    with pytest.raises(TypeError):               # no kernel to turn off
        LookupEngine(k=K, backend="softmax", use_kernel=False, device="cpu")


# -- the entry point ----------------------------------------------------------

def _serve(*argv):
    return serve.lookup(serve.parse_args(
        ["--mode", "lookup", "--device", "cpu", *argv]))


def test_serve_lookup_on_cpu_one_dispatch_per_wave():
    out = _serve("--n-docs", "12", "--doc-len", "10", "--n-queries", "40",
                 "--wave-size", "8", "--seed", "3")
    eng = out["engine"]
    assert out["waves"] == out["lookup_dispatches"] == 10
    assert out["timed_waves"] == 5 and out["multi_memory_waves"] == 10
    assert out["lookup_launches"] == 0           # CPU: the plain version
    assert len(out["doc_ids"]) == 12 and eng.stats.ingest_waves == 1
    assert out["resident_mib"] == 12 * 64 * 64 * 4 / 2**20
    results = {r.uid: r for r in eng.results()}
    for i in range(40):
        r = results[out["timed_uid0"] + i]
        doc = out["doc_ids"][(i * 7) % 12]
        assert r.doc_id == doc and r.status == "ok"
        want = eng.store["c"][eng.rows()[doc]] @ torch.from_numpy(
            out["queries"][i])
        np.testing.assert_allclose(r.answers[0], want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_serve_lookup_pins_a_persisted_store(tmp_path, capsys):
    path = os.path.join(tmp_path, "s.npz")
    store = DocumentStore()
    rng = np.random.default_rng(7)
    for i in range(3):
        store.add(f"p{i}", DocumentState.from_hidden_states(torch.from_numpy(
            rng.standard_normal((5, 64)).astype(np.float32))))
    store.save(path)
    out = _serve("--load", path, "--n-queries", "9", "--wave-size", "4")
    assert out["doc_ids"] == ["p0", "p1", "p2"]
    assert out["engine"].stats.pinned == 3 and out["waves"] == 6
    assert "pinned 3 persisted memories" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.parse_args(["--mode", "lookup", "--load", path,
                          "--lookup-backend", "softmax"])


def test_serve_lookup_softmax_backend_and_stats_json(tmp_path):
    path = os.path.join(tmp_path, "stats.json")
    out = _serve("--n-docs", "4", "--doc-len", "6", "--n-queries", "8",
                 "--wave-size", "8", "--lookup-backend", "softmax",
                 "--max-queue", "6", "--shed-policy", "evict_lowest",
                 "--stats-json", path)
    st = out["engine"].stats
    assert st.backend == "softmax" and st.shed == 4
    assert out["resident_mib"] == 4 * 6 * 64 * 4 / 2**20
    with open(path) as f:
        assert '"shed": 4' in f.read()


def test_engine_and_entry_point_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LookupEngine(k=K)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.lookup(serve.parse_args(["--mode", "lookup"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        DocumentState.zeros(K)
