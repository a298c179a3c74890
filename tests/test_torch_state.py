"""Port of the paper's GRU encoder (``qa/gru.py``) and its fixed-size
document state and store (``core/state.py``) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; fp32
results agree at rtol = atol = 1e-5 (sums taken in different orders). A
store archive written by either package loads in the other and answers
the same.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.state import DocumentState as JaxState
from repro.core.state import DocumentStore as JaxStore
from repro.qa import gru as jax_gru
from repro_torch.convert import document_state_from_jax, encoder_from_jax
from repro_torch.core.state import DocumentState, DocumentStore
from repro_torch.qa import gru

TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np_encoder(seed, vocab=50, d=8, k=16):
    rng = np.random.default_rng(seed)
    return {"embed": _f32(rng, vocab, d) * 0.1,
            "gru": {"w_i": _f32(rng, d, 3 * k) / d ** 0.5,
                    "w_h": _f32(rng, k, 3 * k) / k ** 0.5,
                    "b": _f32(rng, 3 * k) * 0.1}}


def _jax_tree(np_tree):
    if isinstance(np_tree, dict):
        return {k: _jax_tree(v) for k, v in np_tree.items()}
    return jnp.asarray(np_tree)


def _close(port, jax_value, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(jax_value),
                               rtol=tol, atol=tol)


# -- GRU ----------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_gru_scan_matches_jax(with_h0):
    enc = _np_encoder(0)
    rng = np.random.default_rng(1)
    xs = _f32(rng, 3, 11, 8)
    h0 = _f32(rng, 3, 16) if with_h0 else None
    hs_j, last_j = jax_gru.gru_scan(
        _jax_tree(enc["gru"]), jnp.asarray(xs),
        None if h0 is None else jnp.asarray(h0))
    p = encoder_from_jax(enc, device=CPU)["gru"]
    hs_t, last_t = gru.gru_scan(p, torch.from_numpy(xs),
                                None if h0 is None else torch.from_numpy(h0))
    assert hs_t.shape == (3, 11, 16)
    _close(hs_t, hs_j)
    _close(last_t, last_j)
    torch.testing.assert_close(last_t, hs_t[:, -1], rtol=0, atol=0)


def test_gru_cell_matches_jax():
    enc = _np_encoder(2)
    rng = np.random.default_rng(3)
    h, x = _f32(rng, 4, 16), _f32(rng, 4, 8)
    want = jax_gru.gru_cell(_jax_tree(enc["gru"]), jnp.asarray(h),
                            jnp.asarray(x))
    p = encoder_from_jax(enc, device=CPU)["gru"]
    _close(gru.gru_cell(p, torch.from_numpy(h), torch.from_numpy(x)), want)


def test_gru_params_layout_and_generator():
    g = torch.Generator().manual_seed(0)
    p = gru.gru_params(g, 8, 16)
    assert p["w_i"].shape == (8, 48) and p["w_h"].shape == (16, 48)
    assert p["b"].shape == (48,) and not p["b"].any()
    p2 = gru.gru_params(torch.Generator().manual_seed(0), 8, 16)
    assert all(torch.equal(p[k], p2[k]) for k in p)
    jp = jax_gru.gru_params(jax.random.PRNGKey(0), 8, 16)
    assert {k: v.shape for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}


def test_encoder_from_jax_copies():
    enc = _np_encoder(4)
    t = encoder_from_jax(enc, device=CPU)
    t["gru"]["w_h"].zero_()
    assert np.abs(enc["gru"]["w_h"]).max() > 0


# -- DocumentState --------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_state_algebra_matches_jax(normalize):
    rng = np.random.default_rng(5)
    k = 16
    h1, h2 = np.abs(_f32(rng, 7, k)) + 0.1, np.abs(_f32(rng, 5, k)) + 0.1
    q1, qm = _f32(rng, k), _f32(rng, 3, k)
    js = JaxState.from_hidden_states(jnp.asarray(h1), with_normalizer=True)
    ts = DocumentState.from_hidden_states(torch.from_numpy(h1),
                                          with_normalizer=True)
    _close(ts.c, js.c)
    _close(ts.z, js.z)
    assert ts.n_tokens == js.n_tokens == 7 and ts.k == js.k
    assert ts.nbytes == js.nbytes == (k * k + k) * 4
    # streaming update, one token at a time, then merge
    for t in range(h2.shape[0]):
        js = js.update(jnp.asarray(h2[t]))
        ts = ts.update(torch.from_numpy(h2[t]))
    _close(ts.c, js.c)
    _close(ts.z, js.z)
    assert ts.n_tokens == js.n_tokens == 12
    other_j = JaxState.from_hidden_states(jnp.asarray(h2),
                                          with_normalizer=True)
    other_t = DocumentState.from_hidden_states(torch.from_numpy(h2),
                                               with_normalizer=True)
    mj, mt = js.merge(other_j), ts.merge(other_t)
    _close(mt.c, mj.c)
    _close(mt.z, mj.z)
    for q in (q1, qm):
        _close(mt.lookup(torch.from_numpy(q), normalize=normalize),
               mj.lookup(jnp.asarray(q), normalize=normalize))


def test_state_contracts():
    st = DocumentState.from_hidden_states(torch.ones(3, 4))
    assert st.z is None
    with pytest.raises(ValueError, match="normalizer"):
        st.lookup(torch.ones(4), normalize=True)
    z = DocumentState.zeros(4, (2,), with_normalizer=True, device="cpu")
    assert z.c.shape == (2, 4, 4) and z.z.shape == (2, 4) and not z.c.any()
    merged = st.merge(DocumentState.from_hidden_states(torch.ones(2, 4),
                                                       with_normalizer=True))
    assert merged.z is None and merged.n_tokens == 5


def test_document_state_from_jax():
    rng = np.random.default_rng(6)
    js = JaxState.from_hidden_states(jnp.asarray(_f32(rng, 4, 8)),
                                     with_normalizer=True)
    ts = document_state_from_jax(np.asarray(js.c), np.asarray(js.z),
                                 js.n_tokens, device=CPU)
    assert torch.equal(ts.c, torch.from_numpy(np.array(js.c)))
    assert ts.n_tokens == 4


# -- DocumentStore ---------------------------------------------------------

IDS = ["plain", "a::b", "::", "c_000000", "__ids__", "doc/with/slashes",
       "ünïcode π"]


def _states(seed, make, k=8):
    rng = np.random.default_rng(seed)
    return {d: make(_f32(rng, 3 + i, k), i % 2 == 0)
            for i, d in enumerate(IDS)}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_archive_loads_in_the_other_package(tmp_path, writer):
    path = os.path.join(tmp_path, "store.npz")
    src = JaxStore() if writer == "jax" else DocumentStore()
    if writer == "jax":
        states = _states(7, lambda h, z: JaxState.from_hidden_states(
            jnp.asarray(h), with_normalizer=z))
    else:
        states = _states(7, lambda h, z: DocumentState.from_hidden_states(
            torch.from_numpy(h), with_normalizer=z))
    for d, st in states.items():
        src.add(d, st)
    src.save(path)
    assert not os.path.exists(path + ".tmp.npz")
    dst = (DocumentStore.load(path, device="cpu") if writer == "jax"
           else JaxStore.load(path))
    assert list(dst.ids()) == IDS and len(dst) == len(IDS)
    for d in IDS:
        a, b = src.get(d), dst.get(d)
        np.testing.assert_array_equal(np.asarray(a.c), np.asarray(b.c))
        assert a.n_tokens == b.n_tokens
        assert (a.z is None) == (b.z is None)
        if a.z is not None:
            np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))
    # the same answers from both packages' stores
    jax_store = src if writer == "jax" else dst
    torch_store = dst if writer == "jax" else src
    q = np.random.default_rng(8).standard_normal((len(IDS), 2, 8)).astype(
        np.float32)
    _close(torch_store.batched_lookup(IDS, torch.from_numpy(q)),
           jax_store.batched_lookup(IDS, jnp.asarray(q)))
    assert torch_store.nbytes == jax_store.nbytes


@pytest.mark.parametrize("shape", [(3, 8), (3, 2, 8)])
def test_store_batched_lookup_matches_jax(shape):
    rng = np.random.default_rng(9)
    jstore, tstore = JaxStore(), DocumentStore()
    for i in range(3):
        h = np.abs(_f32(rng, 4 + i, 8)) + 0.1
        jstore.add(f"d{i}", JaxState.from_hidden_states(
            jnp.asarray(h), with_normalizer=True))
        tstore.add(f"d{i}", DocumentState.from_hidden_states(
            torch.from_numpy(h), with_normalizer=True))
    q = np.abs(_f32(rng, *shape)) + 0.1
    ids = ["d2", "d0", "d2"]
    for normalize in (False, True):
        _close(tstore.batched_lookup(ids, torch.from_numpy(q), normalize),
               jstore.batched_lookup(ids, jnp.asarray(q), normalize))
    assert tstore.lookup_dispatches == 2


def test_store_contracts(tmp_path):
    store = DocumentStore()
    store.add("x", DocumentState.from_hidden_states(torch.ones(2, 4)))
    with pytest.raises(ValueError, match="normalizer"):
        store.batched_lookup(["x"], torch.ones(1, 4), normalize=True)
    bad = os.path.join(tmp_path, "bad.npz")
    np.savez(bad, foo=np.zeros(3))
    with pytest.raises(ValueError, match="not a DocumentStore"):
        DocumentStore.load(bad, device="cpu")
    half = os.path.join(tmp_path, "half.npz")
    np.savez(half, __ids__=np.asarray(["a"]), c_000000=np.zeros((4, 4)))
    with pytest.raises(ValueError, match="missing member"):
        DocumentStore.load(half, device="cpu")
    # an atomic save replaces an existing archive
    path = os.path.join(tmp_path, "s.npz")
    store.save(path)
    store.add("y", DocumentState.from_hidden_states(torch.ones(3, 4)))
    store.save(path)
    assert list(DocumentStore.load(path, device="cpu").ids()) == ["x", "y"]
