"""The port's cross-attention (``models/attention.py``: the ``cross``
block kind's memory encode and lookup) and ``cross`` blocks against the
JAX package's on the CPU, at llama-3.2-vision-90b's smoke widths, on
numpy inputs from a seed and parameters from JAX: ``encode_cross_memory``
(softmax K and V; the linear family's C = φ(K)ᵀV and z = Σφ(K)) and
``cross_attention_apply`` under all three backends, ``linear_normalize``
on and off, the feature maps; the cross block's forward, decode and
window with its tanh gate set to 0.5 (at init it is 0 and the block adds
nothing, which would compare nothing); the memory's zero state.

Tolerances: fp32 within 1e-5 normwise (max|Δ| over max|JAX|; the fp32
sums over the memory's rows run in other orders); bf16 memories within
8e-3 normwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

RULES = Rules.null()
ARCH = "llama-3.2-vision-90b"
BACKENDS = ["linear", "gated_linear", "softmax"]
N_MEM = 24            # the smoke config's n_img_tokens


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(backend, **kw):
    kw = dict(attention_backend=backend, dtype="float32", **kw)
    return (dataclasses.replace(jax_smoke_config(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _normwise(t, want, tol=1e-5):
    t = t.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert t.shape == want.shape
    err = np.abs(t - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _inputs(cfg, t=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, N_MEM, cfg.d_model)).astype(np.float32)
    return x, mem


def _cross_params(jcfg, seed=0):
    pj = jattn.cross_attention_params(jax.random.PRNGKey(seed), jcfg)
    return pj, convert._tree(_np_tree(pj), None)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("fmap", ["elu1", "identity"])
def test_encode_and_apply_match_jax(backend, normalize, fmap):
    jcfg, tcfg = _configs(backend, linear_normalize=normalize,
                          feature_map=fmap)
    pj, pt = _cross_params(jcfg)
    x, mem = _inputs(jcfg)
    jm = jattn.encode_cross_memory(pj, jnp.asarray(mem), jcfg)
    tm = A.encode_cross_memory(pt, torch.from_numpy(mem), tcfg)
    assert type(tm).__name__ == "CrossMemory"
    assert tm._fields == jm._fields
    for name in tm._fields:
        t, j = getattr(tm, name), getattr(jm, name)
        assert (t is None) == (j is None), name
        if t is not None:
            assert t.dtype == torch.float32
            _normwise(t, j)
    if backend == "softmax":
        assert tm.k.shape == (2, jcfg.n_kv_heads, N_MEM, jcfg.head_dim)
    else:
        assert tm.c.shape == (2, jcfg.n_kv_heads, jcfg.head_dim,
                              jcfg.head_dim)
    jo = jattn.cross_attention_apply(pj, jnp.asarray(x), jm, jcfg, RULES)
    to = A.cross_attention_apply(pt, torch.from_numpy(x), tm, tcfg)
    _normwise(to, jo)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_memory_matches_jax(backend):
    """A bf16 memory and queries (the compute type at full width): K and
    V stay bf16 under softmax, C and z accumulate in fp32."""
    jcfg, tcfg = _configs(backend)
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in (jcfg, tcfg))
    pj, pt = _cross_params(jcfg, seed=1)
    x, mem = _inputs(jcfg, seed=1)
    xb, mb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, mem))
    jm = jattn.encode_cross_memory(pj, mb, jcfg)
    tm = A.encode_cross_memory(pt, convert._tensor(np.asarray(mb), None),
                               tcfg)
    if backend == "softmax":
        assert tm.k.dtype == torch.bfloat16
    else:
        assert tm.c.dtype == tm.z.dtype == torch.float32
        _normwise(tm.c, jm.c, 8e-3)
    jo = jattn.cross_attention_apply(pj, xb, jm, jcfg, RULES)
    to = A.cross_attention_apply(pt, convert._tensor(np.asarray(xb), None),
                                 tm, tcfg)
    assert to.dtype == torch.bfloat16
    _normwise(to, np.asarray(jo.astype(jnp.float32)), 8e-3)


def test_linear_memory_is_the_papers_compression():
    """Under ``identity`` and no normaliser, φ(q)·C is Σₙ (q·kₙ) vₙ over
    the raw rows: the lookup equals attention without a softmax."""
    _, tcfg = _configs("linear", linear_normalize=False,
                       feature_map="identity")
    _, pt = _cross_params(_configs("linear")[0], seed=2)
    x, mem = _inputs(tcfg, seed=2)
    x, mem = torch.from_numpy(x).double(), torch.from_numpy(mem).double()
    pt = {k: v.double() for k, v in pt.items()}
    tm = A.encode_cross_memory(pt, mem, tcfg)
    h, hkv, dh = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    k = (mem @ pt["wk"]).reshape(2, N_MEM, hkv, dh)
    v = (mem @ pt["wv"]).reshape(2, N_MEM, hkv, dh)
    q = (x @ pt["wq"]).reshape(2, 7, h // hkv, hkv, dh)
    o = torch.einsum("btghd,bnhd,bnhe->btghe", q, k, v)
    want = o.reshape(2, 7, h * dh) @ pt["wo"]
    got = A.cross_attention_apply(pt, x, tm, tcfg)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def _block_params(jcfg, seed):
    pj = jblocks.block_params("cross", jax.random.PRNGKey(seed), jcfg)
    pj["xgate"] = jnp.full_like(pj["xgate"], 0.5)
    return pj, convert._tree(_np_tree(pj), None)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_block_apply_decode_and_window_match_jax(backend):
    """The cross block with xgate = 0.5: the full-sequence forward (its
    state the encoded memory), one decode step and a 3-token window
    against that state, which neither changes."""
    jcfg, tcfg = _configs(backend)
    pj, pt = _block_params(jcfg, seed=3)
    assert pt["xgate"].item() == 0.5
    x, mem = _inputs(jcfg, seed=3)
    jx, jst, jaux = jblocks.block_apply("cross", pj, jnp.asarray(x), jcfg,
                                        RULES, memory=jnp.asarray(mem),
                                        want_state=True)
    tx, tst, taux = B.block_apply("cross", pt, torch.from_numpy(x), tcfg,
                                  memory=torch.from_numpy(mem),
                                  want_state=True)
    assert taux is None and float(jaux) == 0.0
    _normwise(tx, jx)
    for a, b in zip(tst, jst):
        assert (a is None) == (b is None)
        if a is not None:
            _normwise(a, b)
    before = [None if a is None else a.clone() for a in tst]
    jy, _ = jblocks.block_decode("cross", pj, jnp.asarray(x[:, 0]), jst,
                                 jnp.int32(7), jcfg, RULES)
    ty, tst2 = B.block_decode("cross", pt, torch.from_numpy(x[:, 0]), tst,
                              torch.tensor(7), tcfg)
    _normwise(ty, jy)
    jw, _ = jblocks.block_decode_window("cross", pj, jnp.asarray(x[:, :3]),
                                        jst, jnp.int32(7), jcfg, RULES)
    tw, _ = B.block_decode_window("cross", pt, torch.from_numpy(x[:, :3]),
                                  tst2, torch.tensor(7), tcfg)
    _normwise(tw, jw)
    assert all(a is None or torch.equal(a, b) for a, b in zip(tst2, before))


def test_cross_block_at_init_adds_nothing_but_its_mlp():
    """xgate starts at 0: tanh(0)·attention = 0, so the block is x + MLP
    (why every comparison above sets it nonzero)."""
    _, tcfg = _configs("linear")
    pt = B.block_params("cross", torch.Generator().manual_seed(0), tcfg)
    assert not pt["xgate"].any() and pt["xgate"].shape == (1,)
    x, mem = (torch.from_numpy(a) for a in _inputs(tcfg, seed=4))
    y, _, _ = B.block_apply("cross", pt, x, tcfg, memory=mem)
    want = x + L.mlp(pt["mlp"], L.apply_norm(tcfg.norm, pt["norm2"], x),
                     tcfg.act)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_cross_block_needs_the_memory():
    _, tcfg = _configs("linear")
    pt = B.block_params("cross", torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="memory"):
        B.block_apply("cross", pt, torch.zeros(1, 3, tcfg.d_model), tcfg)


@pytest.mark.parametrize("backend", BACKENDS)
def test_memory_zero_state_matches_jax_layout(backend):
    jcfg, tcfg = _configs(backend)
    j = _np_tree(jblocks.block_state_init("cross", jcfg, 3, 16,
                                          jnp.float32))
    t = B.block_state_init("cross", tcfg, 3, lead=(2,))
    for name in t._fields:
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape == (2, *b.shape) and not a.any()
            assert a.dtype == (torch.float32 if name in ("c", "z")
                               else getattr(torch, tcfg.dtype))


def test_full_width_memory_per_layer_and_row():
    """What the paper's compression saves at full width: per layer and
    batch row, C and z (fp32) against K and V of 6,404 image tokens in
    bf16."""
    cfg = get_config(ARCH)
    hkv, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_img_tokens
    linear = hkv * (dh * dh + dh) * 4
    softmax = 2 * hkv * n * dh * 2
    assert (linear, softmax) == (528384, 26230784)
    assert (linear / 2**10, round(softmax / 2**20, 2)) == (516.0, 25.02)
