"""The port's causal flash-attention forward (B10) and the softmax
attention functions of ``models/xla_attention.py`` against the JAX
package, on the CPU.

The plain ``flash_attention_fwd_ref`` (what the CUDA kernel is held to
on the card) against the Pallas ``fwd`` run through its interpreter, at
the JAX kernel tests' shapes: fp32 at rtol = atol = 1e-5 (the same fp32
sums in another order: online over 128-key tiles there, one softmax
here), bf16 at JAX's 2e-2 (one bf16 rounding of the output). The
wrappers against JAX's wrappers at 1e-5 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jk
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import xla_attention as jxa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.models import xla_attention as txa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(a, dtype="float32"):
    """The same numbers as a JAX array and a torch tensor of ``dtype``
    (bf16 rounded once, by JAX, and carried over exactly)."""
    j = jnp.asarray(a, JNP[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype])
    return j, t


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(jnp.asarray(j, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,t,d", [(2, 256, 64), (4, 128, 64),
                                    (1, 512, 128), (2, 256, 96)])
def test_plain_fwd_matches_pallas(bh, t, d, dtype):
    (qj, qt), (kj, kt), (vj, vt) = (_both(_x(i, bh, t, d), dtype)
                                    for i in range(3))
    o_j = jk.fwd(qj, kj, vj, cq=128, ckv=128, interpret=True)
    o_t = ops.fwd(qt, kt, vt)
    assert o_t.dtype == TORCH[dtype] and o_t.shape == (bh, t, d)
    _close(o_t, o_j, TOL[dtype])


@pytest.mark.parametrize("t,s,t_off,s_real", [
    (128, 256, None, None),      # queries the last T of S keys
    (256, 256, None, 200),       # keys past s_real masked
    (128, 256, 40, 150),         # both, given explicitly
    (128, 256, 0, 256)])         # queries the first T of S keys
def test_plain_fwd_offsets_match_pallas(t, s, t_off, s_real):
    bh, d = 2, 64
    (qj, qt), (kj, kt), (vj, vt) = (_both(_x(10 + i, bh, n, d))
                                    for i, n in enumerate((t, s, s)))
    o_j = jk.fwd(qj, kj, vj, cq=128, ckv=128, interpret=True, t_off=t_off,
                 s_real=s_real)
    _close(ops.fwd(qt, kt, vt, t_off=t_off, s_real=s_real), o_j, 1e-5)


def test_plain_version_matches_pallas_on_rows_that_see_no_key():
    """Outside the wrappers' domain (t_off < 0): a query with no visible
    key gets the mean of v over every key under the Pallas grid, and
    under the plain version too (both mask with -1e30, not -inf). ``fwd``
    refuses this domain, because the kernel stops early; the plain
    version is called directly here."""
    bh, t, d = 2, 256, 64
    (qj, qt), (kj, kt), (vj, vt) = (_both(_x(20 + i, bh, t, d))
                                    for i in range(3))
    o_j = jk.fwd(qj, kj, vj, cq=128, ckv=128, interpret=True, t_off=-200)
    o_t = ref.flash_attention_fwd_ref(qt, kt, vt, scale=d ** -0.5,
                                      t_off=-200, s_real=t)
    _close(o_t, o_j, 1e-5)
    torch.testing.assert_close(o_t[:, 0], vt.mean(dim=1), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        ops.fwd(qt, kt, vt, t_off=-200)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_matches_jax_oracle(dtype):
    (qj, qt), (kj, kt), (vj, vt) = (_both(_x(30 + i, 3, n, 64), dtype)
                                    for i, n in enumerate((96, 160, 160)))
    oracle = ref.flash_attention_ref(qt, kt, vt)
    _close(oracle, jref.flash_attention_ref(qj, kj, vj), TOL[dtype])
    torch.testing.assert_close(oracle.float(), ops.fwd(qt, kt, vt).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,t,s,d", [
    (2, 3, 200, 200, 64),        # ragged: T and S padded to 256
    (1, 4, 72, 200, 128),        # T < S, both ragged
    (2, 2, 40, 40, 16),          # the smoke width; tile drops to 40
    (1, 2, 72, 200, 96)])        # phi3-mini-3.8b's head dim, ragged
def test_wrapper_matches_jax_wrapper(b, h, t, s, d, dtype):
    (qj, qt), (kj, kt), (vj, vt) = (_both(_x(40 + i, b, h, n, d), dtype)
                                    for i, n in enumerate((t, s, s)))
    o_j = jops.flash_attention(qj, kj, vj, interpret=True)
    o_t = ops.flash_attention(qt, kt, vt)
    assert o_t.shape == (b, h, t, d) and o_t.dtype == TORCH[dtype]
    _close(o_t, o_j, TOL[dtype])


@pytest.mark.parametrize("t,s,q_offset", [(48, 48, 0), (24, 56, None),
                                          (24, 56, 10)])
def test_model_flash_attention_matches_jax(t, s, q_offset):
    """``models/xla_attention.flash_attention`` against JAX's jnp pair-list
    flash forward (what JAX's model calls), flat heads, fp32."""
    b, h, d = 2, 4, 16
    (qj, qt), (kj, kt), (vj, vt) = (_both(_x(50 + i, b, h, n, d))
                                    for i, n in enumerate((t, s, s)))
    o_j = jxa.flash_attention(qj, kj, vj, None, 16, q_offset)
    _close(txa.flash_attention(qt, kt, vt, None, q_offset), o_j, 1e-5)
    _close(txa.flash_attention(qt, kt, vt, None, q_offset, kernel=False),
           o_j, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [7, "per_row"])
def test_decode_attention_matches_jax(cache_len, dtype):
    b, g, hkv, s, d = 3, 2, 2, 12, 16
    qj, qt = _both(_x(60, b, g, hkv, d), dtype)
    kj, kt = _both(_x(61, b, hkv, s, d), dtype)
    vj, vt = _both(_x(62, b, hkv, s, d), dtype)
    cl = (np.array([1, 5, 12], np.int32) if cache_len == "per_row"
          else np.int32(cache_len))
    o_j = jxa.decode_attention(qj, kj, vj, jnp.asarray(cl))
    o_t = txa.decode_attention(qt, kt, vt, torch.from_numpy(np.asarray(cl)))
    assert o_t.dtype == TORCH[dtype]
    _close(o_t, o_j, TOL[dtype])


def test_cpu_tensors_count_no_launch():
    before = ops.fwd.launches
    q = torch.from_numpy(_x(70, 2, 3, 40, 16))
    ops.flash_attention(q, q, q)
    ops.fwd(q[0], q[0], q[0])
    txa.flash_attention(q, q, q)
    assert ops.fwd.launches == before


@pytest.mark.parametrize("t_off,s_real", [(-1, None), (None, 0),
                                          (None, 41), (-5, 10)])
def test_fwd_refuses_a_query_without_a_visible_key(t_off, s_real):
    q = torch.from_numpy(_x(71, 2, 40, 16))
    with pytest.raises(ValueError):
        ops.fwd(q, q, q, t_off=t_off, s_real=s_real)


# -- K/V read by kv head (grouped-query attention) ----------------------------
# q head h = g·Hkv + j reads kv head j (the port's (G, Hkv) flattening);
# JAX's model broadcasts K/V to the flat heads first, so the JAX side gets
# them through jnp.broadcast_to(k[:, None], (b, g, hkv, ...)).

def _gqa(seed, b, g, hkv, t, s, d, dtype="float32"):
    """q (B, G·Hkv, T, D), k, v (B, Hkv, S, D) as torch tensors, and the
    same q with K/V broadcast to the flat heads as JAX arrays."""
    qj, qt = _both(_x(seed, b, g * hkv, t, d), dtype)
    (kj, kt), (vj, vt) = (_both(_x(seed + i, b, hkv, s, d), dtype)
                          for i in (1, 2))
    flat = lambda x: jnp.broadcast_to(                      # noqa: E731
        x[:, None], (b, g, hkv, s, d)).reshape(b, g * hkv, s, d)
    return (qj, flat(kj), flat(vj)), (qt, kt, vt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,g,hkv,t,s,d", [
    (2, 2, 3, 128, 128, 64),         # G = 2
    (1, 2, 8, 128, 256, 128),        # qwen3-0.6b's H 16 / Hkv 8, T < S
    (1, 7, 1, 128, 128, 96),         # yi-34b's G = 7 at D = 96
    (1, 6, 1, 128, 256, 96)])        # internlm2-20b's G = 6, T < S
def test_plain_fwd_by_kv_head_matches_pallas_on_broadcast_kv(b, g, hkv, t,
                                                             s, d, dtype):
    (qj, kj, vj), (qt, kt, vt) = _gqa(80, b, g, hkv, t, s, d, dtype)
    h = g * hkv
    o_j = jk.fwd(qj.reshape(b * h, t, d), kj.reshape(b * h, s, d),
                 vj.reshape(b * h, s, d), cq=128, ckv=128, interpret=True)
    o_t = ops.fwd(qt.reshape(b * h, t, d), kt.reshape(b * hkv, s, d),
                  vt.reshape(b * hkv, s, d), kv_heads=hkv)
    assert o_t.shape == (b * h, t, d) and o_t.dtype == TORCH[dtype]
    _close(o_t, o_j, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,g,hkv,t,s,d", [
    (2, 2, 2, 72, 200, 64),          # G = 2, T < S, both ragged
    (1, 2, 8, 40, 40, 16)])          # H 16 / Hkv 8 at the smoke width
def test_wrapper_by_kv_head_matches_jax_wrapper(b, g, hkv, t, s, d, dtype):
    (qj, kj, vj), (qt, kt, vt) = _gqa(90, b, g, hkv, t, s, d, dtype)
    o_j = jops.flash_attention(qj, kj, vj, interpret=True)
    o_t = ops.flash_attention(qt, kt, vt)
    assert o_t.shape == (b, g * hkv, t, d) and o_t.dtype == TORCH[dtype]
    _close(o_t, o_j, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,g,hkv,t,s,q_offset", [
    (2, 2, 2, 48, 48, 0),
    (1, 2, 8, 24, 56, None),         # H 16 / Hkv 8
    (2, 3, 1, 24, 56, 10)])          # every q head on one kv head
def test_model_flash_attention_by_kv_head_matches_jax(b, g, hkv, t, s,
                                                      q_offset, dtype):
    """``models/xla_attention.flash_attention`` with Hkv < H against JAX's
    jnp flash forward on K/V broadcast as JAX's model broadcasts them."""
    (qj, kj, vj), (qt, kt, vt) = _gqa(100, b, g, hkv, t, s, 16, dtype)
    o_j = jxa.flash_attention(qj, kj, vj, None, 16, q_offset)
    _close(txa.flash_attention(qt, kt, vt, None, q_offset), o_j,
           TOL[dtype])
    _close(txa.flash_attention(qt, kt, vt, None, q_offset, kernel=False),
           o_j, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_by_head_is_bitwise_the_broadcast_call(dtype):
    """The plain route on K/V of Hkv heads gives bitwise what it gives on
    the broadcast copy the model used to make (B 2, H 16, Hkv 8)."""
    b, g, hkv, t, d = 2, 2, 8, 40, 16
    _, (q, k, v) = _gqa(110, b, g, hkv, t, t, d, dtype)
    kb, vb = (x[:, None].expand(b, g, hkv, t, d).reshape(b, g * hkv, t, d)
              for x in (k, v))
    assert torch.equal(ops.flash_attention(q, k, v),
                       ops.flash_attention(q, kb, vb))
    assert torch.equal(txa.flash_attention(q, k, v, None, 0),
                       txa.flash_attention(q, kb, vb, None, 0))
    rows = lambda x: x.reshape(-1, t, d)                    # noqa: E731
    assert torch.equal(
        ops.fwd(rows(q), rows(k), rows(v), kv_heads=hkv, t_off=3,
                s_real=30),
        ops.fwd(rows(q), rows(kb), rows(vb), t_off=3, s_real=30))


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("rq,rk,kv_heads", [
    (8, 4, None),       # fewer kv rows, no kv_heads
    (12, 6, 4),         # kv rows not a multiple of kv_heads
    (12, 8, 4),         # H = 6 not a multiple of Hkv = 4
    (10, 4, 2),         # q rows not a multiple of B = 2
    (12, 6, 0)])        # kv_heads < 1
def test_fwd_rejects_rows_that_do_not_divide(rq, rk, kv_heads, kernel):
    q = torch.zeros((rq, 16, 16))
    k = torch.zeros((rk, 16, 16))
    with pytest.raises(ValueError):
        ops.fwd(q, k, k, kv_heads=kv_heads, kernel=kernel)


def test_softmax_prefill_passes_kv_heads_not_a_broadcast(monkeypatch):
    """The softmax layer hands the attention K/V of Hkv heads (the smoke
    config's GQA 4/2): no K or V tensor of H heads is built."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm as tlm
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend("softmax"),
        dtype="float32")
    assert cfg.n_kv_heads < cfg.n_heads
    seen = []
    real = txa.flash_attention

    def spy(q, k, v, *args, **kwargs):
        seen.append((q.shape[1], k.shape[1], v.shape[1]))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(txa, "flash_attention", spy)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    tlm.prefill(params, torch.zeros((2, 12), dtype=torch.long), cfg)
    assert seen == [(cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)] * \
        cfg.n_layers
