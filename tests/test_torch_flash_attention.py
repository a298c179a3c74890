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
                                    (1, 512, 128)])
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
    (2, 2, 40, 40, 16)])         # the smoke width; tile drops to 40
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


def test_flash_attention_refuses_a_gradient():
    q = torch.from_numpy(_x(72, 1, 2, 16, 16)).requires_grad_()
    k = torch.from_numpy(_x(73, 1, 2, 16, 16))
    with pytest.raises(NotImplementedError):
        txa.flash_attention(q, k, k)
    with torch.no_grad():                # forward only: fine without autograd
        assert txa.flash_attention(q, k, k).shape == (1, 2, 16, 16)
