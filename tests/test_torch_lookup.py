"""Port of the fast-lookup kernels (B4 ``mass_lookup_indexed``, B5
``mass_lookup``, B6 ``decode``) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX wrappers running the Pallas kernel bodies through
the Pallas interpreter, and the port's ``ref.py`` against the JAX
``ref.py``, at rtol = atol = 1e-5 with unit-scale fp32 inputs (the two
frameworks sum in different orders). The states are not symmetric, so a
transposed read of C would show. The CUDA kernels themselves are held
against the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lookup import kernel as jax_kernel
from repro.kernels.lookup import ops as jax_ops
from repro.kernels.lookup import ref as jax_ref
from repro_torch.kernels.lookup import ops, ref

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_value, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_value),
                               rtol=tol, atol=tol)


def _nonsymmetric(c):
    assert np.abs(c - np.swapaxes(c, -1, -2)).max() > 0.1


# K = 256: the CUDA bulk route's ring; K = 33: its direct-load route (odd K)
@pytest.mark.parametrize("kd", [32, 64, 100, 128, 256, 33])
@pytest.mark.parametrize("n,b,m,block_m", [
    (4, 6, 3, None),       # duplicate rows (b > n)
    (3, 4, 5, 4),          # M padded to a block_m multiple and sliced back
    (5, 2, 1, None),       # one query per row (the serving main path)
])
def test_mass_lookup_indexed_matches_jax_interpret(kd, n, b, m, block_m):
    rng = np.random.default_rng(kd + 10 * n + b)
    store, q = _f32(rng, n, kd, kd), _f32(rng, b, m, kd)
    rows = rng.integers(0, n, size=b).astype(np.int32)
    if b > n:
        assert len(set(rows.tolist())) < b
    _nonsymmetric(store)
    o_j = jax_ops.mass_lookup_indexed(jnp.asarray(store), jnp.asarray(rows),
                                      jnp.asarray(q), block_m=block_m,
                                      interpret=True)
    o_t = ops.mass_lookup_indexed(_t(store), _t(rows), _t(q),
                                  block_m=block_m)
    assert o_t.shape == (b, m, kd)
    # two fp32 sums of K unit-scale products in different orders differ by
    # up to about u·K·E|q c|: TOL holds to K = 128, K = 256 takes twice it
    tol = TOL * max(1, kd // 128)
    _close(o_t, o_j, tol)
    # the orientation: o[b] = q[b] store[rows[b]]ᵀ, not q store
    want = np.einsum("bkl,bml->bmk", store[rows], q)
    np.testing.assert_allclose(o_t.numpy(), want, rtol=tol, atol=tol)
    assert np.abs(want - q @ store[rows]).max() > 0.1


@pytest.mark.parametrize("kd", [32, 64, 100, 128, 256])
def test_mass_lookup_matches_jax_interpret(kd):
    rng = np.random.default_rng(kd)
    c, q = _f32(rng, 3, kd, kd), _f32(rng, 3, 4, kd)
    _nonsymmetric(c)
    o_j = jax_ops.mass_lookup(jnp.asarray(c), jnp.asarray(q),
                              interpret=True)
    o_t = ops.mass_lookup(_t(c), _t(q))
    _close(o_t, o_j)
    _close(o_t, jax_ref.mass_lookup_ref(jnp.asarray(c), jnp.asarray(q)))


@pytest.mark.parametrize("kd", [32, 100])
def test_refs_with_normaliser_match_jax(kd):
    rng = np.random.default_rng(5 + kd)
    n, b, m = 4, 6, 3
    store, q = _f32(rng, n, kd, kd), _f32(rng, b, m, kd)
    z = np.abs(_f32(rng, n, kd)) + 0.5
    q = np.abs(q) + 0.1                # keeps q·z away from the clamp
    rows = np.array([3, 0, 3, 1, 2, 0], np.int32)
    o_j = jax_ref.mass_lookup_indexed_ref(jnp.asarray(store),
                                          jnp.asarray(rows), jnp.asarray(q),
                                          z=jnp.asarray(z))
    o_t = ref.mass_lookup_indexed_ref(_t(store), _t(rows), _t(q), z=_t(z))
    _close(o_t, o_j)
    _close(ref.mass_lookup_ref(_t(store), _t(q[:n]), z=_t(z)),
           jax_ref.mass_lookup_ref(jnp.asarray(store), jnp.asarray(q[:n]),
                                   z=jnp.asarray(z)))
    # without z the indexed ref is the B4 kernel's function
    _close(ref.mass_lookup_indexed_ref(_t(store), _t(rows), _t(q)),
           jax_kernel.mass_lookup_indexed(jnp.asarray(store),
                                          jnp.asarray(rows), jnp.asarray(q),
                                          interpret=True))


# (100, 100): the paper's width; (128, 128): the LM's decode shape; (36,
# 50): a bulk-route state whose 200-byte rows are copied two at a time
@pytest.mark.parametrize("n,dk,dv", [(4, 64, 64), (3, 32, 48), (2, 100, 16),
                                     (2, 100, 100), (2, 128, 128),
                                     (3, 36, 50)])
def test_fused_decode_matches_jax_interpret(n, dk, dv):
    rng = np.random.default_rng(dk + dv)
    s, q, k, v = (_f32(rng, n, dk, dv), _f32(rng, n, dk), _f32(rng, n, dk),
                  _f32(rng, n, dv))
    o_j, s_j = jax_ops.fused_decode(*map(jnp.asarray, (s, q, k, v)),
                                    interpret=True)
    s_t = _t(s)
    o_t, s_out = ops.fused_decode(s_t, _t(q), _t(k), _t(v))
    assert s_out is s_t                          # updated in place
    assert o_t.shape == (n, dv)
    _close(o_t, o_j)
    _close(s_t, s_j)
    o_r, s_r = jax_ref.decode_ref(*map(jnp.asarray, (s, q, k, v)))
    _close(o_t, o_r)
    _close(s_t, s_r)


def test_fused_decode_state_is_one_rounded_multiply_and_add():
    """The state update the CUDA kernel reproduces bit for bit: each entry
    is fl(s + fl(k·v)), whatever the input type (bf16 inputs are widened
    to fp32 first); o comes back in v's type."""
    rng = np.random.default_rng(3)
    n, dk, dv = 3, 16, 24
    s = _t(_f32(rng, n, dk, dv))
    for dtype in (torch.float32, torch.bfloat16):
        q, k = (_t(_f32(rng, n, dk)).to(dtype) for _ in range(2))
        v = _t(_f32(rng, n, dv)).to(dtype)
        o, s_new = ref.decode_ref(s, q, k, v)
        prod = k.float()[:, :, None] * v.float()[:, None, :]
        assert torch.equal(s_new, s + prod)
        assert o.dtype == dtype and s_new.dtype == torch.float32
        torch.testing.assert_close(
            o.float(), torch.einsum("nkv,nk->nv", s_new, q.float()).to(
                dtype).float(), rtol=0, atol=0)


def _lookup_inputs(**bad):
    x = dict(c=torch.zeros(4, 32, 32), q=torch.zeros(6, 2, 32),
             rows=torch.zeros(6, dtype=torch.int32))
    x.update(bad)
    return x


@pytest.mark.parametrize("bad,err", [
    (dict(c=torch.zeros(4, 32, 32, dtype=torch.float64)), TypeError),
    (dict(q=torch.zeros(6, 2, 32, dtype=torch.bfloat16)), TypeError),
    (dict(q=torch.zeros(6, 2, 16)), ValueError),             # K mismatch
    (dict(c=torch.zeros(4, 32, 16)), ValueError),            # not K×K
    (dict(c=torch.zeros(4, 512, 512), q=torch.zeros(6, 2, 512)),
     ValueError),                                            # K > 256
    (dict(rows=torch.zeros(6, dtype=torch.int64)), ValueError),
    (dict(rows=torch.zeros(5, dtype=torch.int32)), ValueError),
    (dict(q=torch.zeros(6, 32, 2).transpose(1, 2)), ValueError),  # strided
    (dict(c=torch.zeros(4, 32, 32).transpose(1, 2)), ValueError),
])
def test_lookup_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    x = _lookup_inputs(**bad)
    with pytest.raises(err):
        ops._check_lookup("mass_lookup_indexed", x["c"], x["q"], x["rows"])


def _offset_view(shape, floats):
    """A contiguous float32 tensor of ``shape`` starting ``floats`` × 4
    bytes past an aligned allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + floats)[floats:].view(shape)


@pytest.mark.parametrize("kd,c_off,q_off,raises", [
    (64, 0, 0, False),     # the main path's store and queries
    (64, 1, 0, True),      # store 4 bytes off: no 16-byte bulk copy
    (66, 2, 0, True),      # 8 bytes off, K % 4 == 2
    (64, 0, 1, True),      # queries 4 bytes off
    (64, 0, 2, True),      # 8 bytes off: K % 4 == 0 reads 16-byte q
    (66, 0, 2, False),     # K % 4 == 2: 8-byte aligned queries are enough
    (33, 1, 1, False),     # odd K: the direct route reads any address
])
def test_bulk_route_alignment_check(kd, c_off, q_off, raises):
    c = _offset_view((4, kd, kd), c_off)
    q = _offset_view((4, 2, kd), q_off)
    assert c.is_contiguous() and q.is_contiguous()
    if raises:
        with pytest.raises(ValueError):
            ops._check_aligned("mass_lookup", c, q)
    else:
        ops._check_aligned("mass_lookup", c, q)


@pytest.mark.parametrize("dk,dv,route", [
    (100, 100, "bulk"),    # the paper's width
    (128, 128, "bulk"),    # the LM's decode shape
    (36, 50, "bulk"),      # Dv·4 not a multiple of 16, Dk·Dv is of 4
    (64, 17, "bulk"),      # Dv odd, Dk % 4 == 0
    (33, 17, "direct"),    # Dk·Dv odd
    (33, 50, "direct"),    # Dk·Dv % 4 == 2
    (256, 256, "direct"),  # 256 KiB: more than a block's shared memory
    (192, 256, "bulk"),    # 192 KiB: the largest resident state
])
def test_decode_route_by_shape(dk, dv, route):
    assert ops.decode_route(dk, dv) == route


@pytest.mark.parametrize("dk,dv,off,raises", [
    (64, 64, 0, False),    # aligned
    (64, 64, 1, True),     # 4 bytes off: no 16-byte bulk copy
    (36, 50, 2, True),     # 8 bytes off
    (33, 17, 1, False),    # the direct route reads any address
    (256, 256, 3, False),  # so does the direct route of a large state
])
def test_decode_bulk_route_alignment_check(dk, dv, off, raises):
    s = _offset_view((2, dk, dv), off)
    assert s.is_contiguous()
    if raises:
        with pytest.raises(ValueError):
            ops._check_decode_aligned(s)
    else:
        ops._check_decode_aligned(s)


def test_lookup_wrappers_accept_the_main_path_inputs():
    x = _lookup_inputs()
    ops._check_lookup("mass_lookup_indexed", x["c"], x["q"], x["rows"])
    ops._check_lookup("mass_lookup", x["c"], torch.zeros(4, 3, 32))
    with pytest.raises(ValueError):                # B5: one q row per state
        ops._check_lookup("mass_lookup", x["c"], x["q"])


@pytest.mark.parametrize("bad,err", [
    (dict(s=torch.zeros(2, 8, 4, dtype=torch.bfloat16)), TypeError),
    (dict(q=torch.zeros(2, 8, dtype=torch.float16),
          k=torch.zeros(2, 8, dtype=torch.float16),
          v=torch.zeros(2, 4, dtype=torch.float16)), TypeError),
    (dict(v=torch.zeros(2, 4, dtype=torch.bfloat16)), TypeError),
    (dict(v=torch.zeros(2, 8)), ValueError),                 # Dv mismatch
    (dict(s=torch.zeros(2, 300, 4), q=torch.zeros(2, 300),
          k=torch.zeros(2, 300)), ValueError),               # Dk > 256
    (dict(k=torch.zeros(8, 2).t()), ValueError),             # strided
])
def test_decode_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    x = dict(s=torch.zeros(2, 8, 4), q=torch.zeros(2, 8),
             k=torch.zeros(2, 8), v=torch.zeros(2, 4))
    x.update(bad)
    with pytest.raises(err):
        ops._check_decode(x["s"], x["q"], x["k"], x["v"])


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    before = (ops.mass_lookup.launches, ops.mass_lookup_indexed.launches,
              ops.fused_decode.launches)
    rng = np.random.default_rng(0)
    c, q = _t(_f32(rng, 2, 16, 16)), _t(_f32(rng, 2, 1, 16))
    ops.mass_lookup(c, q)
    ops.mass_lookup_indexed(c, torch.tensor([1, 1], dtype=torch.int32), q)
    ops.fused_decode(c.clone(), q[:, 0], q[:, 0], q[:, 0])
    assert (ops.mass_lookup.launches, ops.mass_lookup_indexed.launches,
            ops.fused_decode.launches) == before
