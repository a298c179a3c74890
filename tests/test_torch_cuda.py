"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs a CUDA device and skips without one. This
file imports neither JAX nor ``repro``, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.gated import gla_scan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_recurrent import ops, ref
from repro_torch.kernels.gated_linear_attention import ops as gla_ops
from repro_torch.kernels.gated_linear_attention import ref as gla_ref
from repro_torch.kernels.linear_attention import ops as la_ops
from repro_torch.kernels.linear_attention import ref as la_ref
from repro_torch.kernels.lookup import ops as lu_ops
from repro_torch.kernels.lookup import ref as lu_ref
from repro_torch.models import lm
from repro_torch.qa.gru import gru_params
from repro_torch.serving import LookupEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions are references: full fp32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows(dev, n, w, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    return dict(s=r(n, d, d), q=(r(n, w, d).abs() + 0.1).to(dtype),
                k=(r(n, w, d).abs() + 0.1).to(dtype), v=r(n, w, d).to(dtype),
                z=r(n, d).abs() + 0.5)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("varlen", [False, True])
def test_decode_linear_matches_plain_version(dev, d, dtype, normalize,
                                             varlen):
    n, w = 24, 5
    x = _rows(dev, n, w, d, dtype)
    lens = (torch.arange(n, dtype=torch.int32, device=dev) % (w + 1)
            if varlen else None)
    z = x["z"] if normalize else None
    o_r, s_r, z_r = ref.fused_recurrent_linear_ref(
        x["s"][:, None], x["q"][:, None], x["k"][:, None], x["v"][:, None],
        z=None if z is None else z[:, None], normalize=normalize, lens=lens)
    s = x["s"].clone()
    zk = None if z is None else z.clone()
    before = ops.decode_linear.launches
    o, s_out, z_out = ops.decode_linear(s, x["q"], x["k"], x["v"], z=zk,
                                        normalize=normalize, lens=lens)
    torch.cuda.synchronize()
    assert ops.decode_linear.launches == before + 1
    assert s_out is s and z_out is zk
    # the state update is the same multiply and add: same bits
    torch.testing.assert_close(s, s_r[:, 0], rtol=1e-5, atol=1e-6)
    if normalize:
        torch.testing.assert_close(zk, z_r[:, 0], rtol=1e-5, atol=1e-6)
    # o: fp32 sums in another order, then rounded to o's type
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_r[:, 0].float(), rtol=tol,
                               atol=tol)
    if varlen:
        idle = lens == 0
        assert torch.equal(s[idle], x["s"][idle])
        masked = torch.arange(w, device=dev)[None] >= lens[:, None]
        assert torch.count_nonzero(o[masked]) == 0


@pytest.mark.parametrize("d", [16, 128])
def test_decode_linear_denominator_clamp_matches_plain_version(dev, d):
    """Signed q, k, z (the identity feature map): the kernel's
    sign-preserving clamp of q·z against the plain version's, for
    q·z = 0 (-> +eps), q·z in (-eps, 0) (-> -eps), q·z of either sign
    beyond eps, and a NaN normaliser (-> NaN)."""
    n, w, eps = 24, 2, 1e-6
    g = torch.Generator(device=dev).manual_seed(3)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    s, v, z = r(n, d, d), r(n, w, d), r(n, d)
    q = r(n, 1, d).expand(n, w, d).contiguous()     # one q per row
    k = r(n, w, d)
    kind = torch.arange(n, device=dev) % 4
    k[kind != 2] = 0.0                  # z stays as given through W
    z[kind == 0] = 0.0                                  # q·z = 0
    q0 = q[:, 0]
    z[kind == 1] = (-1e-8 * q0 / (q0 * q0).sum(-1, keepdim=True))[kind == 1]
    z[kind == 3, 0] = float("nan")
    qz = (q0 * z).sum(-1)
    assert (qz[kind == 0] == 0).all()
    assert ((qz[kind == 1] < 0) & (qz[kind == 1] > -eps)).all()
    assert (qz[kind == 2] < -eps).any() and (qz[kind == 2] > eps).any()

    o_r, s_r, z_r = ref.fused_recurrent_linear_ref(
        s[:, None], q[:, None], k[:, None], v[:, None], z=z[:, None],
        normalize=True, eps=eps)
    o_r, s_r, z_r = o_r[:, 0], s_r[:, 0], z_r[:, 0]
    sk, zk = s.clone(), z.clone()
    o, _, _ = ops.decode_linear(sk, q, k, v, z=zk, normalize=True, eps=eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(sk, s_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(zk, z_r, rtol=1e-5, atol=1e-6, equal_nan=True)
    nan = kind == 3
    assert o[nan].isnan().all() and o_r[nan].isnan().all()
    # o = Sᵀq / denom: the numerators are fp32 sums taken in another
    # order, so hold each row to its own scale (|o| reaches ~1e7 at ±eps)
    scale = o_r.abs().amax(-1, keepdim=True)
    assert ((o[~nan] - o_r[~nan]).abs() <= 1e-4 * scale[~nan]).all()
    # the clamp keeps the sign: the -eps rows give -Sᵀq/eps, the +eps
    # rows +Sᵀq/eps
    num = torch.einsum("nkv,nk->nv", s_r, q0)
    for kd, sign in ((0, 1.0), (1, -1.0)):
        rows = kind == kd
        err = (o[rows, 1] - sign * num[rows] / eps).abs()
        assert (err <= 1e-4 * scale[rows, 1]).all()


def test_decode_linear_rejects_unsupported_inputs(dev):
    x = _rows(dev, 4, 2, 16, torch.float32)
    with pytest.raises(ValueError):
        ops.decode_linear(x["s"], x["q"].cpu(), x["k"], x["v"])
    with pytest.raises(TypeError):
        ops.decode_linear(x["s"], x["q"].half(), x["k"].half(),
                          x["v"].half())
    with pytest.raises(ValueError):
        ops.decode_linear(x["s"][:, :8, :8].contiguous(), x["q"][..., :8],
                          x["k"][..., :8], x["v"][..., :8])


def test_slice_through_kernel_matches_reference(dev):
    """Smoke config on the card: prefill, greedy generation and a varlen
    window through the kernel == the same through the plain recurrence."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              attention_backend="linear", dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (3, 20), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    for kernel in ("auto", "reference"):
        c = dataclasses.replace(cfg, decode_kernel=kernel)
        logits, st = lm.prefill(params, prompt, c)
        toks, st = lm.generate(params, st, torch.argmax(logits, -1), 20, 6, c)
        lg, st = lm.decode_window_varlen(
            params, st, prompt[:, :4], torch.tensor([26, 26, 26]),
            torch.tensor([4, 0, 2]), c)
        out[kernel] = (toks, lg, st["stack"][0].s, st["stack"][0].z)
    assert torch.equal(out["auto"][0], out["reference"][0])
    for a, b in zip(out["auto"][1:], out["reference"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- the gated decode kernel B7 ----------------------------------------------
# The state: the same separately rounded multiply and add as the plain
# version (bitwise where expf agrees), held within rtol 1e-6; o: fp32
# sums in another order, then rounded to o's type (B1's tolerances).

def _gated_rows(dev, n, w, d, dtype, decay, seed=0):
    """Positive q, k (the elu1 regime), signed v; the log-decay per row
    kind: mild, strong (≤ -5), zero, or scalar (one value per step,
    broadcast over Dk)."""
    x = _rows(dev, n, w, d, dtype, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    u = torch.rand((n, w, d), generator=g, device=dev)
    if decay == "mild":
        x["g"] = -u
    elif decay == "strong":
        x["g"] = -5.0 - 3.0 * u
    elif decay == "zero":
        x["g"] = torch.zeros_like(u)
    else:                                                # scalar
        x["g"] = (-u[..., :1]).expand(n, w, d).contiguous()
    return x


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("decay", ["mild", "strong", "zero", "scalar"])
def test_decode_gated_matches_plain_version(dev, d, dtype, varlen, decay):
    n, w = 24, 5
    x = _gated_rows(dev, n, w, d, dtype, decay)
    lens = (torch.arange(n, dtype=torch.int32, device=dev) % (w + 3)
            if varlen else None)                     # 0 .. W + 2
    o_r, s_r = ref.fused_recurrent_gated_ref(
        x["s"][:, None], x["q"][:, None], x["k"][:, None], x["v"][:, None],
        x["g"][:, None], lens=lens)
    s = x["s"].clone()
    before = ops.decode_gated.launches
    o, s_out = ops.decode_gated(s, x["q"], x["k"], x["v"], x["g"], lens=lens)
    torch.cuda.synchronize()
    assert ops.decode_gated.launches == before + 1
    assert s_out is s and o.dtype == dtype
    torch.testing.assert_close(s, s_r[:, 0], rtol=1e-6, atol=1e-6)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_r[:, 0].float(), rtol=tol,
                               atol=tol)
    if varlen:
        idle = lens == 0
        assert torch.equal(s[idle], x["s"][idle])
        masked = torch.arange(w, device=dev)[None] >= lens[:, None]
        assert torch.count_nonzero(o[masked]) == 0


def test_decode_gated_rejects_unsupported_inputs(dev):
    x = _gated_rows(dev, 4, 2, 16, torch.bfloat16, "mild")
    with pytest.raises(ValueError):                          # g not fp32
        ops.decode_gated(x["s"], x["q"], x["k"], x["v"], x["g"].bfloat16())
    with pytest.raises(ValueError):                          # g on the CPU
        ops.decode_gated(x["s"], x["q"], x["k"], x["v"], x["g"].cpu())
    with pytest.raises(ValueError):                          # lens shape
        ops.decode_gated(x["s"], x["q"], x["k"], x["v"], x["g"],
                         lens=torch.zeros(3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):                          # strided g
        ops.decode_gated(x["s"], x["q"], x["k"], x["v"],
                         x["g"].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError):                           # mixed types
        ops.decode_gated(x["s"], x["q"].float(), x["k"], x["v"], x["g"])


def test_gated_slice_through_kernel_matches_reference(dev):
    """Smoke config, gated_linear, on the card: prefill, greedy generation
    and a varlen window through B7 == the same through the plain
    recurrence; the gated state has no z."""
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend("gated_linear"),
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (3, 20), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    for kernel in ("auto", "reference"):
        c = dataclasses.replace(cfg, decode_kernel=kernel)
        before = ops.decode_gated.launches
        logits, st = lm.prefill(params, prompt, c)
        toks, st = lm.generate(params, st, torch.argmax(logits, -1), 20, 6, c)
        lg, st = lm.decode_window_varlen(
            params, st, prompt[:, :4], torch.tensor([26, 26, 26]),
            torch.tensor([4, 0, 2]), c)
        launched = ops.decode_gated.launches - before
        assert launched == (7 * cfg.n_layers if kernel == "auto" else 0)
        assert st["stack"][0].z is None
        out[kernel] = (toks, lg, st["stack"][0].s)
    assert torch.equal(out["auto"][0], out["reference"][0])
    for a, b in zip(out["auto"][1:], out["reference"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- the lookup kernels B4, B5, B6 ------------------------------------------
# States are drawn non-symmetric (a transposed read of C would show).
# Outputs: rtol = atol = 1e-4, fp32 sums in another order (the JAX kernel
# tests' tolerance); B6's state: bitwise.

def _randn(dev, seed, *shape):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev)


@pytest.mark.parametrize("n,b,m,kd,block_m", [
    (16384, 256, 1, 64, None),  # the lookup main path's wave
    (64, 32, 4, 100, None),     # the paper's width, M = PAPER_M
    (16, 8, 5, 64, 4),          # M tiling with padding
    (4, 24, 3, 32, None),       # duplicate rows (b > n)
    (32, 16, 2, 128, None),
])
def test_mass_lookup_indexed_matches_plain_version(dev, n, b, m, kd,
                                                   block_m):
    store = _randn(dev, 0, n, kd, kd)
    assert (store - store.mT).abs().max() > 0.1
    rows = torch.randint(0, n, (b,), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    rows[-1] = rows[0]                              # at least one repeat
    q = _randn(dev, 2, b, m, kd)
    before = lu_ops.mass_lookup_indexed.launches
    o = lu_ops.mass_lookup_indexed(store, rows, q, block_m=block_m)
    torch.cuda.synchronize()
    assert lu_ops.mass_lookup_indexed.launches == before + 1
    assert o.shape == (b, m, kd)
    torch.testing.assert_close(o, lu_ref.mass_lookup_indexed_ref(store, rows,
                                                                 q),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kd", [64, 100, 256])
def test_mass_lookup_matches_plain_version(dev, kd):
    c, q = _randn(dev, 3, 6, kd, kd), _randn(dev, 4, 6, 5, kd)
    before = lu_ops.mass_lookup.launches
    o = lu_ops.mass_lookup(c, q)
    torch.cuda.synchronize()
    assert lu_ops.mass_lookup.launches == before + 1
    torch.testing.assert_close(o, lu_ref.mass_lookup_ref(c, q), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dk,dv", [(64, 64), (100, 48), (32, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_decode_matches_plain_version(dev, dk, dv, dtype):
    n = 12
    s = _randn(dev, 5, n, dk, dv)
    q, k = (_randn(dev, i, n, dk).to(dtype) for i in (6, 7))
    v = _randn(dev, 8, n, dv).to(dtype)
    o_r, s_r = lu_ref.decode_ref(s, q, k, v)
    s_k = s.clone()
    o, s_out = lu_ops.fused_decode(s_k, q, k, v)
    torch.cuda.synchronize()
    assert s_out is s_k and o.dtype == dtype
    assert torch.equal(s_k, s_r)                    # bitwise
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_r.float(), rtol=tol, atol=tol)


def test_lookup_wrappers_reject_unsupported_inputs(dev):
    store, q = _randn(dev, 0, 4, 32, 32), _randn(dev, 1, 6, 2, 32)
    rows = torch.zeros(6, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        lu_ops.mass_lookup_indexed(store.double(), rows, q.double())
    with pytest.raises(ValueError):                          # int64 rows
        lu_ops.mass_lookup_indexed(store, rows.long(), q)
    with pytest.raises(ValueError):                          # K mismatch
        lu_ops.mass_lookup_indexed(store, rows, q[..., :16].contiguous())
    with pytest.raises(ValueError):                          # strided
        lu_ops.mass_lookup_indexed(store.mT, rows, q)
    with pytest.raises(ValueError):                          # rows on CPU
        lu_ops.mass_lookup_indexed(store, rows.cpu(), q)
    with pytest.raises(ValueError):
        lu_ops.mass_lookup(store, q)                         # B != N
    s = _randn(dev, 2, 3, 8, 4)
    with pytest.raises(TypeError):
        lu_ops.fused_decode(s, *(torch.zeros(3, d, device=dev).half()
                                 for d in (8, 8, 4)))
    with pytest.raises(ValueError):
        lu_ops.fused_decode(s, torch.zeros(3, 8, device=dev),
                            torch.zeros(8, 3, device=dev).t(),
                            torch.zeros(3, 4, device=dev))


def test_lookup_engine_two_waves_through_kernel_match_plain(dev):
    """Ingest, then two waves of mixed-memory requests of 1-4 queries
    through B4 against the same through ``use_kernel=False``."""
    g = torch.Generator(device=dev).manual_seed(0)
    encoder = {"embed": torch.randn((100, 16), generator=g, device=dev),
               "gru": gru_params(g, 16, 64)}
    rng = np.random.default_rng(0)
    docs = {f"d{i}": rng.integers(0, 100, size=20 + 9 * i) for i in range(8)}
    reqs = [(f"d{i % 8}", rng.standard_normal((1 + i % 4, 64)), i % 3)
            for i in range(32)]
    out = {}
    for use_kernel in (None, False):
        eng = LookupEngine(encoder, normalize=True, wave_size=16,
                           use_kernel=use_kernel, device=dev)
        for d, toks in docs.items():
            eng.ingest(d, toks)
        for d, q, p in reqs:
            eng.submit(d, q, priority=p)
        before = lu_ops.mass_lookup_indexed.launches
        results = eng.run()
        launched = lu_ops.mass_lookup_indexed.launches - before
        assert eng.stats.waves == 2 and eng.stats.multi_memory_waves == 2
        assert launched == (2 if use_kernel is None else 0)
        out[use_kernel] = (eng.store, results)
    for key in out[None][0]:
        assert torch.equal(out[None][0][key], out[False][0][key])
    for a, b in zip(out[None][1], out[False][1]):
        assert a.uid == b.uid and a.wave == b.wave
        np.testing.assert_allclose(a.answers, b.answers, rtol=1e-4,
                                   atol=1e-4)


# -- the chunked linear attention B2 and its backward B3 ----------------------
# Normwise: max|Δ| within TOL · max|plain| — fp32 sums of up to T·D terms in
# another order (1e-5), or the same fp32 sums rounded to bf16 (8e-3, two
# bf16 ulps of the largest element).

LA_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _la_rows(dev, bh, t, d, dtype, seed=0):
    """q, k positive (the model's elu1 feature map), v and do signed."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda: torch.randn((bh, t, d), generator=g, device=dev)
    elu1 = lambda x: torch.nn.functional.elu(x) + 1.0
    return [x.to(dtype) for x in (elu1(r()), elu1(r()), r(), r())]


def _assert_normwise(x, want, tol, what):
    err = (x.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= tol * scale, f"{what}: max|Δ| {err} > {tol} × {scale}"


# (rows, T, D, dtype, chunk): the training main path's shape, a T that is
# a multiple of the chunk but not of the kernels' tile (32 tokens on fp32
# FMAs, 64 for bf16 B2 and B3 on the tensor cores), a ragged T (the chunk
# drops to T), the smoke width. The reference state is far from
# symmetric, so that a transposed state would show.
@pytest.mark.parametrize("bh,t,d,dtype,chunk", [
    (128, 1024, 128, torch.bfloat16, 128),
    (6, 272, 128, torch.float32, 16),
    (6, 48, 16, torch.float32, 16),
    (6, 48, 16, torch.bfloat16, 16),
    (6, 272, 128, torch.bfloat16, 16),
    (4, 75, 128, torch.bfloat16, 75),
    (6, 48, 128, torch.bfloat16, 16),
    (6, 200, 128, torch.bfloat16, 40),
    (6, 272, 16, torch.bfloat16, 16),
    (4, 75, 16, torch.bfloat16, 75),
    (6, 200, 16, torch.bfloat16, 40),
])
def test_linear_attention_kernels_match_plain_versions(dev, bh, t, d, dtype,
                                                       chunk):
    q, k, v, do = _la_rows(dev, bh, t, d, dtype)
    before = (la_ops.fwd.launches, la_ops.bwd_dq.launches,
              la_ops.bwd_dkv.launches)
    o, s = la_ops.fwd(q, k, v, chunk=chunk)
    dq, dk, dv = la_ops.bwd(q, k, v, do, chunk=chunk)
    torch.cuda.synchronize()
    assert (la_ops.fwd.launches, la_ops.bwd_dq.launches,
            la_ops.bwd_dkv.launches) == tuple(n + 1 for n in before)
    o_r, s_r = la_ref.chunked_fwd_ref(q, k, v, chunk=chunk)
    grads_r = la_ref.chunked_bwd_ref(q, k, v, do, chunk=chunk)
    assert o.dtype == dtype and s.dtype == torch.float32
    assert (s_r - s_r.mT).abs().max() > 0.01 * s_r.abs().max()
    tol = LA_TOL[dtype]
    _assert_normwise(o, o_r, tol, "o")
    _assert_normwise(s, s_r, LA_TOL[torch.float32], "state")
    for name, x, x_r in zip(("dq", "dk", "dv"), (dq, dk, dv), grads_r):
        assert x.dtype == dtype
        _assert_normwise(x, x_r, tol, name)


def _cuda_kernel_names(fn):
    """The names of the CUDA kernels that ``fn`` ran, from torch.profiler
    (as chip_smoke.py's step profiles read them). The capture window gets
    20 ms of idle margin on each side: a kernel of a few microseconds at
    its very edge is sometimes dropped from the trace, which then reads
    as no launch."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        torch.cuda.synchronize()
        time.sleep(0.02)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return [e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("d", [16, 128])
def test_linear_attention_bf16_fwd_runs_on_the_tensor_cores(dev, d):
    """A bf16 ``ops.fwd`` on CUDA launches B2's tensor-core kernel,
    ``linear_sweep_fwd_tc``, and never the FMA body ``sweep_kernel``; an
    fp32 one the FMA body."""
    q, k, v, _ = _la_rows(dev, 4, 200, d, torch.bfloat16, seed=3)
    la_ops.fwd(q, k, v, chunk=40)           # the library built and loaded
    names = _cuda_kernel_names(lambda: la_ops.fwd(q, k, v, chunk=40))
    assert any("linear_sweep_fwd_tc" in n for n in names), names
    assert not any("sweep_kernel" in n for n in names), names
    q, k, v = (x.float() for x in (q, k, v))
    names = _cuda_kernel_names(lambda: la_ops.fwd(q, k, v, chunk=40))
    assert any("sweep_kernel" in n for n in names), names
    assert not any("linear_sweep" in n for n in names), names


@pytest.mark.parametrize("bh,t,d,dtype,chunk", [
    (6, 272, 128, torch.bfloat16, 16), (4, 75, 16, torch.bfloat16, 75),
    (6, 200, 128, torch.float32, 40), (6, 48, 16, torch.float32, 16)])
def test_linear_attention_bwd_launches_match_their_plain_versions(
        dev, bh, t, d, dtype, chunk):
    """B3's two launches, each on its own: the dq launch against
    ``chunked_bwd_dq_ref``, the dk/dv launch against
    ``chunked_bwd_dkv_ref``; normwise 1e-5 in fp32, 8e-3 in bf16."""
    q, k, v, do = _la_rows(dev, bh, t, d, dtype, seed=5)
    before = (la_ops.bwd_dq.launches, la_ops.bwd_dkv.launches)
    dq = la_ops.bwd_dq(k, v, do, chunk=chunk)
    assert (la_ops.bwd_dq.launches, la_ops.bwd_dkv.launches) == (
        before[0] + 1, before[1])
    dk, dv = la_ops.bwd_dkv(q, k, v, do, chunk=chunk)
    torch.cuda.synchronize()
    assert (la_ops.bwd_dq.launches, la_ops.bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = (la_ref.chunked_bwd_dq_ref(k, v, do, chunk=chunk),
            *la_ref.chunked_bwd_dkv_ref(q, k, v, do, chunk=chunk))
    for name, x, x_r in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert x.dtype == dtype and x.shape == q.shape, name
        _assert_normwise(x, x_r, LA_TOL[dtype], name)


@pytest.mark.parametrize("t,d,dtype", [(40, 16, torch.float32),
                                       (200, 128, torch.float32),
                                       (200, 128, torch.bfloat16)])
def test_linear_attention_wrapper_pads_like_jax(dev, t, d, dtype):
    """(B, H, T, D) with T not a multiple of the chunk: the wrapper pads,
    the kernels run, and o, the state and the gradients match the plain
    route of the same wrapper."""
    q, k, v, do = (x.reshape(2, 3, t, d) for x in _la_rows(dev, 6, t, d,
                                                             dtype, seed=1))
    chunk = 16 if d == 16 else 128
    out = {}
    for kernel in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = la_ops.linear_attention(*leaves, chunk=chunk, kernel=kernel)
        o.backward(do)
        o_s, s = la_ops.linear_attention_with_state(q, k, v, chunk=chunk,
                                                    kernel=kernel)
        assert torch.equal(o_s, o.detach()) and s.shape == (2, 3, d, d)
        out[kernel] = [o.detach(), s] + [x.grad for x in leaves]
    tol = LA_TOL[dtype]
    for name, a, b in zip(("o", "s", "dq", "dk", "dv"), out[True],
                          out[False]):
        _assert_normwise(a, b, LA_TOL[torch.float32] if name == "s" else tol,
                         name)


def test_linear_attention_function_grads_match_autograd_of_direct_form(dev):
    """The autograd function (B2 forward, B3 backward) against autograd
    through the quadratic direct form, fp32, small T."""
    q, k, v, do = (x.reshape(1, 4, 37, 16) for x in _la_rows(
        dev, 4, 37, 16, torch.float32, seed=2))
    got, want = [], []
    for fn, sink in ((lambda a, b, c: la_ops.linear_attention(
            a, b, c, chunk=16), got), (lambda a, b, c: la_ref
            .linear_attention_ref(a[0], b[0], c[0])[0][None], want)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        sink.extend([o.detach()] + [x.grad for x in leaves])
    for a, b in zip(got, want):
        _assert_normwise(a, b, LA_TOL[torch.float32], "grad")


def test_linear_attention_rejects_unsupported_inputs(dev):
    q, k, v, do = _la_rows(dev, 2, 32, 16, torch.float32)
    with pytest.raises(ValueError):                       # D = 8
        la_ops.fwd(q[..., :8].contiguous(), k[..., :8].contiguous(),
                   v[..., :8].contiguous(), chunk=16)
    with pytest.raises(ValueError):                       # T % chunk
        la_ops.fwd(q, k, v, chunk=24)
    with pytest.raises(ValueError):                       # mixed types
        la_ops.bwd(q, k, v.bfloat16(), do, chunk=16)
    with pytest.raises(ValueError):                       # strided
        la_ops.fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                   chunk=16)
    with pytest.raises(TypeError):
        la_ops.fwd(q.half(), k.half(), v.half(), chunk=16)
    with pytest.raises(ValueError):                       # CPU and CUDA
        la_ops.fwd(q, k.cpu(), v, chunk=16)


def test_training_slice_through_kernels_matches_plain_route(dev):
    """Two layers at qwen3-0.6b's full widths, fp32: the loss and every
    gradient leaf through B2/B3 against the same through the plain
    versions (``attention_kernel=False``); B2 twice per layer under
    remat, B3 once."""
    from repro_torch.configs import get_config
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen3-0.6b").with_backend("linear"),
                              n_layers=2, dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device=dev, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = leaves(params)
    for x in flat:
        x.requires_grad_()
    out = {}
    for kernel in (True, False):
        before = (la_ops.fwd.launches, la_ops.bwd_dq.launches)
        loss, _ = lm.lm_loss(params, batch, cfg, attention_kernel=kernel)
        grads = torch.autograd.grad(loss, flat)
        launched = (la_ops.fwd.launches - before[0],
                    la_ops.bwd_dq.launches - before[1])
        assert launched == ((4, 2) if kernel else (0, 0))
        out[kernel] = (loss.detach(), grads)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-5,
                               atol=0.0)
    for a, b in zip(out[True][1], out[False][1]):
        _assert_normwise(a, b, 1e-4, "gradient leaf")


def _gla_rows(dev, bh, t, d, dtype, decay, seed=0):
    """q, k positive (elu1), v and do signed; g fp32: the model's
    operating point (about -0.002), mild ([-0.6, 0] with entries past the
    clamp) or the clamp itself (-1 everywhere)."""
    q, k, v, do = _la_rows(dev, bh, t, d, dtype, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    u = torch.rand((bh, t, d), generator=gen, device=dev)
    g = {"model": -0.004 * u, "mild": torch.where(u < 0.03, -1.5, -0.6 * u),
         "clamp": torch.full_like(u, -1.0)}[decay.split("_")[0]]
    if decay.endswith("_head"):         # per-head: one value per token
        g = g[..., :1].expand(bh, t, d).contiguous()
    return q, k, v, do, g


def _gla_counts():
    return (gla_ops.fwd.launches, gla_ops.bwd_dq.launches,
            gla_ops.bwd_dkv.launches)


# (rows, T, D, dtype, chunk, decay): the training main path's shape, a T
# that is a multiple of the chunk but not of the kernels' tile (32 tokens
# in fp32, 64 in bf16), the smoke width, a ragged T (the chunk drops to
# T), a per-head decay
@pytest.mark.parametrize("bh,t,d,dtype,chunk,decay", [
    (128, 1024, 128, torch.bfloat16, 128, "model"),
    (6, 272, 128, torch.float32, 16, "mild"),
    (6, 48, 16, torch.float32, 16, "mild"),
    (6, 48, 16, torch.bfloat16, 16, "mild"),
    (4, 75, 128, torch.float32, 75, "mild"),
    (6, 272, 128, torch.bfloat16, 16, "mild"),
    (6, 48, 128, torch.bfloat16, 16, "mild"),
    (4, 75, 128, torch.bfloat16, 75, "mild"),
    (4, 75, 16, torch.bfloat16, 75, "mild"),
    (6, 200, 128, torch.bfloat16, 40, "mild_head"),
    (6, 200, 16, torch.bfloat16, 40, "mild"),
    (6, 272, 16, torch.bfloat16, 16, "mild_head"),
    (6, 272, 128, torch.bfloat16, 16, "model"),
    (6, 48, 128, torch.bfloat16, 16, "model"),
    (4, 75, 16, torch.bfloat16, 75, "model"),
    (6, 200, 16, torch.bfloat16, 40, "model"),
])
def test_gated_linear_attention_kernels_match_plain_versions(
        dev, bh, t, d, dtype, chunk, decay):
    """B8 (inclusive; exclusive with the bonus u) and B9 against their
    plain versions: normwise 1e-5 in fp32, 8e-3 in bf16; the final state
    within 1e-5 on both routes, and far from symmetric, so that a
    transposed state would show."""
    q, k, v, do, g = _gla_rows(dev, bh, t, d, dtype, decay)
    u = torch.linspace(-1.0, 1.0, d, device=dev)
    before = _gla_counts()
    o, s = gla_ops.fwd(q, k, v, g, chunk=chunk)
    o_x, s_x = gla_ops.fwd(q, k, v, g, u=u, chunk=chunk, exclusive=True)
    grads = gla_ops.bwd(q, k, v, g, do, chunk=chunk)
    torch.cuda.synchronize()
    assert _gla_counts() == (before[0] + 2, before[1] + 1, before[2] + 1)
    tol = LA_TOL[dtype]
    o_r, s_r = gla_ref.chunked_fwd_ref(q, k, v, g, chunk=chunk)
    o_xr, s_xr = gla_ref.chunked_fwd_ref(q, k, v, g, u=u, chunk=chunk,
                                         exclusive=True)
    grads_r = gla_ref.chunked_bwd_ref(q, k, v, g, do, chunk=chunk)
    assert o.dtype == dtype and s.dtype == torch.float32
    assert o_x.dtype == dtype and s_x.dtype == torch.float32
    assert (s_r - s_r.mT).abs().max() > 0.01 * s_r.abs().max()
    for name, x, x_r in zip(("o", "s", "o excl", "s excl"),
                            (o, s, o_x, s_x), (o_r, s_r, o_xr, s_xr)):
        _assert_normwise(x, x_r, LA_TOL[torch.float32] if "s" in name
                         else tol, name)
    for name, x, x_r in zip(("dq", "dk", "dv", "dg"), grads, grads_r):
        assert x.dtype == x_r.dtype, name
        _assert_normwise(x, x_r, tol, name)


def test_gated_kernels_at_the_clamp_match_the_scan(dev):
    """g ≡ −1, T = 1,024, chunk 128, fp32: the chunk-wide plain versions
    overflow (NaN, as JAX's do); B8 and B9 rescale within 32-token tiles,
    stay finite and match ``gla_scan`` and its autograd gradients."""
    q, k, v, do, g = (x.reshape(1, 2, 1024, 128) for x in _gla_rows(
        dev, 2, 1024, 128, torch.float32, "clamp", seed=3))
    got, want = [], []
    for fn, sink in ((lambda a, b, c, e: gla_ops.gated_linear_attention(
            a, b, c, e, chunk=128), got),
            (lambda a, b, c, e: gla_scan(a, b, c, e)[0], want)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v, g)]
        o = fn(*leaves)
        o.backward(do)
        sink.extend([o.detach()] + [x.grad for x in leaves])
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg"), got, want):
        assert torch.isfinite(a).all(), name
        _assert_normwise(a, b, LA_TOL[torch.float32], name)
    o_plain = gla_ops.gated_linear_attention(q, k, v, g, chunk=128,
                                             kernel=False)
    assert torch.isnan(o_plain).any()


@pytest.mark.parametrize("bh,t,d,dtype,chunk", [
    (6, 272, 128, torch.bfloat16, 16), (4, 75, 16, torch.bfloat16, 75),
    (6, 200, 128, torch.float32, 40), (6, 48, 16, torch.float32, 16)])
def test_gated_bwd_launches_match_their_plain_versions(dev, bh, t, d, dtype,
                                                       chunk):
    """B9's two launches on their own: the dq launch's (dq, q⊙dq) against
    ``bwd_dq_ref``, the dk/dv launch's (dk, dv) against ``bwd_dkv_dg_ref``
    given the same q⊙dq, and its dg too in fp32; normwise 1e-5 in fp32,
    8e-3 in bf16. In bf16 the dq launch's q⊙dq carries the rounding of Q̂
    that only the same pair's k⊙dk cancels, so bf16 dg is held to its
    plain version through both launches
    (``test_gated_linear_attention_kernels_match_plain_versions``)."""
    q, k, v, do, g = _gla_rows(dev, bh, t, d, dtype, "mild", seed=5)
    before = _gla_counts()
    dq, qdq = gla_ops.bwd_dq(q, k, v, g, do, chunk=chunk)
    dk, dv, dg = gla_ops.bwd_dkv(q, k, v, g, do, qdq, chunk=chunk)
    torch.cuda.synchronize()
    assert _gla_counts() == (before[0], before[1] + 1, before[2] + 1)
    tol = LA_TOL[dtype]
    dq_r, qdq_r = gla_ref.bwd_dq_ref(q, k, v, g, do, chunk=chunk)
    want = gla_ref.bwd_dkv_dg_ref(q, k, v, g, do, qdq, chunk=chunk)
    for name, x, x_r in zip(("dq", "q⊙dq", "dk", "dv", "dg"),
                            (dq, qdq, dk, dv, dg), (dq_r, qdq_r) + want):
        assert x.dtype == x_r.dtype, name
        if name != "dg" or dtype == torch.float32:
            _assert_normwise(x, x_r, tol, name)


def test_gated_bf16_kernels_at_the_clamp_match_the_scan(dev):
    """g ≡ −1, T = 1,024, chunk 128, bf16: B8 and B9 (in 64-token tiles,
    |b| <= 64) stay finite and match ``gla_scan`` and its autograd,
    evaluated in fp32 on the same bf16 values, within normwise 8e-3."""
    q, k, v, do, g = (x.reshape(1, 2, 1024, 128) for x in _gla_rows(
        dev, 2, 1024, 128, torch.bfloat16, "clamp", seed=3))
    got, want = [], []
    for fn, sink, dtype in ((lambda a, b, c, e: gla_ops.gated_linear_attention(
            a, b, c, e, chunk=128), got, torch.bfloat16),
            (lambda a, b, c, e: gla_scan(a, b, c, e)[0], want, torch.float32)):
        leaves = [x.to(dtype).clone().requires_grad_() for x in (q, k, v, g)]
        o = fn(*leaves)
        o.backward(do.to(dtype))
        sink.extend([o.detach()] + [x.grad for x in leaves])
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg"), got, want):
        assert torch.isfinite(a).all(), name
        _assert_normwise(a, b, LA_TOL[torch.bfloat16], name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gated_kernels_at_the_decay_limit_match_the_scan(dev, dtype):
    """g ≡ min_log_decay = the route's limit (bf16 −1.25 over 64-token
    tiles, |b| <= 80; fp32 −1.5 over 32), T = 1,024, chunk 128: B8 and B9
    stay finite and match ``gla_scan`` and its autograd in fp32, within
    the clamp tests' tolerances (8e-3 bf16, 1e-5 fp32)."""
    lo = gla_ops.DECAY_LIMIT[dtype]
    q, k, v, do, g = (x.reshape(1, 2, 1024, 128) for x in _gla_rows(
        dev, 2, 1024, 128, dtype, "clamp", seed=3))
    g = g * -lo
    got, want = [], []
    for fn, sink, cast in ((lambda a, b, c, e: gla_ops.gated_linear_attention(
            a, b, c, e, chunk=128, min_log_decay=lo), got, dtype),
            (lambda a, b, c, e: gla_scan(a, b, c, e)[0], want, torch.float32)):
        leaves = [x.to(cast).clone().requires_grad_() for x in (q, k, v, g)]
        o = fn(*leaves)
        o.backward(do.to(cast))
        sink.extend([o.detach()] + [x.grad for x in leaves])
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg"), got, want):
        assert torch.isfinite(a).all(), name
        _assert_normwise(a, b, LA_TOL[dtype], name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gated_kernels_refuse_a_min_log_decay_past_the_limit(dev, dtype):
    """A CUDA call of fwd, bwd_dq or bwd_dkv with min_log_decay just past
    its route's limit raises ValueError; the CPU route (JAX's semantics)
    takes it."""
    q, k, v, do, g = _gla_rows(dev, 2, 64, 16, dtype, "mild")
    past = gla_ops.DECAY_LIMIT[dtype] - 1e-3
    qdq = torch.zeros_like(g)
    with pytest.raises(ValueError, match="min_log_decay"):
        gla_ops.fwd(q, k, v, g, chunk=16, min_log_decay=past)
    with pytest.raises(ValueError, match="min_log_decay"):
        gla_ops.bwd_dq(q, k, v, g, do, chunk=16, min_log_decay=past)
    with pytest.raises(ValueError, match="min_log_decay"):
        gla_ops.bwd_dkv(q, k, v, g, do, qdq, chunk=16, min_log_decay=past)
    o, _ = gla_ops.fwd(q.cpu(), k.cpu(), v.cpu(), g.cpu(), chunk=16,
                       min_log_decay=past)
    assert torch.isfinite(o).all()


def test_gated_bf16_backward_runs_no_pytorch_epilogue(dev, monkeypatch):
    """On the CUDA bf16 route ``ops.bwd`` forms dg inside the dk/dv launch:
    the eager epilogue, flip and cumsum are never called."""
    q, k, v, do, g = _gla_rows(dev, 4, 200, 128, torch.bfloat16, "mild")

    def refuse(*args, **kwargs):
        raise AssertionError("an eager dg epilogue ran")
    for target, name in ((gla_ref, "dg_epilogue"), (gla_ref, "dg_from_qdq"),
                         (torch, "flip"), (torch, "cumsum")):
        monkeypatch.setattr(target, name, refuse)
    dq, dk, dv, dg = gla_ops.bwd(q, k, v, g, do, chunk=40)
    monkeypatch.undo()
    torch.cuda.synchronize()
    _assert_normwise(dg, gla_ref.chunked_bwd_ref(q, k, v, g, do,
                                                 chunk=40)[3],
                     LA_TOL[torch.bfloat16], "dg")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gated_bwd_output_types(dev, dtype):
    """dq, dk, dv in the inputs' type and dg in g's (fp32), on each route;
    the dq launch's q⊙dq in fp32; shapes those of the inputs."""
    q, k, v, do, g = _gla_rows(dev, 3, 64, 16, dtype, "mild")
    grads = gla_ops.bwd(q, k, v, g, do, chunk=16)
    assert [x.dtype for x in grads] == [dtype, dtype, dtype, torch.float32]
    assert all(x.shape == q.shape for x in grads)
    _, qdq = gla_ops.bwd_dq(q, k, v, g, do, chunk=16)
    assert qdq.dtype == torch.float32 and qdq.shape == q.shape


@pytest.mark.parametrize("t,d,dtype,scalar", [(40, 16, torch.float32, False),
                                              (200, 128, torch.float32, True),
                                              (200, 128, torch.bfloat16,
                                               False)])
def test_gated_linear_attention_wrapper_pads_like_jax(dev, t, d, dtype,
                                                      scalar):
    """(B, H, T, D) with T not a multiple of the chunk, vector or per-head
    decay: the wrapper pads, the kernels run, and o and the four
    gradients match the plain route of the same wrapper;
    ``rwkv6_attention``'s o and state too."""
    q, k, v, do, g = (x.reshape(2, 3, t, d) for x in _gla_rows(
        dev, 6, t, d, dtype, "mild", seed=1))
    if scalar:
        g = g[..., :1].contiguous()
    chunk = 16 if d == 16 else 128
    u = torch.linspace(-1.0, 1.0, d, device=dev)
    out = {}
    for kernel in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v, g)]
        o = gla_ops.gated_linear_attention(*leaves, chunk=chunk,
                                           kernel=kernel)
        o.backward(do)
        o_x, s_x = gla_ops.rwkv6_attention(q, k, v, g, u, chunk=chunk,
                                           kernel=kernel)
        out[kernel] = [o.detach()] + [x.grad for x in leaves] + [o_x, s_x]
    tol = LA_TOL[dtype]
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg", "o excl", "s excl"),
                          out[True], out[False]):
        _assert_normwise(a, b, LA_TOL[torch.float32] if name == "s excl"
                         else tol, name)


def test_gated_linear_attention_rejects_unsupported_inputs(dev):
    q, k, v, do, g = _gla_rows(dev, 2, 32, 16, torch.float32, "mild")
    cut = lambda x: x[..., :8].contiguous()            # noqa: E731
    with pytest.raises(ValueError):                       # D = 8
        gla_ops.fwd(cut(q), cut(k), cut(v), cut(g), chunk=16)
    with pytest.raises(ValueError):                       # D = 8, backward
        gla_ops.bwd(cut(q), cut(k), cut(v), cut(g), cut(do), chunk=16)
    with pytest.raises(ValueError):                       # T % chunk
        gla_ops.fwd(q, k, v, g, chunk=24)
    with pytest.raises(ValueError):                       # mixed types
        gla_ops.bwd(q, k, v.bfloat16(), g, do, chunk=16)
    with pytest.raises(ValueError):                       # g not fp32
        gla_ops.fwd(q, k, v, g.bfloat16(), chunk=16)
    with pytest.raises(ValueError):                       # strided
        gla_ops.fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, g,
                    chunk=16)
    with pytest.raises(TypeError):
        gla_ops.fwd(q.half(), k.half(), v.half(), g, chunk=16)
    with pytest.raises(ValueError):                       # CPU and CUDA
        gla_ops.fwd(q, k, v, g.cpu(), chunk=16)
    with pytest.raises(ValueError):                       # u of another D
        gla_ops.fwd(q, k, v, g, u=torch.zeros(8, device=dev), chunk=16,
                    exclusive=True)


def test_gated_training_slice_through_kernels_matches_plain_route(dev):
    """Two layers at qwen3-0.6b's full widths under ``gated_linear``,
    fp32: the loss and every gradient leaf through B8/B9 against the same
    through the plain versions (``attention_kernel=False``); B8 twice per
    layer under remat, B9 once."""
    from repro_torch.configs import get_config
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").with_backend("gated_linear"), n_layers=2,
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device=dev, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = leaves(params)
    for x in flat:
        x.requires_grad_()
    out = {}
    for kernel in (True, False):
        before = _gla_counts()
        loss, _ = lm.lm_loss(params, batch, cfg, attention_kernel=kernel)
        grads = torch.autograd.grad(loss, flat)
        launched = tuple(a - b for a, b in zip(_gla_counts(), before))
        assert launched == ((4, 2, 2) if kernel else (0, 0, 0))
        out[kernel] = (loss.detach(), grads)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-5,
                               atol=0.0)
    for a, b in zip(out[True][1], out[False][1]):
        _assert_normwise(a, b, 1e-4, "gradient leaf")


# -- the causal flash-attention forward B10 ----------------------------------
# fp32: the plain version's one softmax against the kernel's online one
# over 64-key tiles, the same fp32 sums in another order (1e-5); bf16: the
# same fp32 values rounded once to bf16 (normwise 8e-3, two ulps of the
# largest element, and JAX's kernel tests' 2e-2 elementwise).

def _fa_rows(dev, bh, t, s, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=g, device=dev).to(dtype)
            for n in (t, s, s)]


def _fa_close(o, o_r, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
    else:
        _assert_normwise(o, o_r, 8e-3, "o")
        torch.testing.assert_close(o.float(), o_r.float(), rtol=2e-2,
                                   atol=2e-2)


# (rows, T, S, D, dtype, t_off, s_real): the prefill main path's shape
# (128 rows = batch 8 x 16 heads, T = S = 512, bf16), then fp32 with
# T < S, s_real < S, ragged T and every D the kernel takes
@pytest.mark.parametrize("bh,t,s,d,dtype,t_off,s_real", [
    (128, 512, 512, 128, torch.bfloat16, None, None),
    (4, 200, 200, 128, torch.float32, None, None),
    (3, 128, 256, 64, torch.float32, None, None),
    (2, 96, 160, 16, torch.float32, 10, 100),
    (2, 256, 256, 64, torch.float32, None, 200),
    (3, 77, 300, 128, torch.float32, 5, 290),
])
def test_flash_attention_kernel_matches_plain_version(dev, bh, t, s, d,
                                                      dtype, t_off, s_real):
    q, k, v = _fa_rows(dev, bh, t, s, d, dtype)
    before = fa_ops.fwd.launches
    o = fa_ops.fwd(q, k, v, t_off=t_off, s_real=s_real)
    torch.cuda.synchronize()
    assert fa_ops.fwd.launches == before + 1
    assert o.dtype == dtype and o.shape == (bh, t, d)
    o_r = fa_ops.fwd(q, k, v, t_off=t_off, s_real=s_real, kernel=False)
    assert fa_ops.fwd.launches == before + 1
    _fa_close(o, o_r, dtype)


@pytest.mark.parametrize("t,s,dtype", [(200, 200, torch.float32),
                                       (72, 200, torch.float32),
                                       (200, 200, torch.bfloat16)])
def test_flash_attention_wrapper_pads_like_jax(dev, t, s, dtype):
    """(B, H, T, D) with ragged T and S: the wrapper pads to the tile and
    the kernel's output matches the plain route of the same wrapper and
    JAX's oracle (ported)."""
    q, k, v = (x.reshape(2, 3, -1, 128)
               for x in _fa_rows(dev, 6, t, s, 128, dtype, seed=1))
    o = fa_ops.flash_attention(q, k, v)
    assert o.shape == (2, 3, t, 128)
    _fa_close(o, fa_ops.flash_attention(q, k, v, kernel=False), dtype)
    if dtype == torch.float32:
        _fa_close(o, fa_ref.flash_attention_ref(
            q.reshape(6, t, 128), k.reshape(6, s, 128),
            v.reshape(6, s, 128)).reshape(2, 3, t, 128), dtype)


def _fa_by_kv_head(dev, b, h, hkv, t, s, d, dtype, seed=2):
    """q rows (B·H, T, D), k, v rows (B·Hkv, S, D), and k, v broadcast to
    the q rows as JAX's model broadcasts them (head h reads h mod Hkv)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b * n_h, n, d), generator=g, device=dev).to(
        dtype) for n_h, n in ((h, t), (hkv, s), (hkv, s)))
    kb, vb = (x.reshape(b, 1, hkv, s, d).expand(b, h // hkv, hkv, s, d)
              .reshape(b * h, s, d) for x in (k, v))
    return q, k, v, kb, vb


# (B, H, Hkv, T, S, D, t_off, s_real): the prefill main path (B 8, H 16
# over 8 kv heads: 64 kv rows; T = S = 512), the same with Hkv = H, then
# ragged T, t_off and s_real at every D the kernel takes, G = 1, 2, 3
@pytest.mark.parametrize("b,h,hkv,t,s,d,t_off,s_real", [
    (8, 16, 8, 512, 512, 128, None, None),
    (8, 16, 16, 512, 512, 128, None, None),
    (2, 4, 2, 77, 300, 128, 5, 290),
    (3, 4, 4, 200, 200, 64, None, 150),
    (2, 6, 2, 96, 160, 16, 10, 100),
    (2, 6, 3, 130, 130, 16, None, None),
    (1, 2, 1, 1, 64, 64, None, None),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_reads_kv_by_head(dev, b, h, hkv, t, s, d,
                                                 t_off, s_real, dtype):
    """Both routes (bf16 on the tensor cores, fp32 on the CUDA cores) with
    K/V of Hkv heads against the plain version; in the oracle's domain
    (the queries the last T keys) also against ``flash_attention_ref`` on
    the broadcast K/V, at the same tolerance, evaluated in fp32 on the
    same values (in bf16 the oracle rounds the scores to bf16 before the
    softmax, as far from the exact function as the tolerance)."""
    q, k, v, kb, vb = _fa_by_kv_head(dev, b, h, hkv, t, s, d, dtype)
    before = fa_ops.fwd.launches
    o = fa_ops.fwd(q, k, v, t_off=t_off, s_real=s_real, kv_heads=hkv)
    torch.cuda.synchronize()
    assert fa_ops.fwd.launches == before + 1
    assert o.dtype == dtype and o.shape == (b * h, t, d)
    _fa_close(o, fa_ops.fwd(q, k, v, t_off=t_off, s_real=s_real,
                            kv_heads=hkv, kernel=False), dtype)
    if t_off is None and s_real is None:
        _fa_close(o, fa_ref.flash_attention_ref(q.float(), kb.float(),
                                                vb.float()), dtype)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [-0.1, 0.0])
def test_flash_attention_bf16_kernel_takes_any_scale(dev, d, scale):
    """The bf16 kernel keeps its running max in raw scores and flips Q's
    signs under a negative scale; a zero scale gives the mean of the
    visible values. Both against the plain version."""
    q, k, v, _, _ = _fa_by_kv_head(dev, 2, 4, 2, 130, 130, d,
                                   torch.bfloat16, seed=4)
    o = fa_ops.fwd(q, k, v, scale=scale, kv_heads=2)
    _fa_close(o, fa_ops.fwd(q, k, v, scale=scale, kv_heads=2, kernel=False),
              torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wrapper_by_kv_head(dev, dtype):
    """(B, H, T, D) q with (B, Hkv, S, D) k, v, ragged T < S: the kernel
    route against the plain route of the same wrapper."""
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((2, 16, 72, 128), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 8, 200, 128), generator=g, device=dev).to(dtype)
            for _ in range(2))
    o = fa_ops.flash_attention(q, k, v)
    assert o.shape == q.shape
    _fa_close(o, fa_ops.flash_attention(q, k, v, kernel=False), dtype)


def test_flash_attention_rejects_unsupported_inputs(dev):
    q, k, v = _fa_rows(dev, 2, 64, 64, 32, torch.float32)
    with pytest.raises(ValueError):                       # D = 32
        fa_ops.fwd(q, k, v)
    q, k, v = _fa_rows(dev, 2, 64, 64, 16, torch.float32)
    with pytest.raises(ValueError):                       # t_off < 0
        fa_ops.fwd(q, k, v, t_off=-1)
    with pytest.raises(ValueError):                       # s_real > S
        fa_ops.fwd(q, k, v, s_real=65)
    with pytest.raises(ValueError):                       # mixed types
        fa_ops.fwd(q, k, v.bfloat16())
    with pytest.raises(ValueError):                       # strided
        fa_ops.fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v)
    with pytest.raises(TypeError):
        fa_ops.fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):                       # CPU and CUDA
        fa_ops.fwd(q, k.cpu(), v)
    with pytest.raises(ValueError):                       # rows, kv_heads
        fa_ops.fwd(q, k[:1], v[:1])
    with pytest.raises(ValueError):
        fa_ops.fwd(torch.cat([q, q[:1]]), k, v, kv_heads=2)  # H = 3


def test_softmax_slice_through_kernel_matches_plain_route(dev):
    """Two layers at qwen3-0.6b's full widths, fp32: prefill through B10
    (once per layer) and greedy decode over the KV cache against prefill
    through B10's plain version (``attention_kernel=False``)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").with_backend("softmax"), n_layers=2,
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    for kernel in (True, False):
        before = fa_ops.fwd.launches
        logits, st = lm.prefill(params, prompt, cfg, attention_kernel=kernel)
        assert fa_ops.fwd.launches - before == (2 if kernel else 0)
        st = lm.pad_decode_state(st, cfg, 48)
        toks, st = lm.generate(params, st, torch.argmax(logits, -1), 40, 8,
                               cfg)
        out[kernel] = (logits, toks, st["stack"][0].k_cache,
                       st["stack"][0].v_cache)
    assert torch.equal(out[True][1], out[False][1])
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(out[True][2:], out[False][2:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
