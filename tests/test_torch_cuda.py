"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs a CUDA device and skips without one. This
file imports neither JAX nor ``repro``, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json
import os
import subprocess
import sys

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


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize", [False, True])
def test_decode_linear_at_the_moe_and_vision_rows(dev, n, dtype, normalize):
    """B1 at the rows of llama-3.2-vision-90b's decode (batch 4 x 64
    heads) and qwen3-moe-235b-a22b's at batch 8 (8 x 64), D = 128, one
    step, against its plain version."""
    x = _rows(dev, n, 1, 128, dtype, seed=n)
    z = x["z"] if normalize else None
    o_r, s_r, z_r = ref.fused_recurrent_linear_ref(
        x["s"][:, None], x["q"][:, None], x["k"][:, None], x["v"][:, None],
        z=None if z is None else z[:, None], normalize=normalize)
    s = x["s"].clone()
    zk = None if z is None else z.clone()
    o, _, _ = ops.decode_linear(s, x["q"], x["k"], x["v"], z=zk,
                                normalize=normalize)
    torch.cuda.synchronize()
    torch.testing.assert_close(s, s_r[:, 0], rtol=1e-5, atol=1e-6)
    if normalize:
        torch.testing.assert_close(zk, z_r[:, 0], rtol=1e-5, atol=1e-6)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_r[:, 0].float(), rtol=tol,
                               atol=tol)


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


def _positive_rows(dev, n, w, d, dtype, seed=0):
    """S, z, q, k and v all positive: no sum cancels, so o's fp32 sums in
    two orders agree to ~D·2^-24 relative, far inside 1e-5."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev).abs()
    return dict(s=r(n, d, d), z=r(n, d) + 0.5,
                q=(r(n, w, d) + 0.1).to(dtype),
                k=(r(n, w, d) + 0.1).to(dtype), v=(r(n, w, d) + 0.1).to(dtype))


def _assert_o_close(o, o_r, dtype):
    """fp32 within 1e-5; bf16 within one ulp of the plain version's."""
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_r, rtol=1e-5, atol=1e-5)
        return
    _, e = torch.frexp(o_r.float())
    ulp = torch.ldexp(torch.ones_like(o_r, dtype=torch.float32), e - 8)
    assert ((o.float() - o_r.float()).abs() <= ulp).all()


# musicgen-large's head dim (64: four row groups of 16 rows),
# phi3-mini-3.8b's (96: 288 threads, three row groups of 32 rows) and
# zamba2-7b's (112: 448 threads, four row groups of 28 rows), at the
# smoke rows and at the serving path's (batch 8 x 32 heads)
@pytest.mark.parametrize("d", [64, 96, 112])
@pytest.mark.parametrize("n,w", [(24, 5), (256, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("varlen", [False, True])
def test_decode_linear_at_dense_head_dims(dev, d, n, w, dtype, normalize,
                                          varlen):
    """B1 against its plain version: S and z bit for bit (the same
    multiply and add), o within 1e-5 (fp32) or one bf16 ulp; a masked
    step writes 0 and leaves its row's state as it was."""
    x = _positive_rows(dev, n, w, d, dtype, seed=d + w)
    lens = (torch.arange(n, dtype=torch.int32, device=dev) % (w + 1)
            if varlen else None)
    z = x["z"] if normalize else None
    o_r, s_r, z_r = ref.fused_recurrent_linear_ref(
        x["s"][:, None], x["q"][:, None], x["k"][:, None], x["v"][:, None],
        z=None if z is None else z[:, None], normalize=normalize, lens=lens)
    s = x["s"].clone()
    zk = None if z is None else z.clone()
    before = ops.decode_linear.launches
    o, _, _ = ops.decode_linear(s, x["q"], x["k"], x["v"], z=zk,
                                normalize=normalize, lens=lens)
    torch.cuda.synchronize()
    assert ops.decode_linear.launches == before + 1
    assert torch.equal(s, s_r[:, 0])
    if normalize:
        assert torch.equal(zk, z_r[:, 0])
    _assert_o_close(o, o_r[:, 0], dtype)
    if varlen:
        masked = torch.arange(w, device=dev)[None] >= lens[:, None]
        assert torch.count_nonzero(o[masked]) == 0


@pytest.mark.parametrize("d", [64, 96, 112])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("varlen", [False, True])
@pytest.mark.parametrize("decay", ["mild", "strong", "scalar"])
def test_decode_gated_at_dense_head_dims(dev, d, dtype, varlen, decay):
    """B7 at D = 64, 96 and 112 against its plain version: S bit for bit, o
    within 1e-5 (fp32) or one bf16 ulp; lens-0 rows unchanged, masked o
    0."""
    n, w = 40, 5
    x = _positive_rows(dev, n, w, d, dtype, seed=d)
    x["g"] = _gated_rows(dev, n, w, d, dtype, decay)["g"]
    lens = (torch.arange(n, dtype=torch.int32, device=dev) % (w + 3)
            if varlen else None)
    o_r, s_r = ref.fused_recurrent_gated_ref(
        x["s"][:, None], x["q"][:, None], x["k"][:, None], x["v"][:, None],
        x["g"][:, None], lens=lens)
    s = x["s"].clone()
    before = ops.decode_gated.launches
    o, _ = ops.decode_gated(s, x["q"], x["k"], x["v"], x["g"], lens=lens)
    torch.cuda.synchronize()
    assert ops.decode_gated.launches == before + 1
    assert torch.equal(s, s_r[:, 0])
    _assert_o_close(o, o_r[:, 0], dtype)
    if varlen:
        idle = lens == 0
        assert torch.equal(s[idle], x["s"][idle])
        masked = torch.arange(w, device=dev)[None] >= lens[:, None]
        assert torch.count_nonzero(o[masked]) == 0


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
    (16, 8, 3, 256, None),      # K = 256: the state through the ring
    (8, 6, 130, 64, 128),       # M = 130 padded to 256: the M-tile loop
    (8, 6, 130, 256, 128),      # the ring, once per M tile
    (16, 8, 3, 66, None),       # K % 4 == 2: 8-byte output stores
    (16, 8, 3, 33, None),       # odd K: the direct-load route
    (16, 8, 1, 33, None),
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


@pytest.mark.parametrize("kd", [64, 100, 256, 33, 66])
def test_mass_lookup_matches_plain_version(dev, kd):
    c, q = _randn(dev, 3, 6, kd, kd), _randn(dev, 4, 6, 5, kd)
    before = lu_ops.mass_lookup.launches
    o = lu_ops.mass_lookup(c, q)
    torch.cuda.synchronize()
    assert lu_ops.mass_lookup.launches == before + 1
    torch.testing.assert_close(o, lu_ref.mass_lookup_ref(c, q), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dk,dv", [
    (64, 64), (100, 48), (32, 256),
    (100, 100),     # the paper's width
    (128, 128),     # the LM's decode shape (B1's)
    (256, 256),     # 256 KiB a state: more than a block holds, direct
    (36, 50),       # bulk, a row of 200 bytes: copies of two rows
    (33, 17),       # Dk·Dv odd: the direct route
])
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


@pytest.mark.parametrize("kd,m", [(64, 1), (100, 4), (256, 3), (33, 2)])
def test_mass_lookup_indexed_row_outside_the_store_gives_nan(dev, kd, m):
    """Rows -1 and N read nothing: their answers are NaN, every other row
    agrees with its plain version (both routes, the ring too)."""
    n, b = 8, 6
    store, q = _randn(dev, 0, n, kd, kd), _randn(dev, 1, b, m, kd)
    rows = torch.tensor([3, -1, 0, n, 7, 3], dtype=torch.int32, device=dev)
    o = lu_ops.mass_lookup_indexed(store, rows, q)
    torch.cuda.synchronize()
    bad = torch.tensor([1, 3], device=dev)
    good = torch.tensor([0, 2, 4, 5], device=dev)
    assert torch.isnan(o[bad]).all()
    torch.testing.assert_close(
        o[good], lu_ref.mass_lookup_indexed_ref(store, rows[good], q[good]),
        rtol=1e-4, atol=1e-4)


def _offset_view(dev, shape, floats):
    """A contiguous tensor of ``shape`` starting ``floats`` × 4 bytes past
    an aligned allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + floats, device=dev)[floats:].view(shape)


def test_mass_lookup_misaligned_store_raises(dev):
    """Even K: a store 4 bytes off a 16-byte boundary cannot be bulk-copied
    and raises ValueError, on B4 and B5; odd K reads it directly."""
    store = _offset_view(dev, (4, 64, 64), 1)
    store.copy_(_randn(dev, 0, 4, 64, 64))
    q, rows = _randn(dev, 1, 4, 2, 64), torch.arange(4, dtype=torch.int32,
                                                     device=dev)
    before = (lu_ops.mass_lookup_indexed.launches, lu_ops.mass_lookup.launches)
    with pytest.raises(ValueError):
        lu_ops.mass_lookup_indexed(store, rows, q)
    with pytest.raises(ValueError):
        lu_ops.mass_lookup(store, q)
    assert (lu_ops.mass_lookup_indexed.launches,
            lu_ops.mass_lookup.launches) == before
    odd = _offset_view(dev, (4, 33, 33), 1)
    odd.copy_(_randn(dev, 2, 4, 33, 33))
    q = _randn(dev, 3, 4, 2, 33)
    o = lu_ops.mass_lookup_indexed(odd, rows, q)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, lu_ref.mass_lookup_indexed_ref(odd, rows, q),
                               rtol=1e-4, atol=1e-4)


def test_fused_decode_misaligned_state_raises(dev):
    """A bulk-route state 4 bytes off a 16-byte boundary cannot be
    bulk-copied and raises ValueError, launching nothing; a direct-route
    shape (Dk·Dv odd) is read where it lies."""
    s = _offset_view(dev, (3, 64, 64), 1)
    q, k, v = (_randn(dev, i, 3, 64) for i in (1, 2, 3))
    before = lu_ops.fused_decode.launches
    with pytest.raises(ValueError):
        lu_ops.fused_decode(s, q, k, v)
    assert lu_ops.fused_decode.launches == before
    odd = _offset_view(dev, (3, 33, 17), 1)
    odd.copy_(_randn(dev, 4, 3, 33, 17))
    q, k, v = _randn(dev, 5, 3, 33), _randn(dev, 6, 3, 33), _randn(dev, 7,
                                                                   3, 17)
    o_r, s_r = lu_ref.decode_ref(odd, q, k, v)
    o, _ = lu_ops.fused_decode(odd, q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(odd, s_r)
    torch.testing.assert_close(o, o_r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dk,dv,kernel,other", [
    (100, 100, "decode_bulk", "decode_direct"),
    (36, 50, "decode_bulk", "decode_direct"),
    (33, 17, "decode_direct", "decode_bulk"),
    (256, 256, "decode_direct", "decode_bulk"),
])
def test_fused_decode_route_by_shape(dev, dk, dv, kernel, other, tmp_path):
    """``ops.fused_decode`` runs the kernel that ``ops.decode_route``
    names for the shape, and never the other one."""
    assert lu_ops.decode_route(dk, dv) == kernel.split("_")[1]
    s = _randn(dev, 0, 4, dk, dv)
    q, k, v = _randn(dev, 1, 4, dk), _randn(dev, 2, 4, dk), _randn(dev, 3,
                                                                  4, dv)
    names = _cuda_kernel_names(tmp_path, lu_ops.fused_decode, s, q, k, v)
    assert any(kernel in n for n in names), names
    assert not any(other in n for n in names), names


@pytest.mark.parametrize("kd,kernel,other", [
    (64, "mass_lookup_bulk", "mass_lookup_direct"),
    (256, "mass_lookup_bulk", "mass_lookup_direct"),
    (33, "mass_lookup_direct", "mass_lookup_bulk"),
])
def test_mass_lookup_indexed_route_by_k(dev, kd, kernel, other, tmp_path):
    """An even-K ``ops.mass_lookup_indexed`` runs the bulk-copy kernel,
    ``mass_lookup_bulk``, and never the direct-load body; odd K the
    direct-load body ``mass_lookup_direct``."""
    store, q = _randn(dev, 0, 16, kd, kd), _randn(dev, 1, 8, 1, kd)
    rows = torch.arange(8, dtype=torch.int32, device=dev)
    names = _cuda_kernel_names(tmp_path, lu_ops.mass_lookup_indexed, store,
                               rows, q)
    assert any(kernel in n for n in names), names
    assert not any(other in n for n in names), names


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


# One capture in a fresh process: the inputs from a file, one call that
# builds and loads the library, then the profiled call; prints the names
_CAPTURE = """
import importlib, json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
module, name = sys.argv[1].split(":")
fn = getattr(importlib.import_module(module), name)
args, kwargs = torch.load(sys.argv[2])
args = [a.cuda() if torch.is_tensor(a) else a for a in args]
fn(*args, **kwargs)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    torch.cuda.synchronize()
    time.sleep(0.02)
    fn(*args, **kwargs)
    torch.cuda.synchronize()
    time.sleep(0.02)
print(json.dumps([e.key for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]))
"""


def _cuda_kernel_names(tmp_path, fn, *args, **kwargs):
    """The names of the CUDA kernels that ``fn(*args, **kwargs)`` runs,
    from torch.profiler (as chip_smoke.py's step profiles read them), in
    a fresh process: in one process, captures made a minute or more
    after its first one can report no device events at all (seen with
    the process idle, busy on the card or waiting on a child), so a
    whole-file run, whose builds take minutes, failed where the test
    alone passed. The capture window gets 20 ms of idle margin on each
    side: a kernel of a few microseconds at its very edge is sometimes
    dropped from the trace, which then reads as no launch."""
    inputs = tmp_path / "inputs.pt"
    torch.save(([a.cpu() if torch.is_tensor(a) else a for a in args],
                kwargs), inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    out = subprocess.run(
        [sys.executable, "-c", _CAPTURE, f"{fn.__module__}:{fn.__name__}",
         str(inputs)], capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("d", [16, 128])
def test_linear_attention_bf16_fwd_runs_on_the_tensor_cores(dev, d,
                                                            tmp_path):
    """A bf16 ``ops.fwd`` on CUDA launches B2's tensor-core kernel,
    ``linear_sweep_fwd_tc``, and never the FMA body ``sweep_kernel``; an
    fp32 one the FMA body."""
    q, k, v, _ = _la_rows(dev, 4, 200, d, torch.bfloat16, seed=3)
    names = _cuda_kernel_names(tmp_path, la_ops.fwd, q, k, v, chunk=40)
    assert any("linear_sweep_fwd_tc" in n for n in names), names
    assert not any("sweep_kernel" in n for n in names), names
    q, k, v = (x.float() for x in (q, k, v))
    names = _cuda_kernel_names(tmp_path, la_ops.fwd, q, k, v, chunk=40)
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


# -- B2/B3 and B8/B9 at the head dims 64 and 96 ------------------------------
# musicgen-large's and RWKV-6's 64 (one 64-column block on the tensor cores)
# and phi3-mini-3.8b's 96 (two blocks, the second half zero), at T a
# multiple of the chunk but not of the tiles, a ragged T, and the models'
# training and prefill shapes, on both routes, at the tolerances above.

DENSE_DIMS = [64, 96]


@pytest.mark.parametrize("d", DENSE_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,chunk", [(6, 272, 16), (4, 75, 75),
                                        (6, 200, 40)])
def test_linear_attention_kernels_at_dense_head_dims(dev, d, dtype, bh, t,
                                                     chunk):
    """B2 and B3 (through ``ops.bwd`` and each launch alone) against
    their plain versions at D = 64 and 96; the state far from
    symmetric."""
    test_linear_attention_kernels_match_plain_versions(dev, bh, t, d, dtype,
                                                       chunk)
    test_linear_attention_bwd_launches_match_their_plain_versions(
        dev, bh, t, d, dtype, chunk)


@pytest.mark.parametrize("d", DENSE_DIMS)
def test_linear_attention_kernels_at_the_training_shape(dev, d):
    """B2/B3 in bf16 at the dense training main path's rows (batch 8 x 32
    heads, T = 1,024): phi3-mini-3.8b's D = 96, musicgen-large's 64."""
    test_linear_attention_kernels_match_plain_versions(
        dev, 256, 1024, d, torch.bfloat16, 128)


@pytest.mark.parametrize("d", DENSE_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,t,chunk,decay", [
    (6, 272, 16, "mild"), (4, 75, 75, "mild"), (6, 200, 40, "mild_head"),
    (6, 272, 16, "model")])
def test_gated_kernels_at_dense_head_dims(dev, d, dtype, bh, t, chunk,
                                          decay):
    """B8 (inclusive; exclusive with u) and B9 (through ``ops.bwd`` and
    each launch alone) against their plain versions at D = 64 and 96."""
    test_gated_linear_attention_kernels_match_plain_versions(
        dev, bh, t, d, dtype, chunk, decay)
    if decay == "mild":
        test_gated_bwd_launches_match_their_plain_versions(dev, bh, t, d,
                                                           dtype, chunk)


@pytest.mark.parametrize("d", DENSE_DIMS)
def test_gated_kernels_at_the_training_shape(dev, d):
    """B8/B9 in bf16 at the dense training main path's rows (batch 8 x 32
    heads, T = 1,024) at the model's decay."""
    test_gated_linear_attention_kernels_match_plain_versions(
        dev, 256, 1024, d, torch.bfloat16, 128, "model")


@pytest.mark.parametrize("d", DENSE_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("at", ["clamp", "limit"])
def test_gated_kernels_at_dense_head_dims_at_the_clamp(dev, d, dtype, at):
    """g ≡ −1 (the default clamp) or ≡ the route's ``DECAY_LIMIT``, T =
    1,024, chunk 128, at D = 64 and 96: B8 and B9 finite and within the
    route's tolerance of ``gla_scan`` and its autograd in fp32."""
    lo = -1.0 if at == "clamp" else gla_ops.DECAY_LIMIT[dtype]
    q, k, v, do, g = (x.reshape(1, 2, 1024, d) for x in _gla_rows(
        dev, 2, 1024, d, dtype, "clamp", seed=3))
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


@pytest.mark.parametrize("d,dtype", [
    (64, torch.bfloat16), (64, torch.float32), (96, torch.bfloat16),
    (16, torch.float32)])
def test_rwkv6_attention_takes_a_bonus_per_head(dev, d, dtype):
    """B8's exclusive route with u of one row per head (RWKV-6's (H, D)
    ``u_bonus``): one launch for every head, each row reading its head's
    u, against the plain version; at rwkv6-1.6b's prefill shape (batch 8
    x 32 heads, T = 512) for D = 64 in bf16."""
    b, h, t = (8, 32, 512) if (d, dtype) == (64, torch.bfloat16) else \
        (2, 3, 200)
    q, k, v, _, g = (x.reshape(b, h, t, d) for x in _gla_rows(
        dev, b * h, t, d, dtype, "mild", seed=7))
    u = torch.randn((h, d), generator=torch.Generator(device=dev)
                    .manual_seed(8), device=dev)
    before = gla_ops.fwd.launches
    o, s = gla_ops.rwkv6_attention(q, k, v, g, u, chunk=64)
    torch.cuda.synchronize()
    assert gla_ops.fwd.launches == before + 1
    o_r, s_r = gla_ops.rwkv6_attention(q, k, v, g, u, chunk=64, kernel=False)
    _assert_normwise(o, o_r, LA_TOL[dtype], "o")
    _assert_normwise(s, s_r, LA_TOL[torch.float32], "state")
    # one u for every head is another function, further off than the
    # tolerance: a kernel that read u[0] for every row would fail above
    o_1, _ = gla_ops.rwkv6_attention(q, k, v, g, u[0], chunk=64,
                                     kernel=False)
    assert (o_1.float() - o_r.float()).abs().max() > \
        2 * LA_TOL[dtype] * o_r.float().abs().max()


def test_rwkv6_prefill_refuses_autograd_on_the_card(dev):
    """(The name is this test's history: B8's exclusive route was
    forward-only and the prefill refused autograd on the card.) An
    RWKV-6 block on CUDA tensors that need a gradient now runs B8's
    exclusive route forward and the exclusive backward's two launches,
    u off its zero init: the output and every parameter's gradient
    against the same block through the plain versions
    (``attention_kernel=False``), normwise 1e-5 and 1e-4; under
    ``torch.no_grad`` one B8 launch and no backward."""
    from repro_torch.models import rwkv6 as R
    cfg = dataclasses.replace(get_smoke_config("rwkv6-1.6b"),
                              dtype="float32")
    p = R.rwkv6_params(torch.Generator(device=dev).manual_seed(0), cfg)
    p["u_bonus"].normal_(0.0, 0.5, generator=torch.Generator(
        device=dev).manual_seed(1))
    x = torch.randn((2, 20, cfg.d_model), device=dev)
    runs = {}
    for kernel in (True, False):
        leaves = {k: t.detach().clone().requires_grad_()
                  for k, t in p.items() if torch.is_tensor(t)}
        before = _exclusive_counts()
        y, _ = R.rwkv6_apply(dict(p, **leaves), x, cfg,
                             attention_kernel=kernel)
        y.square().sum().backward()
        torch.cuda.synchronize()
        counts = tuple(a - b for a, b in zip(_exclusive_counts(), before))
        assert counts == ((1, 1, 1) if kernel else (0, 0, 0))
        runs[kernel] = (y.detach(), {k: t.grad for k, t in leaves.items()})
    _assert_normwise(runs[True][0], runs[False][0], 1e-5, "y")
    for k, grad in runs[False][1].items():
        _assert_normwise(runs[True][1][k], grad, 1e-4, f"grad {k}")
    before = _exclusive_counts()
    with torch.no_grad():
        y, _ = R.rwkv6_apply(p, x, cfg)
    assert _exclusive_counts() == (before[0] + 1, before[1], before[2])
    assert torch.isfinite(y).all()


def _exclusive_counts():
    return (gla_ops.fwd.launches, gla_ops.bwd_exclusive_dq.launches,
            gla_ops.bwd_exclusive_dkv.launches)


# (B, H, T, D, dtype, shared_u, chunk): a single row and odd row counts
# (at D <= 64 a bf16 block takes two rows, so the last block holds one), a
# ragged T, D = 16 and 64, the fp32 route; u per head, or one u for every
# row. The chunk stays at most 75 tokens: at RWKV-6's decays the plain
# version's chunk-wide factors overflow past about 98 (ROADMAP §C item 9)
@pytest.mark.parametrize("b,h,t,d,dtype,shared_u,chunk", [
    (1, 1, 128, 64, torch.bfloat16, False, 64),
    (1, 3, 200, 64, torch.bfloat16, False, 40),
    (1, 3, 200, 64, torch.bfloat16, True, 40),
    (3, 5, 75, 16, torch.bfloat16, False, 75),
    (3, 5, 75, 16, torch.bfloat16, True, 75),
    (1, 3, 200, 64, torch.float32, False, 40),
    (1, 1, 48, 16, torch.float32, True, 48),
])
def test_exclusive_backward_launches_match_their_plain_versions(
        dev, b, h, t, d, dtype, shared_u, chunk):
    """The exclusive backward's two launches, each alone, against
    ``ref.bwd_exclusive_dq_ref`` (dq, q⊙dq, du per row) and
    ``ref.bwd_exclusive_dkv_ref`` given the same q⊙dq (dk, dv; dg in fp32
    only: in bf16 that q⊙dq carries the rounding of Q̂, which only the
    same launch pair's k⊙dk cancels), and ``ops.bwd_exclusive`` whole
    against ``ref.chunked_bwd_exclusive_ref``, du included; normwise 1e-5
    (fp32) or 8e-3 (bf16). With u per head, dq also lies far from the
    plain version given u[0] for every row, so a launch that read one u
    would fail."""
    gen = torch.Generator(device=dev).manual_seed(11)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, k, v, do = (r(b * h, t, d).to(dtype) for _ in range(4))
    g = -(0.3 + 0.6 * torch.rand((b * h, t, d), generator=gen, device=dev))
    u = r(d) if shared_u else r(h, d)
    before = _exclusive_counts()
    dq, qdq, du_rows = gla_ops.bwd_exclusive_dq(q, k, v, g, do, u, chunk=chunk)
    dk, dv, dg = gla_ops.bwd_exclusive_dkv(q, k, v, g, do, u, qdq, chunk=chunk)
    whole = gla_ops.bwd_exclusive(q, k, v, g, do, u, chunk=chunk)
    torch.cuda.synchronize()
    assert _exclusive_counts() == (before[0], before[1] + 2, before[2] + 2)
    tol = LA_TOL[dtype]
    want = gla_ref.bwd_exclusive_dq_ref(q, k, v, g, do, u, chunk=chunk)
    for name, x, x_r in zip(("dq", "q⊙dq", "du_rows"), (dq, qdq, du_rows),
                            want):
        assert x.shape == x_r.shape and torch.isfinite(x).all(), name
        _assert_normwise(x, x_r, tol, name)
    want = gla_ref.bwd_exclusive_dkv_ref(q, k, v, g, do, u, qdq, chunk=chunk)
    names = ("dk", "dv", "dg") if dtype == torch.float32 else ("dk", "dv")
    for name, x, x_r in zip(names, (dk, dv, dg), want):
        _assert_normwise(x, x_r, tol, name)
    want = gla_ref.chunked_bwd_exclusive_ref(q, k, v, g, do, u, chunk=chunk)
    for name, x, x_r in zip(("dq", "dk", "dv", "dg", "du"), whole, want):
        assert x.dtype == x_r.dtype and x.shape == x_r.shape, name
        _assert_normwise(x, x_r, tol, name)
    if not shared_u and h > 1:
        dq_1, _, _ = gla_ref.bwd_exclusive_dq_ref(q, k, v, g, do, u[0],
                                                  chunk=chunk)
        assert (dq_1.float() - dq.float()).abs().max() > \
            2 * tol * dq.float().abs().max()


def _ssd_rows(dev, b, h, t, n, dtype, seed=0):
    """Mamba-2's SSD inputs: C and B of one (B, T, N) row each, broadcast
    over the heads (views, as the model passes them), v = Δ·x, and the
    per-head decay g = −softplus(Δ)·linspace(1, 16, H) (B, H, T, 1) of
    zamba2-7b's init, most heads past the clamp at −1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    cq, bk = (r(b, 1, t, n).expand(b, h, t, n).to(dtype) for _ in range(2))
    dt = torch.nn.functional.softplus(r(b, h, t, 1))
    v = (r(b, h, t, n) * dt).to(dtype)
    g = -dt * torch.linspace(1.0, 16.0, h, device=dev)[:, None, None]
    return cq, bk, v, g


@pytest.mark.parametrize("b,h,t,dtype", [
    (8, 112, 512, torch.bfloat16), (8, 112, 512, torch.float32),
    (2, 7, 200, torch.bfloat16), (2, 7, 75, torch.float32)])
def test_ssd_attention_matches_plain_version(dev, b, h, t, dtype):
    """B8's inclusive route with its final state, as the Mamba-2 prefill
    calls it (``ssd_attention``, chunk 64): zamba2-7b's SSD shape (batch 8
    x 112 heads, T = 512, d_state = head dim = 64) with its decays, and
    ragged T, one launch for every head, against the plain version: o
    normwise 1e-5 (fp32) or 8e-3 (bf16), the fp32 state 1e-5."""
    q, k, v, g = _ssd_rows(dev, b, h, t, 64, dtype)
    before = gla_ops.fwd.launches
    o, s = gla_ops.ssd_attention(q, k, v, g, chunk=64)
    torch.cuda.synchronize()
    assert gla_ops.fwd.launches == before + 1
    assert o.dtype == dtype and s.shape == (b, h, 64, 64)
    o_r, s_r = gla_ops.ssd_attention(q, k, v, g, chunk=64, kernel=False)
    assert gla_ops.fwd.launches == before + 1
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    _assert_normwise(o, o_r, LA_TOL[dtype], "o")
    _assert_normwise(s, s_r, LA_TOL[torch.float32], "state")


def test_mamba2_prefill_refuses_autograd_on_the_card(dev):
    """``ssd_attention`` is forward-only: a Mamba-2 prefill on CUDA
    tensors that need a gradient raises NotImplementedError, and under
    ``torch.no_grad`` it runs B8 once; the training form (no state) runs
    B8 forward and B9 backward."""
    from repro_torch.models import mamba2 as M
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"), dtype="float32")
    p = M.mamba2_params(torch.Generator(device=dev).manual_seed(0), cfg)
    x = torch.randn((2, 20, cfg.d_model), device=dev)
    p["in_proj"].requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        M.mamba2_apply(p, x, cfg, want_state=True)
    before = _gla_counts()
    with torch.no_grad():
        y, st = M.mamba2_apply(p, x, cfg, want_state=True)
    assert _gla_counts() == (before[0] + 1, before[1], before[2])
    assert torch.isfinite(y).all() and torch.isfinite(st.ssd).all()
    y, _ = M.mamba2_apply(p, x, cfg)
    y.sum().backward()
    assert _gla_counts() == (before[0] + 2, before[1] + 1, before[2] + 1)
    assert torch.isfinite(p["in_proj"].grad).all()


@pytest.mark.parametrize("backend", ["linear", "gated_linear"])
def test_training_at_head_dim_112_raises_naming_the_roadmap_item(dev,
                                                                 backend):
    """(The name is this test's history: B2/B3 and B8/B9 did not take
    D = 112 and the step raised, naming ROADMAP queue B item 1.) A
    zamba2-7b-shaped model (its smoke config with one attention head of
    112) now trains through B2/B3 or B8/B9 at D = 112 under linear and
    gated_linear: the loss within 1e-5 relative and every gradient leaf
    within 1e-4 normwise of the same step through the plain versions
    (``attention_kernel=False``), the attention kernels launched."""
    cfg = dataclasses.replace(
        get_smoke_config("zamba2-7b").with_backend(backend), dtype="float32",
        d_model=112, n_heads=1, n_kv_heads=1, head_dim=112)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    ops_ = la_ops if backend == "linear" else gla_ops
    runs = {}
    for kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_()
                  for t in _tensor_leaves(params)]
        before = (ops_.fwd.launches, ops_.bwd_dq.launches)
        loss, _ = lm.lm_loss(_with_leaves(params, iter(leaves)),
                             {"tokens": toks, "labels": toks}, cfg,
                             attention_kernel=kernel)
        loss.backward()
        torch.cuda.synchronize()
        launched = (ops_.fwd.launches - before[0],
                    ops_.bwd_dq.launches - before[1])
        assert (min(launched) > 0) == kernel, launched
        runs[kernel] = (loss.detach(), [t.grad for t in leaves])
    torch.testing.assert_close(runs[True][0], runs[False][0], rtol=1e-5,
                               atol=0.0)
    for i, (a, b) in enumerate(zip(runs[True][1], runs[False][1])):
        _assert_normwise(a, b, 1e-4, f"gradient leaf {i}")


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _with_leaves(tree, it):
    if isinstance(tree, dict):
        return {k: _with_leaves(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_with_leaves(v, it) for v in tree)
    if isinstance(tree, list):
        return [_with_leaves(v, it) for v in tree]
    return next(it) if torch.is_tensor(tree) else tree


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
    (4, 64, 8, 512, 512, 128, None, None),      # llama-3.2-vision-90b
    (4, 64, 4, 512, 512, 128, None, None),      # qwen3-moe-235b-a22b
    (2, 4, 2, 77, 300, 128, 5, 290),
    (3, 4, 4, 200, 200, 64, None, 150),
    (2, 6, 2, 96, 160, 16, 10, 100),
    (2, 6, 3, 130, 130, 16, None, None),
    (1, 2, 1, 1, 64, 64, None, None),
    (8, 32, 32, 512, 512, 96, None, None),      # phi3-mini-3.8b: G = 1
    (8, 48, 8, 512, 512, 128, None, None),      # internlm2-20b: G = 6
    (8, 56, 8, 512, 512, 128, None, None),      # yi-34b: G = 7
    (2, 12, 2, 200, 200, 96, None, 150),        # D = 96, G = 6
    (2, 14, 2, 77, 300, 96, 5, 290),            # D = 96, G = 7
    (8, 32, 32, 512, 512, 112, None, None),     # zamba2-7b: G = 1
    (2, 12, 2, 200, 200, 112, None, 150),       # D = 112, G = 6
    (2, 14, 2, 77, 300, 112, 5, 290),           # D = 112, G = 7
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


# the log-sum-exp beside o: fp32 sums in another order (1e-5); bf16 the
# same scores from bf16 inputs through ex2.approx (1e-4)
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}


@pytest.mark.parametrize("b,h,hkv,t,s,d,t_off,s_real", [
    (8, 16, 8, 512, 512, 128, None, None),
    (8, 16, 8, 1024, 1024, 128, None, None),
    (4, 64, 8, 512, 512, 128, None, None),
    (4, 64, 4, 512, 512, 128, None, None),
    (2, 4, 2, 77, 300, 128, 5, 290),
    (3, 4, 4, 200, 200, 64, None, 150),
    (2, 6, 2, 96, 160, 16, 10, 100),
    (1, 2, 1, 1, 64, 64, None, None),
    (8, 32, 32, 512, 512, 96, None, None),
    (2, 12, 2, 200, 200, 96, None, 150),
    (2, 14, 2, 77, 300, 96, 5, 290),
    (8, 32, 32, 512, 512, 112, None, None),
    (2, 14, 2, 77, 300, 112, 5, 290),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_emits_lse(dev, b, h, hkv, t, s, d, t_off,
                                          s_real, dtype):
    """``want_lse``: one launch writes o, bit for bit the o of the
    null-lse launch, and the fp32 log-sum-exp of each query, against the
    plain version's at LSE_TOL."""
    q, k, v, _, _ = _fa_by_kv_head(dev, b, h, hkv, t, s, d, dtype)
    kw = dict(t_off=t_off, s_real=s_real, kv_heads=hkv)
    before = fa_ops.fwd.launches
    o, lse = fa_ops.fwd(q, k, v, want_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa_ops.fwd.launches == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (b * h, t)
    assert torch.equal(o, fa_ops.fwd(q, k, v, **kw))
    o_r, lse_r = fa_ops.fwd(q, k, v, want_lse=True, kernel=False, **kw)
    _fa_close(o, o_r, dtype)
    torch.testing.assert_close(lse, lse_r, rtol=LSE_TOL[dtype],
                               atol=LSE_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wrapper_slices_lse_from_padded_rows(dev, dtype):
    """Ragged T < S through the wrapper's tile padding: lse (B, H, T)."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((2, 16, 72, 128), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((2, 8, 200, 128), generator=g, device=dev).to(dtype)
            for _ in range(2))
    o, lse = fa_ops.flash_attention(q, k, v, want_lse=True)
    o_r, lse_r = fa_ops.flash_attention(q, k, v, want_lse=True, kernel=False)
    assert lse.shape == (2, 16, 72)
    _fa_close(o, o_r, dtype)
    torch.testing.assert_close(lse, lse_r, rtol=LSE_TOL[dtype],
                               atol=LSE_TOL[dtype])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [-0.1, 0.0])
def test_flash_attention_bf16_kernel_takes_any_scale(dev, d, scale):
    """The bf16 kernel keeps its running max in raw scores and flips Q's
    signs under a negative scale; a zero scale gives the mean of the
    visible values. Both against the plain version."""
    q, k, v, _, _ = _fa_by_kv_head(dev, 2, 4, 2, 130, 130, d,
                                   torch.bfloat16, seed=4)
    o, lse = fa_ops.fwd(q, k, v, scale=scale, kv_heads=2, want_lse=True)
    o_r, lse_r = fa_ops.fwd(q, k, v, scale=scale, kv_heads=2, kernel=False,
                            want_lse=True)
    _fa_close(o, o_r, torch.bfloat16)
    torch.testing.assert_close(lse, lse_r, rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("backend", ["linear", "gated_linear", "softmax"])
def test_moe_and_cross_slices_through_kernels_match_reference(dev, arch,
                                                              backend):
    """The MoE and vision smoke configs in fp32 (cross blocks' xgate 0.5,
    a memory of their image tokens): prefill and 8 greedy steps through
    B1/B7 and B10 against ``decode_kernel="reference"`` with B10's plain
    version: tokens identical, logits within 1e-4."""
    cfg = dataclasses.replace(get_smoke_config(arch).with_backend(backend),
                              dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    for kind, group in zip(cfg.layer_pattern, params["stack"]):
        if kind == "cross":
            group["xgate"].fill_(0.5)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                           generator=gen)
    memory = (torch.randn((2, cfg.n_img_tokens, cfg.d_model), device=dev,
                          generator=gen) if cfg.n_img_tokens else None)
    out = {}
    for kernel in (True, False):
        c = cfg if kernel else dataclasses.replace(cfg,
                                                   decode_kernel="reference")
        logits, st = lm.prefill(params, prompt, c, memory=memory,
                                attention_kernel=kernel)
        st = lm.pad_decode_state(st, c, 32)
        toks, _ = lm.generate(params, st, torch.argmax(logits, -1), 24, 8, c)
        out[kernel] = (logits, toks)
    assert torch.equal(out[True][1], out[False][1])
    torch.testing.assert_close(out[True][0], out[False][0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch,backend,gate", [
    ("zamba2-7b", "linear", False), ("zamba2-7b", "gated_linear", False),
    ("zamba2-7b", "softmax", False), ("qwen3-0.6b", "linear", True),
    ("qwen3-0.6b", "gated_linear", True)])
def test_zamba2_and_feature_gate_slices_through_kernels_match_reference(
        dev, arch, backend, gate):
    """zamba2-7b's smoke config (Mamba-2 prefill through B8, the shared
    attention through B1/B7 or B10) and qwen3-0.6b's with the paper's
    feature gate, in fp32: prefill, 8 greedy steps and a varlen window
    against ``decode_kernel="reference"`` with the prefill's plain
    versions: tokens identical, logits within 1e-4."""
    cfg = dataclasses.replace(get_smoke_config(arch).with_backend(backend),
                              dtype="float32", feature_gate=gate)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    for kernel in (True, False):
        c = cfg if kernel else dataclasses.replace(cfg,
                                                   decode_kernel="reference")
        logits, st = lm.prefill(params, prompt, c, attention_kernel=kernel)
        st = lm.pad_decode_state(st, c, 40)
        toks, st = lm.generate(params, st, torch.argmax(logits, -1), 24, 8,
                               c)
        lg, _ = lm.decode_window_varlen(params, st, prompt[:, :4],
                                        torch.tensor([32, 32]),
                                        torch.tensor([4, 2]), c)
        out[kernel] = (toks, logits, lg)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1:], out[False][1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# (ingest chunk, max_len, prompt lengths, budgets): chunks of 8, and the
# stream path's 64 with prompts beyond it (continuation chunks 64 wide)
ENGINE_WORKLOADS = {
    "chunk8": (8, 96, (6, 8, 21, 1, 40, 8, 7, 5), (5, 12, 1, 9, 7, 6, 4, 8)),
    "chunk64": (64, 256, (130, 200, 1, 64, 192, 70, 9),
                (5, 4, 6, 1, 7, 3, 8)),
}


@pytest.mark.parametrize("backend", ["linear", "gated_linear"])
@pytest.mark.parametrize("ingest", ["recurrent", "parallel"])
@pytest.mark.parametrize("workload", sorted(ENGINE_WORKLOADS))
def test_engine_through_kernels_matches_reference_engine(dev, backend,
                                                         ingest, workload):
    """DecodeEngine at the smoke size, fp32: decode (per-slot masks) and
    recurrent ingest (per-row lengths, chunks up to 64 wide) through
    B1/B7 against the same engine under decode_kernel="reference":
    completions token for token and the stats identical; the kernel
    launched once per layer and segment step (and recurrent ingest
    chunk), never on the reference route."""
    from repro_torch.serving import DecodeEngine
    kernel = {"linear": ops.decode_linear,
              "gated_linear": ops.decode_gated}[backend]
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend(backend), dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    chunk, max_len, prompt_lens, gens = ENGINE_WORKLOADS[workload]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    runs = {}
    for route in ("auto", "reference"):
        eng = DecodeEngine(params, dataclasses.replace(cfg,
                                                       decode_kernel=route),
                           n_slots=3, segment_len=4, max_len=max_len,
                           prefill_chunk=chunk, ingest=ingest)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        before = kernel.launches
        comps = eng.run()
        st = eng.stats.to_dict()
        runs[route] = (comps, st, kernel.launches - before)
    (comps, st, n), (ref, ref_st, n_ref) = runs["auto"], runs["reference"]
    assert st == ref_st
    assert st["ingest_chunks"] > 0 and st["segments"] > 0
    chunks = st["ingest_chunks"] if ingest == "recurrent" else 0
    assert n == cfg.n_layers * (st["segment_len"] * st["segments"] + chunks)
    assert n_ref == 0
    for a, b in zip(comps, ref):
        assert (a.uid, a.finish_reason, a.admitted_step, a.finished_step) \
            == (b.uid, b.finish_reason, b.admitted_step, b.finished_step)
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("dtype,loss_tol,leaf_tol", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 1e-4, 5e-2)])
def test_softmax_training_slice_through_b10_matches_plain_route(
        dev, dtype, loss_tol, leaf_tol):
    """Two layers at qwen3-0.6b's full widths: the loss and every
    gradient leaf with B10 (and its lse) in the forward against the same
    with B10's plain version (``attention_kernel=False``); the backward
    is the plain blockwise flash backward on both routes. B10 twice per
    layer under remat (forward and recompute). The loss relative, each
    leaf normwise (max|Δ| over the plain leaf's largest magnitude)."""
    from repro_torch.configs import get_config
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_config("qwen3-0.6b").with_backend("softmax"),
                              n_layers=2, dtype=dtype)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device=dev, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat = leaves(params)
    for x in flat:
        x.requires_grad_()
    out = {}
    for kernel in (True, False):
        before = fa_ops.fwd.launches
        loss, _ = lm.lm_loss(params, batch, cfg, attention_kernel=kernel)
        grads = torch.autograd.grad(loss, flat)
        assert fa_ops.fwd.launches - before == (4 if kernel else 0)
        out[kernel] = (loss.detach(), grads)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=loss_tol,
                               atol=0.0)
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.isfinite(a).all()
        _assert_normwise(a, b, leaf_tol, "gradient leaf")


@pytest.mark.parametrize("workload", sorted(ENGINE_WORKLOADS))
def test_softmax_engine_through_b10_matches_plain_prefill_engine(dev,
                                                                 workload):
    """DecodeEngine under softmax at the smoke size, fp32: admission waves
    through B10 against the same engine under decode_kernel="reference"
    (B10's plain version in every prefill): completions token for token
    and the stats identical; B10 launched once per layer and prefill pass
    (each wave and each 1-token prompt), never on the plain route."""
    from repro_torch.launch import serve
    from repro_torch.serving import DecodeEngine

    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend("softmax"),
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    chunk, max_len, prompt_lens, gens = ENGINE_WORKLOADS[workload]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    runs = {}
    for kernel in ("auto", "reference"):
        eng = DecodeEngine(params,
                           dataclasses.replace(cfg, decode_kernel=kernel),
                           n_slots=3, segment_len=4, max_len=max_len,
                           prefill_chunk=chunk)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        before = fa_ops.fwd.launches
        comps = eng.run()
        runs[kernel == "auto"] = (comps, eng.stats.to_dict(),
                                  fa_ops.fwd.launches - before)
    (comps, st, n), (ref, ref_st, n_ref) = runs[True], runs[False]
    assert st == ref_st and st["ingest_chunks"] > 0 and n_ref == 0
    ones = sum(n == 1 for n in prompt_lens)
    assert n == serve.stream_launches(cfg, st, "recurrent", "batched", ones)
    for a, b in zip(comps, ref):
        assert (a.uid, a.finish_reason, a.admitted_step, a.finished_step) \
            == (b.uid, b.finish_reason, b.admitted_step, b.finished_step)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_checkpoint_of_a_cuda_tree_isolated_from_in_place_update(dev,
                                                                 tmp_path):
    """An async save of a tree on the card keeps the values of the call
    although the device tensors are updated in place before the writer
    runs (as AdamW does), and restores onto the card bit for bit, bf16
    and the 0-d step included."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamState
    from repro_torch.tree import leaves, tree_map
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"params": {"w": torch.randn((1024, 1024), generator=g,
                                        device=dev),
                       "h": torch.randn((4096,), generator=g,
                                        device=dev).bfloat16()},
            "opt": AdamState(step=torch.tensor(7, dtype=torch.int32,
                                               device=dev),
                             mu={"w": torch.randn((1024, 1024), generator=g,
                                                  device=dev)},
                             nu={"w": torch.rand((1024, 1024), generator=g,
                                                 device=dev)})}
    want = tree_map(lambda x: x.clone(), tree)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, tree, extra={"step": 1}, blocking=False)
    with torch.no_grad():
        for x in leaves(tree):
            x.add_(1)
    mgr.wait()
    got, extra, step = mgr.restore(tree_map(torch.zeros_like, tree))
    assert step == 1 and extra == {"step": 1}
    for a, b in zip(leaves(got), leaves(want)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("att", ["none", "linear", "gated_linear", "softmax",
                                 "second_order"])
def test_qa_step_on_the_card_matches_the_cpu(dev, att):
    """One Adam step of the paper's QA model at its published widths (k
    = 100, embeddings 100) on a batch of 8 documents of 120 tokens, on
    the card and on the CPU from the same parameters: the loss within
    1e-5 relative, every gradient leaf and every parameter after the
    step within normwise 1e-4, max|Δ| ≤ 1e-4 · max|CPU's| (fp32 sums in
    other orders through 124 GRU steps); the parameters where the
    gradient is above 1e-4 of its leaf's largest, since Adam's first
    step is lr·g/(|g| + eps), ±lr except near eps (chip_smoke's phase 9
    rule)."""
    from repro_torch.configs.paper_qa import QAConfig
    from repro_torch.data import ClozeTask
    from repro_torch.optim import adam
    from repro_torch.qa import QAModel
    from repro_torch.qa.train import make_step, put_batch
    from repro_torch.tree import leaves, tree_map
    cfg = QAConfig(attention=att)
    model = QAModel(cfg)
    cpu = torch.device("cpu")
    p_cpu = model.init(torch.Generator().manual_seed(0))
    p_dev = tree_map(lambda x: x.to(dev, copy=True), p_cpu)
    batch = ClozeTask(seed=1).batch(8, step=0)
    out = {}
    for name, params, where in (("cpu", p_cpu, cpu), ("card", p_dev, dev)):
        opt = adam(cfg.lr)
        out[name] = make_step(model, opt)(params, opt.init(params),
                                          put_batch(batch, where))
    torch.testing.assert_close(out["card"][2].cpu(), out["cpu"][2],
                               rtol=1e-5, atol=0)
    for p_k, p_c, g_k, g_c in zip(*(leaves(out[w][i]) for i in (0, 3)
                                    for w in ("card", "cpu"))):
        g_k, p_k = g_k.cpu(), p_k.detach().cpu()
        assert (g_k - g_c).abs().max() <= 1e-4 * g_c.abs().max()
        big = g_c.abs() > 1e-4 * g_c.abs().max()
        p_c = p_c.detach()
        if big.any():
            assert (p_k - p_c)[big].abs().max() <= \
                1e-4 * p_c[big].abs().max()


# -- speculative decoding: the masked verify window and the rewind ----------

@pytest.mark.parametrize("backend", ["linear", "gated_linear"])
def test_spec_verify_window_masks_rows_and_rewind_matches_steps(dev,
                                                                backend):
    """Smoke config in fp32 on the card: the verify's masked window (lens
    = K+1 on the speculating row, 0 on the others) launches B1/B7 once per
    layer and leaves the other rows' state bit for bit; the row's
    pre-round copy (``snapshot_state_rows``, no KV rows) restored and a
    varlen window of its first 3 tokens equals 3 single-token steps from
    the same start."""
    kernel = {"linear": ops.decode_linear,
              "gated_linear": ops.decode_gated}[backend]
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend(backend), dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), device=dev, generator=g)
    window = torch.randint(0, cfg.vocab_size, (3, 7), device=dev, generator=g)
    _, state = lm.prefill(params, prompt, cfg)
    others = [lm.snapshot_state(state, s) for s in (0, 2)]
    pre = lm.snapshot_state_rows(state, 1, 0)
    seq = lm.snapshot_state(state, 1)
    pos = torch.full((3,), 9, dtype=torch.int32, device=dev)
    before = kernel.launches
    lm.decode_window_varlen(params, state, window, pos,
                            torch.tensor([0, 7, 0], device=dev), cfg)
    torch.cuda.synchronize()
    assert kernel.launches == before + cfg.n_layers
    for slot, snap in zip((0, 2), others):
        for a, b in zip(lm._slot_leaves(lm.snapshot_state(state, slot)),
                        lm._slot_leaves(snap)):
            assert torch.equal(a[0], b[0]), slot
    lm.restore_state_rows(state, pre, 1)
    lm.decode_window_varlen(params, state, window, pos,
                            torch.tensor([0, 3, 0], device=dev), cfg,
                            last_only=True)
    for i in range(3):
        lm.decode_step(params, seq, window[1:2, i], pos[:1] + i, cfg)
    for a, b in zip(lm._slot_leaves(lm.snapshot_state(state, 1)),
                    lm._slot_leaves(seq)):
        torch.testing.assert_close(a[0], b[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["linear", "gated_linear", "softmax"])
def test_spec_engine_through_kernels_matches_reference_engine(dev, backend):
    """DecodeEngine with speculative (K = 4, an n-gram draft) and plain
    requests at the smoke size, fp32: through B1/B7 (the verify and the
    batched rewind; B10 in admission under softmax) against the same
    engine under decode_kernel="reference": completions and stats
    identical and equal to plain greedy's, one rewind pass a rewinding
    round, the kernel launched as ``stream_launches`` counts."""
    from repro_torch.launch import serve
    from repro_torch.serving import DecodeEngine, NgramDraft
    name, kernel = serve.STREAM_KERNELS[backend]
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend(backend), dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (6, 20, 9, 1, 33)]
    gens = (20, 13, 16, 9, 18)
    runs = {}
    for route in ("auto", "reference"):
        eng = DecodeEngine(params, dataclasses.replace(cfg,
                                                       decode_kernel=route),
                           n_slots=3, segment_len=4, max_len=64,
                           prefill_chunk=16, draft=NgramDraft())
        out = []
        for k in (0, 4):
            eng.reset()
            for i, (p, g) in enumerate(zip(prompts, gens)):
                eng.submit(p, g, speculate_k=k if i % 4 else 0)
            before = kernel.launches
            comps = eng.run()
            out.append((comps, eng.stats.to_dict(), kernel.launches - before))
        runs[route] = out
    (plain, _, _), (spec, st, n) = runs["auto"]
    _, (ref, ref_st, n_ref) = runs["reference"]
    assert st == ref_st and n_ref == 0
    assert st["spec_rounds"] and st["spec_rewind_dispatches"] == \
        st["spec_rewind_rounds"]
    assert n == serve.stream_launches(cfg, st, "recurrent", "batched", 1)
    for a, b, p in zip(spec, ref, plain):
        assert (a.uid, a.admitted_step, a.finished_step) == (
            b.uid, b.admitted_step, b.finished_step)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, p.tokens)


@pytest.mark.parametrize("backend", ["linear", "gated_linear", "softmax"])
def test_prefix_cache_hits_through_kernels_match_reference_engine(dev,
                                                                  backend):
    """DecodeEngine with the prefix cache at the smoke size, fp32: cold
    and warm runs of prompts sharing a 48-token prefix through B1/B7 (the
    hit's suffix chunks and decode) and B10 (cold waves under softmax)
    against the same engine under decode_kernel="reference": completions,
    stats and cache counters identical, warm equal to cold with no
    prefill, the kernel launched as ``stream_launches`` counts and every
    paged block's refcount 0."""
    from repro_torch.launch import serve
    from repro_torch.serving import DecodeEngine
    name, kernel = serve.STREAM_KERNELS[backend]
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend(backend), dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, size=48)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    size=n)]).astype(np.int32)
               for n in (16, 5, 16, 9, 16)]
    runs = {}
    for route in ("auto", "reference"):
        eng = DecodeEngine(params, dataclasses.replace(cfg,
                                                       decode_kernel=route),
                           n_slots=3, segment_len=4, max_len=96,
                           prefill_chunk=16, prefix_cache=True)
        out = []
        for _ in ("cold", "warm"):
            eng.reset()
            for p in prompts:
                eng.submit(p, 12)
            before = kernel.launches
            comps = eng.run()
            out.append((comps, eng.stats.to_dict(), eng.cache.counters(),
                        kernel.launches - before))
            if backend == "softmax":
                assert all(b.refcount == 0
                           for b in eng.cache._blocks.values())
        runs[route] = out
    for (comps, st, c, n), (r_comps, r_st, r_c, n_ref) in zip(
            runs["auto"], runs["reference"]):
        assert st == r_st and c == r_c and n_ref == 0
        assert n == serve.stream_launches(cfg, st, "recurrent", "batched")
        for a, b in zip(comps, r_comps):
            np.testing.assert_array_equal(a.tokens, b.tokens)
    (cold, cold_st, _, _), (warm, warm_st, _, _) = runs["auto"]
    assert cold_st["cache_hits"] >= 1
    assert (warm_st["cache_hits"], warm_st["prefills"],
            warm_st["prefill_dispatches"]) == (len(prompts), 0, 0)
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a.tokens, b.tokens)
