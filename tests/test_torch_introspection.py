"""The port's introspection (``launch/{specs,roofline,hlo}.py``) against
the JAX package's on the CPU, and the kernels' ``work()`` against the
bounds in PERF.md §6.

- ``SHAPES`` field for field; ``count_params`` and ``model_flops`` for
  every architecture and shape, exactly;
- every leaf of the abstract trees (parameters, serving parameters,
  AdamW state, decode state at batch 128 and 32,768 rows, input specs of
  every shape): shape and dtype equal to JAX's ``eval_shape``, every
  full config, each a fake tensor (no storage);
- JAX's ``TestRooflineTerms`` cases at H100 peaks, and each roofline
  term equal to JAX's scaled by the ratio of the peaks;
- ``CollectiveOp.wire_bytes`` equal to JAX's for every kind at group
  sizes 1, 2, 4 and 16;
- ``analyze_step``'s dot FLOPs of the smoke prefill (linear,
  gated_linear, softmax) equal to JAX's ``analyze_module`` of the
  compiled step, less the head departure 2·B·(T−1)·d·V (JAX's prefill
  runs the head at every position, the port's at the last); of
  ``lm_loss`` with its gradients equal too, less the normaliser's dot
  under linear (below);
- each kernel's ``work()`` giving PERF.md §6's GFLOP, MB and bound µs at
  every shape of its row;
- a call of each wrapper on fake CUDA tensors records its work on the
  fake route and launches nothing.

Smoke sizes for the FLOP comparisons (fp32, JAX jitted).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import hlo as jhlo
from repro.launch import roofline as jroof
from repro.launch import specs as JS
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.sharding import Rules as JRules
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.configs import list_architectures
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.fused_recurrent import ops as FR
from repro_torch.kernels.gated_linear_attention import ops as GL
from repro_torch.kernels.linear_attention import ops as LA
from repro_torch.kernels.lookup import ops as LU
from repro_torch.launch import hlo, roofline
from repro_torch.launch import specs as S
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves

ARCHS = list_architectures()
B, T = 2, 64


def _same(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        assert isinstance(b, FakeTensor)


def test_shapes_match_jax():
    assert list(SHAPES) == list(JSHAPES)
    for name, s in SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JSHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert S.count_params(cfg) == JS.count_params(jcfg)
    for name in SHAPES:
        assert S.model_flops(cfg, SHAPES[name]) == \
            JS.model_flops(jcfg, JSHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_jax_eval_shape(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    _same(JS.abstract_params(jcfg), S.abstract_params(cfg))
    _same(JS.abstract_params_serving(jcfg), S.abstract_params_serving(cfg))
    _same(JS.abstract_opt_state(jcfg, jadamw(1e-4)),
          S.abstract_opt_state(cfg, adamw(1e-4)))
    _same(JS.abstract_decode_state(jcfg, 128, 32768),
          S.abstract_decode_state(cfg, 128, 32768))
    for name in SHAPES:
        jspec = JS.input_specs(jcfg, JSHAPES[name])
        tspec = S.input_specs(cfg, SHAPES[name])
        assert sorted(jspec) == sorted(tspec)
        for key in jspec:
            _same(jspec[key], tspec[key])
    # made on the card's device unless asked, with no card present
    assert S.abstract_params(cfg)["embed"].device.type == "cuda"


# -- roofline ---------------------------------------------------------------

class TestRooflineTerms:
    """JAX's ``tests/test_hlo_parse.py`` cases at the H100's peaks."""

    def test_bottleneck_selection(self):
        link = roofline.NVLINK_LINK_BW * roofline.NVLINK_LINKS_EFFECTIVE
        t = roofline.RooflineTerms(
            flops_per_device=roofline.PEAK_FLOPS_BF16,      # 1 s compute
            hbm_bytes_per_device=roofline.HBM_BW / 2,       # 0.5 s memory
            wire_bytes_per_device=link * 2,                 # 2 s collective
            n_devices=256)
        assert t.bottleneck == "collective"
        np.testing.assert_allclose(t.t_bound, 2.0)

    def test_mfu_bound(self):
        t = roofline.RooflineTerms(
            flops_per_device=roofline.PEAK_FLOPS_BF16,
            hbm_bytes_per_device=0.0, wire_bytes_per_device=0.0,
            n_devices=2, model_flops_global=2 * roofline.PEAK_FLOPS_BF16)
        np.testing.assert_allclose(t.mfu_bound, 1.0)

    def test_fused_adjustment(self):
        t = roofline.RooflineTerms(
            flops_per_device=1.0, hbm_bytes_per_device=roofline.HBM_BW,
            score_bytes_per_device=roofline.HBM_BW / 2,
            wire_bytes_per_device=0.0, n_devices=1)
        np.testing.assert_allclose(t.t_memory, 1.0)
        np.testing.assert_allclose(t.t_memory_fused, 0.5)


def test_roofline_terms_are_jax_terms_scaled_by_the_peaks():
    kw = dict(flops_per_device=3.1e13, hbm_bytes_per_device=7.7e11,
              wire_bytes_per_device=2.9e10, n_devices=256,
              model_flops_global=4.4e15, score_bytes_per_device=1.3e11)
    ours, theirs = roofline.RooflineTerms(**kw), jroof.RooflineTerms(**kw)
    c = jroof.PEAK_FLOPS_BF16 / roofline.PEAK_FLOPS_BF16
    m = jroof.HBM_BW / roofline.HBM_BW
    n = (jroof.ICI_LINK_BW * jroof.ICI_LINKS_EFFECTIVE) / (
        roofline.NVLINK_LINK_BW * roofline.NVLINK_LINKS_EFFECTIVE)
    np.testing.assert_allclose(ours.t_compute, theirs.t_compute * c)
    np.testing.assert_allclose(ours.t_memory, theirs.t_memory * m)
    np.testing.assert_allclose(ours.t_memory_fused,
                               theirs.t_memory_pallas * m)
    np.testing.assert_allclose(ours.t_collective, theirs.t_collective * n)
    np.testing.assert_allclose(ours.model_flops_ratio,
                               theirs.model_flops_ratio)
    bound = max(theirs.t_compute * c, theirs.t_memory * m,
                theirs.t_collective * n)
    np.testing.assert_allclose(ours.t_bound, bound)
    np.testing.assert_allclose(
        ours.mfu_bound, theirs.mfu_bound * theirs.t_bound * c
        / bound)
    assert set(ours.as_dict()) == {
        k.replace("pallas", "fused") for k in theirs.as_dict()}


@pytest.mark.parametrize("size", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_match_jax(kind, size):
    ours = hlo.CollectiveOp(kind, 123_456, size, "step", multiplicity=3)
    theirs = jhlo.CollectiveOp(kind, 123_456, size, "step", multiplicity=3)
    assert ours.wire_bytes == theirs.wire_bytes


# -- dot FLOPs of a traced step against JAX's compiled step ---------------

def _smoke(backend):
    jc = dataclasses.replace(jax_smoke_config("qwen3-0.6b").with_backend(
        backend), dtype="float32")
    tc = dataclasses.replace(get_smoke_config("qwen3-0.6b").with_backend(
        backend), dtype="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                 device="cpu")
    rng = np.random.default_rng(0)
    tok, lab = (rng.integers(0, jc.vocab_size, (B, T)).astype(np.int32)
                for _ in range(2))
    return jc, tc, jp, tp, tok, lab


@pytest.mark.parametrize("backend", ["linear", "gated_linear", "softmax"])
def test_prefill_dot_flops_match_jax_less_the_head(backend):
    jc, tc, jp, tp, tok, _ = _smoke(backend)
    lowered = jax.jit(lambda p, t: jlm.prefill(p, t, jc, JRules.null())
                      ).lower(jp, jnp.asarray(tok))
    want = jhlo.analyze_module(lowered.compile().as_text()).dot_flops
    with torch.no_grad():
        _, an = hlo.analyze_step(lambda p, t: lm.prefill(p, t, tc), tp,
                                 torch.from_numpy(tok))
    # JAX's prefill runs the head at every position and keeps the last
    head = 2 * B * (T - 1) * jc.d_model * jc.vocab_size
    assert an.dot_flops == want - head


@pytest.mark.parametrize("backend", ["linear", "gated_linear", "softmax"])
def test_loss_and_grad_dot_flops_match_jax(backend):
    jc, tc, jp, tp, tok, lab = _smoke(backend)
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    lowered = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jb, jc, JRules.null())[0])).lower(jp)
    want = jhlo.analyze_module(lowered.compile().as_text()).dot_flops

    def step(params, batch):
        flat = leaves(params)
        for x in flat:
            x.requires_grad_(True)
        return torch.autograd.grad(lm.lm_loss(params, batch, tc)[0], flat)
    _, an = hlo.analyze_step(step, tp, {"tokens": torch.from_numpy(tok),
                                        "labels": torch.from_numpy(lab)})
    departure = 0
    if backend == "linear":
        # the normaliser's q·Σk: JAX contracts it as a dot
        # (``jnp.einsum("bhtk,bhtk->bht")``), whose autodiff adds one
        # more of the same size; the port forms it elementwise and sums
        per = 2 * B * jc.n_heads * T * jc.head_dim
        departure = jc.n_layers * 2 * per
    assert an.dot_flops == want - departure
    # on the CPU the kernels' plain versions ran, and reported their work
    assert an.kernels and {k.route for k in an.kernels} == {"plain"}


# -- the kernels' work against PERF.md §6 ---------------------------------

def _m(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


F32 = torch.float32


def _b1(n, d):
    return FR.decode_linear_work(_m(n, d, d, dtype=F32), _m(n, 1, d),
                                 _m(n, 1, d), _m(n, 1, d),
                                 z=_m(n, d, dtype=F32), normalize=True)


def _b7(n, d):
    return FR.decode_gated_work(_m(n, d, d, dtype=F32), _m(n, 1, d),
                                _m(n, 1, d), _m(n, 1, d),
                                _m(n, 1, d, dtype=F32))


def _b4():
    # the mean of phase 6's row sets: 252 distinct of 256 rows drawn from
    # 8,192 live documents
    rows = torch.arange(256, dtype=torch.int32) % 252
    return LU.mass_lookup_indexed_work(_m(16384, 64, 64, dtype=F32), rows,
                                       _m(256, 1, 64, dtype=F32))


def _la(fn, rows, t, d):
    n = 4 if fn in ("bwd_dkv_work", "bwd_work") else 3
    return getattr(LA, fn)(*[_m(rows, t, d)] * n)


def _gl(fn, rows, t, d, u_heads=None):
    x, g = _m(rows, t, d), _m(rows, t, d, dtype=F32)
    if fn == "fwd_work":
        if u_heads:
            return GL.fwd_work(x, x, x, g, u=_m(u_heads, d, dtype=F32),
                               exclusive=True)
        return GL.fwd_work(x, x, x, g)
    if "exclusive" in fn:
        return getattr(GL, fn)(x, x, x, g, x, _m(u_heads, d, dtype=F32))
    return getattr(GL, fn)(x, x, x, g, x)


def _fa(q_rows, kv_rows, t, d, lse=False):
    return FA.fwd_work(_m(q_rows, t, d), _m(kv_rows, t, d),
                       _m(kv_rows, t, d), t_off=0, s_real=t, want_lse=lse)


# (id, work, GFLOP, MB, µs at the fp32 rate, µs at the bf16 tensor-core
# rate); None where PERF.md's row gives no such figure
PERF_ROWS = [
    ("B1", lambda: _b1(128, 128), None, 17.04, 5.09, None),
    ("B1-phi3", lambda: _b1(256, 96), None, 19.27, 5.75, None),
    ("B1-musicgen", lambda: _b1(256, 64), None, 8.65, 2.58, None),
    ("B1-yi", lambda: _b1(448, 128), None, 59.64, 17.80, None),
    ("B1-zamba2", lambda: _b1(256, 112), None, 26.15, 7.81, None),
    ("B7", lambda: _b7(128, 128), None, 16.97, 5.07, None),
    ("B7-phi3", lambda: _b7(256, 96), None, 19.17, 5.72, None),
    ("B7-musicgen", lambda: _b7(256, 64), None, 8.59, 2.56, None),
    ("B7-zamba2", lambda: _b7(256, 112), None, 26.03, 7.77, None),
    ("B4", _b4, None, 4.26, 1.27, None),
    ("B5", lambda: LU.mass_lookup_work(_m(256, 100, 100, dtype=F32),
                                       _m(256, 4, 100, dtype=F32)),
     None, 11.06, 3.30, None),
    ("B6", lambda: LU.fused_decode_work(
        _m(256, 100, 100, dtype=F32), *[_m(256, 100, dtype=F32)] * 3),
     None, 20.89, 6.24, None),
    ("B6-bf16", lambda: LU.fused_decode_work(
        _m(128, 128, 128, dtype=F32), *[_m(128, 128)] * 3),
     None, 16.91, 5.05, None),
    ("B2", lambda: _la("fwd_work", 128, 1024, 128), 8.59, 142.61, 128.21,
     42.57),
    ("B2-phi3", lambda: _la("fwd_work", 256, 1024, 96), 9.66, 210.76,
     144.23, 62.91),
    ("B2-musicgen", lambda: _la("fwd_work", 256, 1024, 64), 4.29, 138.41,
     64.10, 41.32),
    ("B2-zamba2", lambda: _la("fwd_work", 256, 1024, 112), 13.15, 247.73,
     196.32, 73.95),
    ("B3-dq", lambda: _la("bwd_dq_work", 128, 1024, 128), 8.59, 134.22,
     128.21, 40.06),
    ("B3-dkv", lambda: _la("bwd_dkv_work", 128, 1024, 128), 12.88, 201.33,
     192.31, 60.10),
    ("B3-function", lambda: _la("bwd_work", 128, 1024, 128), None, 234.88,
     None, 70.11),
    ("B3-phi3-dq", lambda: _la("bwd_dq_work", 256, 1024, 96), None, None,
     144.23, 60.10),
    ("B3-phi3-dkv", lambda: _la("bwd_dkv_work", 256, 1024, 96), None, None,
     216.35, 90.15),
    ("B3-phi3-function", lambda: _la("bwd_work", 256, 1024, 96), None, None,
     None, 105.17),
    ("B3-musicgen-dq", lambda: _la("bwd_dq_work", 256, 1024, 64), None,
     None, 64.10, 40.06),
    ("B3-musicgen-dkv", lambda: _la("bwd_dkv_work", 256, 1024, 64), None,
     None, 96.16, 60.10),
    ("B3-zamba2-dq", lambda: _la("bwd_dq_work", 256, 1024, 112), None, None,
     196.32, 70.11),
    ("B3-zamba2-dkv", lambda: _la("bwd_dkv_work", 256, 1024, 112), None,
     None, 294.48, 105.17),
    ("B3-zamba2-function", lambda: _la("bwd_work", 256, 1024, 112), None,
     411.04, None, 122.70),
    ("B8", lambda: _gl("fwd_work", 128, 1024, 128), 8.61, 209.72, 128.46,
     62.60),
    ("B8-phi3", lambda: _gl("fwd_work", 256, 1024, 96), 9.69, 311.43,
     144.61, 92.96),
    ("B8-musicgen", lambda: _gl("fwd_work", 256, 1024, 64), 4.31, 205.52,
     64.35, 61.35),
    ("B8-rwkv6", lambda: _gl("fwd_work", 256, 512, 64, u_heads=32), 2.17,
     104.87, 32.43, 31.30),
    ("B8-rwkv6-T1024", lambda: _gl("fwd_work", 256, 1024, 64, u_heads=32),
     None, None, None, 61.35),
    ("B8-zamba2-ssd", lambda: _gl("fwd_work", 896, 512, 64), 7.55, 367.00,
     112.62, 109.55),
    ("B8-zamba2-112", lambda: _gl("fwd_work", 256, 1024, 112), 13.18,
     365.17, 196.76, 109.00),
    ("B9-dq", lambda: _gl("bwd_dq_work", 128, 1024, 128), None, 301.99,
     128.46, 90.15),
    ("B9-dkv", lambda: _gl("bwd_dkv_work", 128, 1024, 128), None, 402.65,
     192.56, 120.19),
    ("B9-function", lambda: _gl("bwd_work", 128, 1024, 128), None, 369.10,
     None, 110.18),
    ("B9-phi3-dq", lambda: _gl("bwd_dq_work", 256, 1024, 96), None, None,
     144.61, 135.22),
    ("B9-phi3-dkv", lambda: _gl("bwd_dkv_work", 256, 1024, 96), None, None,
     216.73, 180.29),
    ("B9-phi3-function", lambda: _gl("bwd_work", 256, 1024, 96), None,
     None, None, 165.27),
    ("B9-musicgen-dq", lambda: _gl("bwd_dq_work", 256, 1024, 64), None,
     None, 90.15, 90.15),
    ("B9-musicgen-dkv", lambda: _gl("bwd_dkv_work", 256, 1024, 64), None,
     None, 120.19, 120.19),
    ("B9-zamba2-dq", lambda: _gl("bwd_dq_work", 256, 1024, 112), None,
     528.48, 196.76, 157.76),
    ("B9-zamba2-dkv", lambda: _gl("bwd_dkv_work", 256, 1024, 112), None,
     704.64, 294.92, 210.34),
    ("B9-zamba2-function", lambda: _gl("bwd_work", 256, 1024, 112), None,
     645.92, None, 192.81),
    ("B9-exclusive-dq", lambda: _gl("bwd_exclusive_dq_work", 256, 1024, 64,
                                    u_heads=32), None, 302.06, None, 90.17),
    ("B9-exclusive-dkv", lambda: _gl("bwd_exclusive_dkv_work", 256, 1024,
                                     64, u_heads=32), None, 402.66, None,
     120.20),
    ("B9-exclusive-function", lambda: _gl("bwd_exclusive_work", 256, 1024,
                                          64, u_heads=32), None, 369.12,
     None, 110.18),
    ("B10", lambda: _fa(128, 64, 512, 128), 8.61, 50.33, 128.46, 15.02),
    ("B10-lse", lambda: _fa(128, 64, 512, 128, lse=True), None, None, None,
     15.10),
    ("B10-128kv", lambda: _fa(128, 128, 512, 128), None, None, None, 20.03),
    ("B10-phi3", lambda: _fa(256, 256, 512, 96), 12.91, 100.66, 192.69,
     30.05),
    ("B10-musicgen", lambda: _fa(256, 256, 512, 64), 8.61, 67.11, 128.46,
     20.03),
    ("B10-yi", lambda: _fa(448, 64, 512, 128), 30.12, 134.22, 449.60,
     40.06),
    # PERF.md gave 224.78 µs for this fp32 bound until PR 39; its own
    # 15.06 GFLOP over 67 TFLOP/s is 224.80, the figure corrected there
    ("B10-zamba2", lambda: _fa(256, 256, 512, 112), 15.06, 117.44, 224.80,
     35.06),
]


@pytest.mark.parametrize("work,gflop,mb,us_fp32,us_tc",
                         [r[1:] for r in PERF_ROWS],
                         ids=[r[0] for r in PERF_ROWS])
def test_kernel_work_gives_perf_table_bounds(work, gflop, mb, us_fp32,
                                             us_tc):
    flops, n_bytes = work()
    if gflop is not None:
        assert round(flops / 1e9, 2) == gflop
    if mb is not None:
        assert round(n_bytes / 1e6, 2) == mb
    if us_fp32 is not None:
        assert round(roofline.bound(n_bytes, flops)["bound_ms"] * 1e3,
                     2) == us_fp32
    if us_tc is not None:
        assert round(roofline.bound(n_bytes, flops, roofline.PEAK_FLOPS_BF16)
                     ["bound_ms"] * 1e3, 2) == us_tc


def test_two_sweep_bound_of_b3():
    x = _m(128, 1024, 128)
    dq, dkv = LA.bwd_dq_work(x, x, x), LA.bwd_dkv_work(x, x, x, x)
    assert round(roofline.bound(dq[1] + dkv[1], 0.0)["bound_ms"] * 1e3,
                 2) == 100.16


# -- the fake route ----------------------------------------------------------

def _fake_calls(dev):
    f32 = torch.float32

    def e(*s, dt=torch.bfloat16):
        return torch.empty(s, dtype=dt, device=dev)
    s, z = e(8, 64, 64, dt=f32), e(8, 64, dt=f32)
    x1, g1 = e(8, 1, 64), e(8, 1, 64, dt=f32)
    x, g, u = e(8, 128, 64), e(8, 128, 64, dt=f32), e(64, dt=f32)
    c, kv = e(8, 16, 16, dt=f32), e(4, 128, 64)
    return [
        ("decode_linear", FR.decode_linear, lambda: FR.decode_linear(
            s, x1, x1, x1, z=z, normalize=True),
         FR.decode_linear_work(s, x1, x1, x1, z=z, normalize=True)),
        ("decode_gated", FR.decode_gated, lambda: FR.decode_gated(
            s, x1, x1, x1, g1), FR.decode_gated_work(s, x1, x1, x1, g1)),
        ("linear_attention_fwd", LA.fwd, lambda: LA.fwd(x, x, x),
         LA.fwd_work(x, x, x)),
        ("linear_attention_bwd_dq", LA.bwd_dq, lambda: LA.bwd_dq(x, x, x),
         LA.bwd_dq_work(x, x, x)),
        ("linear_attention_bwd_dkv", LA.bwd_dkv,
         lambda: LA.bwd_dkv(x, x, x, x), LA.bwd_dkv_work(x, x, x, x)),
        ("gated_linear_attention_fwd", GL.fwd,
         lambda: GL.fwd(x, x, x, g, u=u, exclusive=True),
         GL.fwd_work(x, x, x, g, u=u, exclusive=True)),
        ("gated_linear_attention_bwd_dq", GL.bwd_dq,
         lambda: GL.bwd_dq(x, x, x, g, x), GL.bwd_dq_work(x, x, x, g, x)),
        ("gated_linear_attention_bwd_dkv", GL.bwd_dkv,
         lambda: GL.bwd_dkv(x, x, x, g, x, g),
         GL.bwd_dkv_work(x, x, x, g, x)),
        ("gated_linear_attention_bwd_exclusive_dq", GL.bwd_exclusive_dq,
         lambda: GL.bwd_exclusive_dq(x, x, x, g, x, u),
         GL.bwd_exclusive_dq_work(x, x, x, g, x, u)),
        ("gated_linear_attention_bwd_exclusive_dkv", GL.bwd_exclusive_dkv,
         lambda: GL.bwd_exclusive_dkv(x, x, x, g, x, u, g),
         GL.bwd_exclusive_dkv_work(x, x, x, g, x, u)),
        ("flash_attention_fwd", FA.fwd,
         lambda: FA.fwd(x, kv, kv, kv_heads=2),
         FA.fwd_work(x, kv, kv, t_off=0, s_real=128)),
        ("mass_lookup", LU.mass_lookup,
         lambda: LU.mass_lookup(c, e(8, 2, 16, dt=f32)),
         LU.mass_lookup_work(c, e(8, 2, 16, dt=f32))),
        ("mass_lookup_indexed", LU.mass_lookup_indexed,
         lambda: LU.mass_lookup_indexed(
             c, torch.zeros(4, dtype=torch.int32, device=dev),
             e(4, 2, 16, dt=f32)),
         LU.mass_lookup_indexed_work(
             c, torch.zeros(4, dtype=torch.int32, device=dev),
             e(4, 2, 16, dt=f32))),
        ("fused_decode", LU.fused_decode,
         lambda: LU.fused_decode(c, *[e(8, 16, dt=f32)] * 3),
         LU.fused_decode_work(c, *[e(8, 16, dt=f32)] * 3)),
    ]


FAKE_NAMES = [
    "decode_linear", "decode_gated", "linear_attention_fwd",
    "linear_attention_bwd_dq", "linear_attention_bwd_dkv",
    "gated_linear_attention_fwd", "gated_linear_attention_bwd_dq",
    "gated_linear_attention_bwd_dkv",
    "gated_linear_attention_bwd_exclusive_dq",
    "gated_linear_attention_bwd_exclusive_dkv", "flash_attention_fwd",
    "mass_lookup", "mass_lookup_indexed", "fused_decode"]


@pytest.mark.parametrize("i", range(len(FAKE_NAMES)), ids=FAKE_NAMES)
def test_fake_cuda_call_records_work_and_launches_nothing(i):
    with FakeTensorMode():
        name, wrapper, call, work = _fake_calls("cuda")[i]
        before = wrapper.launches
        out, an = hlo.analyze_step(call)
    assert wrapper.launches == before
    assert [(k.name, k.route) for k in an.kernels] == [(name, "fake")]
    assert (an.kernels[0].flops, an.kernels[0].bytes) == tuple(
        map(float, work))
    assert all(isinstance(t, FakeTensor) and t.device.type == "cuda"
               for t in hlo._tensors(out))


def test_analysis_memory_of_an_in_place_step():
    """Arguments, a temporary and an output updated in place (the alias),
    as a train step's parameters are."""
    with FakeTensorMode():
        w = torch.empty((256, 256), device="cuda")
        x = torch.empty((64, 256), device="cuda")

        def step(w, x):
            h = x @ w                   # 64 KiB, freed at the end
            w.add_(h.sum())
            return w, h.sum()
        _, an = hlo.analyze_step(step, w, x)
    assert an.argument_bytes == 256 * 256 * 4 + 64 * 256 * 4
    assert an.alias_bytes == 256 * 256 * 4
    assert an.output_bytes == 256 * 256 * 4 + 4
    assert an.live_peak_bytes == 64 * 256 * 4 + 4
    assert an.peak_bytes == an.argument_bytes + an.live_peak_bytes
    assert an.dot_flops == 2 * 64 * 256 * 256
