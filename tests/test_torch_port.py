"""Package rules of the port: it imports no JAX and nothing of ``repro``,
its configuration copies match the JAX package field for field, and its
serving CLI runs on the CPU when asked to."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import paper_qa as jax_paper_qa
from repro_torch.configs import get_config, get_smoke_config, paper_qa

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_repro():
    files = _port_files()
    assert len(files) > 10
    port = ROOT / "src" / "repro_torch"
    for module in ("configs/paper_qa.py", "core/state.py", "qa/gru.py",
                   "kernels/lookup/ops.py", "kernels/lookup/ref.py",
                   "serving/lifecycle.py", "serving/lookup_engine.py",
                   "serving/__init__.py", "convert.py", "launch/serve.py",
                   "core/gated.py", "kernels/fused_recurrent/ops.py",
                   "kernels/fused_recurrent/ref.py", "models/attention.py",
                   "kernels/linear_attention/ops.py",
                   "kernels/linear_attention/ref.py",
                   "kernels/gated_linear_attention/ops.py",
                   "kernels/gated_linear_attention/ref.py", "optim/adamw.py",
                   "optim/schedule.py", "optim/accumulate.py",
                   "data/synthetic.py", "runtime/steps.py",
                   "runtime/straggler.py", "runtime/train_loop.py",
                   "launch/train.py", "tree.py",
                   "kernels/flash_attention/ops.py",
                   "kernels/flash_attention/ref.py",
                   "models/xla_attention.py", "models/moe.py",
                   "models/blocks.py", "configs/deepseek_moe_16b.py",
                   "configs/qwen3_moe_235b_a22b.py",
                   "configs/llama3_2_vision_90b.py",
                   "configs/yi_34b.py", "configs/internlm2_20b.py",
                   "configs/phi3_mini_3_8b.py", "configs/musicgen_large.py",
                   "models/layers.py", "models/rwkv6.py",
                   "configs/rwkv6_1_6b.py", "serving/backends/rwkv6.py",
                   "models/mamba2.py", "configs/zamba2_7b.py",
                   "serving/backends/mamba2.py", "serving/journal.py",
                   "serving/fleet.py", "sharding/__init__.py",
                   "launch/mesh.py", "runtime/elastic.py",
                   "checkpoint/elastic.py", "pipeline/__init__.py",
                   "pipeline/gpipe.py", "launch/specs.py",
                   "launch/roofline.py", "launch/hlo.py",
                   "launch/dryrun.py"):
        assert port / module in files, module
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def _jax_exports(init: Path):
    """The public names a JAX package ``__init__`` defines or imports
    from the package (not the third-party modules it imports)."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module.split(".")[0] == "repro":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


JAX_INITS = sorted((ROOT / "src" / "repro").rglob("__init__.py"))


@pytest.mark.parametrize(
    "init", JAX_INITS,
    ids=[str(p.parent.relative_to(ROOT / "src")) for p in JAX_INITS])
def test_port_package_exports_every_name_jax_exports(init):
    import importlib
    rel = init.parent.relative_to(ROOT / "src" / "repro").parts
    port = importlib.import_module(".".join(("repro_torch",) + rel))
    missing = sorted(n for n in _jax_exports(init) if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # two intra-op threads, as the test process has: torch's default of
    # one per core, beside the other test workers, oversubscribes the
    # CPU and slows each step by two orders of magnitude
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return env


def test_importing_the_serving_entry_point_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.serving, "
            "repro_torch.core.state, repro_torch.qa.gru, "
            "repro_torch.kernels.lookup.ops, repro_torch.convert, "
            "repro_torch.configs.paper_qa, repro_torch.core.gated, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.models.xla_attention, repro_torch.models.mamba2, "
            "repro_torch.serving.backends.mamba2, "
            "repro_torch.serving.journal, repro_torch.serving.fleet; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


@pytest.mark.parametrize("flags", [
    ["--journal", "{tmp}/wal.journal", "--checkpoint-dir", "{tmp}/ck",
     "--checkpoint-every", "1"],
    ["--backends", "mamba2,rwkv6", "--replicas", "2", "--journal-dir",
     "{tmp}/wal"]], ids=["journal", "fleet"])
def test_durable_stream_cli_on_cpu_loads_no_jax(tmp_path, flags):
    """``serve --mode stream`` with the durability flags (a journal and
    checkpoints; a replicated fleet with per-replica journals) runs on
    the CPU and loads no JAX."""
    argv = ["--mode", "stream", "--smoke", "--device", "cpu", "--slots",
            "2", "--n-requests", "4", "--prompt-len", "8", "--gen-len",
            "8"] + [f.format(tmp=tmp_path) for f in flags]
    code = ("import sys; from repro_torch.launch import serve; "
            f"rc = serve.main({argv!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "assert rc == 0 and not bad")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    if "--journal" in flags:
        assert "acks=4 completions=4 lost=0 zero_loss=PASS" in out.stdout
        assert os.listdir(tmp_path / "ck")
    else:
        assert "replicas=2/group failovers=0" in out.stdout
        assert sorted(os.listdir(tmp_path / "wal")) == [
            f"{g}.r{r}.journal" for g in ("mamba2", "rwkv6")
            for r in (0, 1)]


def test_importing_the_training_entry_point_loads_no_jax():
    code = ("import sys, repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.runtime, repro_torch.data, "
            "repro_torch.kernels.linear_attention.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_qwen3_config_copies_match_jax(getter):
    jget, tget = ((jax_config, get_config) if getter == "full"
                  else (jax_smoke_config, get_smoke_config))
    assert dataclasses.asdict(tget("qwen3-0.6b")) == dataclasses.asdict(
        jget("qwen3-0.6b"))
    assert (tget("qwen3-0.6b").with_backend("linear").pattern_and_repeats
            == jget("qwen3-0.6b").with_backend("linear").pattern_and_repeats)


@pytest.mark.parametrize("getter", ["full", "smoke"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b"])
def test_moe_and_vision_config_copies_match_jax(getter, arch):
    """Field for field, the MoE sub-config included."""
    jget, tget = ((jax_config, get_config) if getter == "full"
                  else (jax_smoke_config, get_smoke_config))
    t, j = tget(arch), jget(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    assert (t.moe is None) == (j.moe is None)
    if t.moe is not None:
        assert [f.name for f in dataclasses.fields(t.moe)] == [
            f.name for f in dataclasses.fields(j.moe)]
    assert t.pattern_and_repeats == j.pattern_and_repeats


@pytest.mark.parametrize("getter", ["full", "smoke"])
@pytest.mark.parametrize("arch", ["yi-34b", "internlm2-20b",
                                  "phi3-mini-3.8b", "musicgen-large"])
def test_dense_config_copies_match_jax(getter, arch):
    """Field for field, with the same layer pattern and repeats."""
    jget, tget = ((jax_config, get_config) if getter == "full"
                  else (jax_smoke_config, get_smoke_config))
    t, j = tget(arch), jget(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    assert t.pattern_and_repeats == j.pattern_and_repeats
    for backend in ("linear", "gated_linear", "softmax"):
        assert (t.with_backend(backend).fixed_state_decode
                == j.with_backend(backend).fixed_state_decode)


@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_zamba2_config_copies_match_jax(getter):
    """zamba2-7b field for field, its ``SSMConfig`` included (the schema's
    fields in JAX's order), with the same pattern, repeats and tail, and
    the same fixed-state flag under every backend."""
    from repro.configs.base import SSMConfig as JaxSSMConfig
    from repro_torch.configs import SSMConfig
    jget, tget = ((jax_config, get_config) if getter == "full"
                  else (jax_smoke_config, get_smoke_config))
    t, j = tget("zamba2-7b"), jget("zamba2-7b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [f.name for f in dataclasses.fields(t)] == [
        f.name for f in dataclasses.fields(j)]
    assert isinstance(t.ssm, SSMConfig)
    assert dataclasses.asdict(SSMConfig()) == dataclasses.asdict(
        JaxSSMConfig())
    assert [f.name for f in dataclasses.fields(SSMConfig)] == [
        f.name for f in dataclasses.fields(JaxSSMConfig)]
    assert t.pattern_and_repeats == j.pattern_and_repeats
    for backend in ("linear", "gated_linear", "softmax"):
        assert (t.with_backend(backend).fixed_state_decode
                == j.with_backend(backend).fixed_state_decode)


def test_paper_qa_copy_matches_jax():
    assert dataclasses.asdict(paper_qa.QAConfig()) == dataclasses.asdict(
        jax_paper_qa.QAConfig())
    assert [f.name for f in dataclasses.fields(paper_qa.QAConfig)] == [
        f.name for f in dataclasses.fields(jax_paper_qa.QAConfig)]
    for name in ("PAPER_N", "PAPER_K", "PAPER_M"):
        assert getattr(paper_qa, name) == getattr(jax_paper_qa, name)


def test_config_validation_copied():
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, decode_kernel="bogus")
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, decode_kernel="fused")    # softmax backend
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, layer_pattern=("nope",))


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--prompt-len", "16",
         "--gen-len", "6", "--batch", "2"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("arch=qwen3-0.6b-smoke backend=linear")
    assert lines[1].startswith("prefill 16 toks x2:")
    assert lines[2].startswith("decode  6 toks x2:") and "tok/s" in lines[2]
    assert lines[3].startswith("decode state:") and "O(1)" in lines[3]


def test_serve_gated_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--backend",
         "gated_linear", "--prompt-len", "16", "--gen-len", "6", "--batch",
         "2"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(
        "arch=qwen3-0.6b-smoke backend=gated_linear decode_kernel=auto "
        "(decode_gated)")
    assert lines[1].startswith("prefill 16 toks x2:")
    assert lines[2].startswith("decode  6 toks x2:") and "tok/s" in lines[2]
    assert lines[3].startswith("decode state:") and "O(1)" in lines[3]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b",
                                  "llama-3.2-vision-90b", "zamba2-7b"])
def test_serve_new_archs_cli_on_cpu(arch):
    """``serve --arch <arch> --smoke --device cpu``: the MoE configs, the
    vision config with its memory drawn and encoded in prefill, and the
    Mamba-2 hybrid."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--prompt-len", "16", "--gen-len",
         "6", "--batch", "2"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke backend=linear")
    assert lines[1].startswith("prefill 16 toks x2:")
    assert lines[2].startswith("decode  6 toks x2:") and "tok/s" in lines[2]
    assert lines[3].startswith("decode state:") and "O(1)" in lines[3]


def test_serve_builds_parameters_in_the_compute_type():
    """Serving draws its parameters in ``cfg.dtype`` (no fp32 master);
    the vision config's memory is bf16, as JAX draws it, and its state
    holds C and z per cross layer."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    args = serve.parse_args(["--arch", "llama-3.2-vision-90b", "--smoke",
                             "--device", "cpu", "--prompt-len", "8",
                             "--gen-len", "3", "--batch", "2"])
    cfg = serve.serving_config(args)
    assert cfg.param_dtype == cfg.dtype == "bfloat16"
    out = serve.generate(args)
    assert out["tokens"].shape == (2, 3)
    want = lm.state_bytes(lm.init_decode_state(cfg, 2))
    assert out["state_mib"] * 2**20 == want


def test_serve_gated_on_cpu_counts_no_kernel_launch():
    """The entry point's result: tokens of the asked shape, the gated
    state's bytes (s only, no z), and no kernel launch on the CPU."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    args = serve.parse_args(["--smoke", "--device", "cpu", "--backend",
                             "gated_linear", "--prompt-len", "8",
                             "--gen-len", "4", "--batch", "2"])
    out = serve.generate(args)
    cfg = get_smoke_config("qwen3-0.6b").with_backend("gated_linear")
    assert out["tokens"].shape == (2, 4) and out["decode_launches"] == 0
    assert out["state_mib"] * 2**20 == lm.state_bytes(
        lm.init_decode_state(cfg, 2)) == (
        cfg.n_layers * 2 * cfg.n_heads * cfg.head_dim ** 2 * 4)


def test_serve_without_cuda_raises(monkeypatch):
    import torch

    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        serve.generate(serve.parse_args(["--smoke", "--backend",
                                         "gated_linear"]))


def test_serve_lookup_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "lookup", "--device", "cpu", "--n-docs", "10", "--doc-len", "12",
         "--n-queries", "32", "--wave-size", "8"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("lookup backend=linear fixed_size_memory=True")
    assert lines[1].startswith("memories: 10 resident (1 varlen ingest "
                               "waves = 1 dispatches, 0 pinned)")
    assert lines[2].startswith("serve: 32 queries in") and (
        "8 waves = 8 dispatches" in lines[2])


def test_entry_point_refuses_to_fall_back_to_cpu(monkeypatch):
    import torch

    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_load_library_finds_a_loaded_library_without_resolving(monkeypatch):
    """The kernel wrappers call ``build.load_library`` at every launch: a
    library loaded once is returned for the same path without another
    ``Path.resolve()`` (file-system calls at every launch) and without a
    build."""
    from repro_torch.kernels import build
    source = Path(build.__file__).parent / "flash_attention" / "csrc" / \
        "flash_attention.cu"
    sentinel = object()
    monkeypatch.setitem(build._LOADED, source.resolve(), sentinel)
    assert build.load_library(source) is sentinel       # resolves once

    def no_resolve(self, *args, **kwargs):
        raise AssertionError("resolve() called for a loaded library")

    def no_build(sources):
        raise AssertionError("build() called for a loaded library")

    monkeypatch.setattr(Path, "resolve", no_resolve)
    monkeypatch.setattr(build, "build", no_build)
    assert build.load_library(source) is sentinel
    monkeypatch.delitem(build._LOADED, source)


def test_library_path_follows_every_included_file(tmp_path):
    """A library is named by a hash of its source and of every file the
    source reaches through ``#include "..."``: editing a header, even one
    included by a header, names a new library, so a stale one is never
    loaded; editing a file that is not included names the same one."""
    from repro_torch.kernels import build
    (tmp_path / "csrc").mkdir()
    (tmp_path / "inc").mkdir()
    source = tmp_path / "csrc" / "k.cu"
    source.write_text('#include <cuda.h>\n#include "../inc/a.cuh"\n'
                      'extern "C" int f() { return A; }\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n'
                                            '  #  include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("#define A 1\n")
    (tmp_path / "inc" / "other.cuh").write_text("#define B 1\n")
    assert [p.name for p in build.sources_of(source)] == ["k.cu", "a.cuh",
                                                          "b.cuh"]
    first = build._lib_path(source)
    assert first.name.startswith("k-") and first.suffix == ".so"
    (tmp_path / "inc" / "other.cuh").write_text("#define B 2\n")
    assert build._lib_path(source) == first
    (tmp_path / "inc" / "b.cuh").write_text("#define A 2\n")
    second = build._lib_path(source)
    assert second != first
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n'
                                            '#include "b.cuh"\n// edit\n')
    assert build._lib_path(source) not in (first, second)


def test_build_log_is_read_from_beside_a_kept_library(tmp_path,
                                                      monkeypatch):
    """``build_log`` gives this process's compiler output for a source,
    else the log kept beside its library (a library built by an earlier
    run), else None."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "BUILD_LOG", {})
    source = tmp_path / "k.cu"
    source.write_text('extern "C" int f() { return 1; }\n')
    assert build.build_log(source) is None
    build.BUILD_DIR.mkdir()
    log = build._lib_path(source).with_suffix(".log")
    assert log.name.startswith("k-")
    log.write_text("ptxas info    : Used 40 registers\n")
    assert "40 registers" in build.build_log(source)
    build.BUILD_LOG["k.cu"] = "this run"
    assert build.build_log(source) == "this run"


@pytest.mark.parametrize("kernel", ["linear_attention",
                                    "gated_linear_attention", "lookup"])
def test_tensor_core_sources_share_the_hopper_header(kernel):
    """B2/B3's and B8/B9's sources take their TMA and wgmma helpers, and
    B4/B5's its bulk copy and mbarriers, from ``kernels/csrc/hopper.cuh``,
    which their libraries' names hash."""
    from repro_torch.kernels import build
    source = Path(build.__file__).parent / kernel / "csrc" / f"{kernel}.cu"
    header = Path(build.__file__).parent / "csrc" / "hopper.cuh"
    assert build.sources_of(source) == [source.resolve(), header.resolve()]
