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
                   "models/xla_attention.py"):
        assert port / module in files, module
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_serving_entry_point_loads_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.serving, "
            "repro_torch.core.state, repro_torch.qa.gru, "
            "repro_torch.kernels.lookup.ops, repro_torch.convert, "
            "repro_torch.configs.paper_qa, repro_torch.core.gated, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.models.xla_attention; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


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


@pytest.mark.parametrize("kernel", ["linear_attention",
                                    "gated_linear_attention"])
def test_tensor_core_sources_share_the_hopper_header(kernel):
    """B3's and B8/B9's sources take their TMA and wgmma helpers from
    ``kernels/csrc/hopper.cuh``, which their libraries' names hash."""
    from repro_torch.kernels import build
    source = Path(build.__file__).parent / kernel / "csrc" / f"{kernel}.cu"
    header = Path(build.__file__).parent / "csrc" / "hopper.cuh"
    assert build.sources_of(source) == [source.resolve(), header.resolve()]
