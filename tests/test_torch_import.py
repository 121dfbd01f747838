"""The port stands alone: importing it (and chip_smoke.py) loads neither
jax nor infinitensor_tpu, and no module of it names either."""

import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "infinitensor_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def test_import_loads_no_jax():
    mods = _modules()
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'infinitensor_tpu' or "
        "m.startswith('infinitensor_tpu.'))\n"
        "print(bad)\n")
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|infinitensor_tpu)\b",
                     re.MULTILINE)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert not hits


def test_entry_points_refuse_without_cuda_device(monkeypatch):
    from infinitensor_tpu_torch import LlamaConfig, init_kv_cache
    from infinitensor_tpu_torch.utils.platform import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        init_kv_cache(LlamaConfig.tiny(), 1)
    from infinitensor_tpu_torch import (PagedServingEngine, ServingEngine,
                                        init_paged_kv_cache)
    with pytest.raises(RuntimeError):
        init_paged_kv_cache(LlamaConfig.tiny(), 4, 8, 2)
    for engine in (ServingEngine, PagedServingEngine):
        with pytest.raises(RuntimeError):
            engine({}, LlamaConfig.tiny())
    from infinitensor_tpu_torch.entry import entry
    with pytest.raises(RuntimeError):
        entry()
    from infinitensor_tpu_torch.tools import qmm_bench
    with pytest.raises(SystemExit, match="CUDA"):
        qmm_bench.main([])
    assert resolve_device("cpu").type == "cpu"
    # the JAX package's defaults: a bf16 cache unless kv_quant is asked for
    cache = init_kv_cache(LlamaConfig.tiny(), 1, device="cpu")
    assert cache["k"][0].dtype == torch.bfloat16 and "k_scale" not in cache
    assert init_kv_cache(LlamaConfig.tiny(), 1, device="cpu",
                         kv_quant=True)["k"][0].dtype == torch.int8


def test_kernel_sources_shipped():
    csrc = PKG / "kernels" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "quant_matmul.cu", "quant_matmul_fused.cu", "quant_matmul_chunk.cu",
        "quant_matmul_mma.cu", "quant_matmul_w4a8_mma.cu",
        "quant_matmul_ring.cu", "flash_decode.cu", "paged_flash_decode.cu",
        "paged_flash_decode_ring.cu", "flash_attention.cu", "rmsnorm.cu",
        "band.cu"}
    # the bodies the decode-attention and the group-dot kernels share, and
    # the tensor-core tile's pieces
    assert (csrc / "flash_decode.cuh").exists()
    assert (csrc / "attention_any.cuh").exists()
    assert (csrc / "flash_attention_any.cuh").exists()
    assert (csrc / "quant_matmul.cuh").exists()
    assert (csrc / "mma_tile.cuh").exists()
    # the port's own copy of the tuning table: the keys and columns of the
    # JAX package's (docs/qmm_tune.json), read without that package
    table = json.loads((PKG / "kernels" / "qmm_tune.json").read_text())
    assert table == json.loads((ROOT / "docs" / "qmm_tune.json").read_text())
    assert "qmm_tune.json" in (ROOT / "pyproject.toml").read_text()


def test_gpt2_entry_points_refuse_without_cuda_device(monkeypatch):
    from infinitensor_tpu_torch import (GPT2Config, init_gpt2_cache,
                                        init_gpt2_params, load_gpt2_params)
    from infinitensor_tpu_torch.tools import serving_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPT2Config.tiny()
    with pytest.raises(RuntimeError):
        init_gpt2_cache(cfg, 1)
    with pytest.raises(RuntimeError):
        init_gpt2_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError):
        load_gpt2_params({}, cfg)
    with pytest.raises(RuntimeError):
        serving_bench.main()
    cache = init_gpt2_cache(cfg, 2, device="cpu")
    assert cache["k"][0].shape == (2, 4, 64, 16)
    assert cache["k"][0].dtype == torch.bfloat16 and "k_scale" not in cache
    q8 = init_gpt2_cache(cfg, 2, max_seq=8, kv_quant=True, device="cpu")
    assert q8["k"][0].dtype == torch.int8
    assert q8["k_scale"][0].shape == (2, 4, 8)


def test_graph_modules_are_the_ports_own():
    """The graph slice's modules exist in the port and name only the
    port (the JAX package's jax-free modules are copied, not imported)."""
    for rel in ("core/dtype.py", "core/tensor.py", "core/operator.py",
                "core/graph.py", "core/handler.py", "native/graph_core.py",
                "ops/shape_rules.py", "ops/lowering.py", "utils/config.py",
                "kernels/norms.py", "kernels/band.py",
                "runtime/executor.py", "runtime/runtime.py",
                "models/graph_llama.py"):
        src = (PKG / rel).read_text()
        assert "infinitensor_tpu." not in src.replace(
            "infinitensor_tpu_torch.", ""), rel
    from infinitensor_tpu_torch.core import GraphHandler
    from infinitensor_tpu_torch.runtime.runtime import default_runtime
    assert GraphHandler.__module__ == "infinitensor_tpu_torch.core.handler"
    assert default_runtime().platform == "cuda"
