"""The port, chip_smoke.py and scripts/torch_time_*.py stand alone:
they import torch, numpy and the standard library, nothing of JAX, of the
JAX package, or of the packages a GPU machine may lack; and chip_smoke.py
fails cleanly without a GPU."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "adaptive_classifier_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "safetensors", "transformers", "tokenizers",
           "triton")
ALLOWED_TOP = {"torch", "numpy", "adaptive_classifier_tpu_torch"}

_IMPORT_ALL = f"""
import importlib, json, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import adaptive_classifier_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"imported": names, "loaded": sorted(sys.modules)}}))
"""


def _python(code, cwd, timeout=120):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_without_jax():
    proc = _python(_IMPORT_ALL, REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "adaptive_classifier_tpu_torch.models.encoder" in out["imported"]
    for mod in ("ops.attention_qkv", "ops.knn", "ops.knn_topk", "ops.fusion",
                "ops.matmul_int8", "ops.ffn_int8", "ops.flash_attention",
                "ops.layernorm", "models.encoder_int8", "models.tokenizer",
                "quantization", "memory", "training", "lexical", "convert",
                "models.bpe", "models.hf_tokenizer_adapter", "models.modernbert",
                "strategic", "native", "finetune", "pretrain", "models.wordpiece_trainer",
                "onnx_export", "parallel.mesh", "parallel.multihost", "parallel.sharded_knn",
                "parallel.sharded", "parallel.checkpoint", "parallel.facade"):
        assert f"adaptive_classifier_tpu_torch.{mod}" in out["imported"]
    leaked = [m for m in out["loaded"]
              if m == "adaptive_classifier_tpu" or m.startswith("adaptive_classifier_tpu.")]
    assert leaked == []


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "scripts" / "torch_time_attention.py",
                                         REPO / "scripts" / "torch_time_ffn_int8.py",
                                         REPO / "scripts" / "torch_time_knn.py",
                                         REPO / "tests" / "torch_parallel_helpers.py"]


#: a package a module may import inside a function, where it is installed:
#: the Rust tokenizers runtime, which the adapter uses where it is present
#: and the port's own byte-level BPE replaces where it is not; scipy's erf,
#: which the ONNX interpreter uses where it is present (``math.erf`` where
#: it is not)
OPTIONAL = {"hf_tokenizer_adapter.py": {"tokenizers"}, "onnx_export.py": {"scipy"}}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_imports_are_torch_numpy_stdlib(path):
    tree = ast.parse(path.read_text())
    top_level = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:            # relative import inside the package
                continue
            tops = [node.module.split(".")[0]]
        else:
            continue
        for top in tops:
            if top in OPTIONAL.get(path.name, ()) and id(node) not in top_level:
                continue
            assert top in ALLOWED_TOP or top in sys.stdlib_module_names, (
                f"{path.name}:{node.lineno} imports {top}")


def test_cuda_sources_are_packaged_and_bound():
    """Every csrc file ships with the package, every quoted include exists,
    every C entry point the build module declares is defined by a source,
    and there is a launch counter for each kernel wrapper."""
    import re
    import tomllib
    from fnmatch import fnmatch

    from adaptive_classifier_tpu_torch.ops import _build, launch_counts

    globs = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["adaptive_classifier_tpu_torch"]
    setup_py = (REPO / "setup.py").read_text()
    sources = sorted((PORT / "csrc").iterdir())
    assert {p.suffix for p in sources} == {".cu", ".cuh"}
    text = ""
    for src in sources:
        rel = f"csrc/{src.name}"
        assert any(fnmatch(rel, g) for g in globs), rel
        assert any(fnmatch(rel, g) and f'"{g}"' in setup_py for g in globs), rel
        body = src.read_text()
        for inc in re.findall(r'#include "([^"]+)"', body):
            assert (PORT / "csrc" / inc).exists(), (src.name, inc)
        text += body
    for fn in _build.SIGNATURES:
        assert re.search(rf'extern "C" [^(]*\b{fn}\(', text), fn
    assert set(launch_counts) == {"attention_qkv", "flash_attention",
                                  "oneshot_attention", "add_layer_norm", "knn_sims",
                                  "knn_topk", "matmul_int8", "ffn_int8",
                                  "proj_residual_ln_int8", "attn_ffn_int8"}
    # the kernels call no library (cuBLAS, CUTLASS).  They issue these
    # tensor-core products: int8 x int8 -> int32 in the int8 kernels
    # (mma.sync, and wgmma of 32 and 64 columns defined in int8_hopper.cuh
    # alone, which B2, B3 and B8 issue), bf16 x bf16 with f32
    # accumulation in the bf16 attention tile loops (mma.sync in
    # attention_tile.cuh, wgmma in attention_hopper.cuh), and TF32 with
    # f32 accumulation in B5 (mma.sync) and B4 (wgmma, defined in
    # hopper.cuh), whose operands are split into a TF32 high part and
    # remainder (three products a pair: f32's error, where one TF32 product
    # would move exp(-d²) by ~1e-3)
    code = re.sub(r"//[^\n]*", "", text).lower()
    for word in ("cublas", "cutlass", "wmma"):
        assert word not in code, word
    int8_mma = "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"
    bf16_mma = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
    tf32_mma = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
    tf32_wgmma = "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32"
    int8_wgmma = {f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8"
                  for n in (32, 64)}
    bf16_wgmma = {f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16"
                  for n in (64, 128)}
    assert set(re.findall(r"(?<!w)mma\.sync\.[a-z0-9.]+", code)) == {
        int8_mma, bf16_mma, tf32_mma}
    assert set(re.findall(r"wgmma\.mma_async\.[a-z0-9.]+", code)) == (
        {tf32_wgmma} | int8_wgmma | bf16_wgmma)
    tf32_users = {"knn_topk.cu", "knn_sims.cu", "hopper.cuh"}
    for src in sources:
        body = re.sub(r"//[^\n]*", "", src.read_text()).lower()
        allowed = (int8_wgmma if src.name == "int8_hopper.cuh" else
                   {int8_mma} if "int8" in src.name else
                   {bf16_mma} if src.name == "attention_tile.cuh" else
                   {tf32_mma} if src.name == "knn_topk.cu" else
                   {tf32_wgmma} if src.name == "hopper.cuh" else
                   bf16_wgmma if src.name == "attention_hopper.cuh" else set())
        found = set(re.findall(r"(?<!w)mma\.sync\.[a-z0-9.]+", body)) | set(
            re.findall(r"wgmma\.mma_async\.[a-z0-9.]+", body))
        assert found <= allowed, src.name
        if not allowed and src.name != "knn_sims.cu":
            assert "mma" not in body, src.name
        if src.name not in tf32_users:
            assert "tf32" not in body, src.name
        elif src.name == "knn_topk.cu":
            # every TF32 operand is half of a split: hi . lo, lo . hi, hi . hi
            assert body.count("mma_tf32(") == 4, "one definition and three products"
            assert "tf32_rest(" in body
        elif src.name == "knn_sims.cu":
            # the same split on wgmma: three products a step of 8 columns
            assert body.count("wgmma_m64n128k8_tf32(") == 3
            assert "tf32_rest(" in body


def _run_smoke(cwd, block_jax=True, timeout=300):
    code = ("import runpy, sys\n"
            + (f"for n in {BLOCKED!r}: sys.modules[n] = None\n" if block_jax else "")
            + "sys.argv = ['chip_smoke.py']\n"
            + "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    return _python(code, cwd, timeout=timeout)


def _assert_failed_without_result(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    proc = _run_smoke(REPO)
    _assert_failed_without_result(proc)
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_failed_without_result(_run_smoke(tmp_path, block_jax=False))
