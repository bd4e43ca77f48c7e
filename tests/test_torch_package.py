"""Hygiene of the PyTorch port: it imports neither jax nor the JAX package,
its entry points refuse to run on the CPU unless asked to, and its
kernel policy refuses CUDA kernels for CPU tensors."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.policy import KernelPolicy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro"):
                bad.append((str(f.relative_to(ROOT)), mod))
    assert not bad, bad
    chip_smoke = ROOT / "chip_smoke.py"
    if chip_smoke.exists():
        roots = {m.split(".")[0] for m in _imported_modules(chip_smoke)}
        assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_engine_without_device_raises_when_there_is_no_card(monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.serving import AsrEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.asr_demo_engine(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "asr", "--utterances", "1"])
    assert AsrEngine is not None


def test_kernel_policy_kernel_on_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA"):
        KernelPolicy("kernel").resolve(torch.zeros(2))
    assert KernelPolicy("auto").resolve(torch.zeros(2)) == "ref"
    assert KernelPolicy("ref").resolve(torch.zeros(2)) == "ref"


def test_cuda_kernel_sources_and_bindings_agree():
    """Every C entry point the loader binds is defined in a source, and
    every source is picked up by the build."""
    from repro_torch.kernels import _build
    text = "".join(f.read_text() for f in _build.sources())
    assert {f.stem for f in _build.sources()} == {
        "logmel", "tds_conv", "layernorm", "hypothesis_unit", "int8_matmul",
        "flash_attention"}
    for name, argtypes in _build.SIGNATURES.items():
        assert f'extern "C" int {name}(' in text, name
    assert 'extern "C" const char* repro_error_string(' in text
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
