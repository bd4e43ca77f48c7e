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
        "flash_attention", "beam_prune"}
    for name, argtypes in _build.SIGNATURES.items():
        assert f'extern "C" int {name}(' in text, name
    assert 'extern "C" const char* repro_error_string(' in text
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"


def _top_level_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")}


def test_every_tpu_kernel_and_kernel_function_has_a_port_counterpart():
    """Each module of the JAX package that reaches `pl.pallas_call` has a
    kernel in `ops.KERNEL_MODULES`, and every public function of
    `repro.kernels.ref` and `repro.kernels.ops` one of the same name in
    the port, the mesh helpers included."""
    from repro_torch.kernels import ops, ref
    ref_dir = ROOT / "src" / "repro" / "kernels"
    pallas = set()
    for f in sorted(ref_dir.glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Attribute) and node.attr == "pallas_call":
                pallas.add(f.stem)
    assert len(pallas) == 7, pallas
    assert pallas <= set(ops.KERNEL_MODULES), pallas - set(ops.KERNEL_MODULES)
    for name, port in (("ref", ref), ("ops", ops)):
        want = _top_level_functions(ref_dir / f"{name}.py")
        missing = sorted(f for f in want if not callable(getattr(port, f,
                                                                 None)))
        assert not missing, (name, missing)


def _top_level_public(path):
    """Public top-level functions and classes of a module, and each
    public class's public methods as 'Class.method'."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)) \
                and not n.name.startswith("_"):
            names.add(n.name)
            if isinstance(n, ast.ClassDef):
                names |= {f"{n.name}.{m.name}" for m in n.body
                          if isinstance(m, ast.FunctionDef)
                          and not m.name.startswith("_")}
    return names


@pytest.mark.parametrize("module", [
    "core/ctc", "core/quant", "optim/adamw", "optim/schedules",
    "ckpt/checkpoint", "runtime/fault", "data/pipeline"])
def test_training_modules_have_port_counterparts(module):
    """Every public function, class and method of the training path's
    reference modules has one of the same name in the port's module of
    the same path."""
    import importlib
    port = importlib.import_module("repro_torch." + module.replace("/", "."))
    want = _top_level_public(ROOT / "src" / "repro" / f"{module}.py")
    assert want
    missing = []
    for name in sorted(want):
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, (module, missing)


def test_lm_training_entry_points_have_port_counterparts():
    """`LM.loss_fn`/`param_shapes`, the loss coefficients, the train step,
    the launcher, and the names `repro.optim` exports."""
    from repro_torch import optim
    from repro_torch.launch import steps, train
    from repro_torch.models import LM
    from repro_torch.models import transformer
    for name in ("AdamWConfig", "init", "update", "cosine_with_warmup"):
        assert callable(getattr(optim, name)), name
    for name in ("loss_fn", "param_shapes", "init", "prefill",
                 "decode_step", "init_cache"):
        assert callable(getattr(LM, name, None)), name
    assert transformer.Z_LOSS_COEF == 1e-4
    assert transformer.MOE_AUX_COEF == 0.01
    assert callable(steps.make_train_step) and callable(train.main)


# the port's names for public names of the reference's mesh modules
MESH_RENAMED = {"place_tree": "shard_tree"}
# the reference `Sharder`'s layout methods are GSPMD sharding constraints
# (an activation's layout, left to the compiler); the port's ranks
# compute on their blocks and decide their splits from the blocks'
# shapes and the specs, so these have no counterpart
GSPMD_LAYOUTS = {f"Sharder.{m}" for m in (
    "act", "seq", "attn_q", "attn_kv_chunks", "kv", "heads", "inner",
    "expert", "tokens", "logits")}


@pytest.mark.parametrize("module", [
    "parallel/sharding", "launch/steps", "launch/mesh", "runtime/elastic",
    "parallel/compress", "parallel/pipeline"])
def test_mesh_modules_have_port_counterparts(module):
    """Every public function, class and method of the reference's
    multi-device modules (the LM and serving meshes, elastic restart,
    gradient compression, the pipeline) has a counterpart of the same name (or the
    port's name in MESH_RENAMED) in the port's module of the same path."""
    import importlib
    port = importlib.import_module("repro_torch." + module.replace("/", "."))
    want = _top_level_public(ROOT / "src" / "repro" / f"{module}.py")
    assert want
    missing = []
    for name in sorted(want - GSPMD_LAYOUTS):
        obj = port
        for part in MESH_RENAMED.get(name, name).split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, (module, missing)


def test_sharded_model_functions_have_port_counterparts():
    """The sharded functions of `repro.models.{moe,layers}`: every
    public function whose name or signature speaks of the mesh."""
    from repro_torch.models import layers, moe
    for mod, port in (("moe", moe), ("layers", layers)):
        tree = ast.parse((ROOT / "src" / "repro" / "models"
                          / f"{mod}.py").read_text())
        sharded = {n.name for n in tree.body
                   if isinstance(n, ast.FunctionDef)
                   and not n.name.startswith("_")
                   and ("sharder" in {a.arg for a in n.args.args
                                      + n.args.kwonlyargs}
                        or n.name.endswith(("_ep", "_sharded")))}
        assert sharded, mod
        missing = sorted(f for f in sharded
                         if not callable(getattr(port, f, None)))
        assert not missing, (mod, missing)


# the reference's dry-run and roofline tooling: the port's module of each
# (the HLO walker's counterpart is the op counter); the walker's XLA-text
# functions have none, as the port counts eager ops instead of parsing a
# compiled program
TOOLING = {"launch/dryrun": "launch/dryrun",
           "launch/roofline": "launch/roofline",
           "launch/report": "launch/report",
           "launch/hlo_cost": "launch/op_cost"}
HLO_ONLY = {"analyze_hlo", "parse_computations"}


@pytest.mark.parametrize("module", sorted(TOOLING))
def test_tooling_modules_have_port_counterparts(module):
    """Every public function, class and method of the reference's
    dry-run and roofline modules has one of the same name in the port's
    counterpart (`TOOLING`), apart from the HLO-only functions."""
    import importlib
    port = importlib.import_module(
        "repro_torch." + TOOLING[module].replace("/", "."))
    want = _top_level_public(ROOT / "src" / "repro" / f"{module}.py")
    assert want
    missing = []
    for name in sorted(want - HLO_ONLY):
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, (module, missing)


# the reference's analysis modules with a counterpart of the same path.
# `compat.py` has none: it maps jax API names across jax versions
# (`shard_map`, pallas `CompilerParams`, `AbstractMesh`), and the port
# calls no jax
ANALYSIS = ["analysis/core", "analysis/guards", "analysis/__init__"]


def _dunder_all(path):
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in n.targets):
            return set(ast.literal_eval(n.value))
    return set()


@pytest.mark.parametrize("module", ANALYSIS)
def test_analysis_modules_have_port_counterparts(module):
    """Every public function, class and method (and `__all__` name) of
    the reference's analysis modules has one of the same name in the
    port's module of the same path."""
    import importlib
    name = module.replace("/__init__", "").replace("/", ".")
    port = importlib.import_module("repro_torch." + name)
    path = ROOT / "src" / "repro" / f"{module}.py"
    want = _top_level_public(path) | _dunder_all(path)
    assert want
    missing = []
    for name in sorted(want):
        obj = port
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, (module, missing)


def test_kernel_registry_keys_are_the_cuda_sources():
    from repro_torch.kernels import _build
    from repro_torch.kernels.policy import KERNEL_REGISTRY
    assert set(KERNEL_REGISTRY) == {f.stem for f in _build.sources()}
