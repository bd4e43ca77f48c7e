"""Build and load the port's CUDA kernel library.

Every `kernels/csrc/*.cu` file is compiled by `nvcc` for `sm_90a` (one
process per source, all started together), linked into one shared
library with a plain C interface, and loaded with `ctypes`.  The build
runs at first use, from the checkout's own sources, into `build/kernels/`
at the root of the checkout; the library's file name carries a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads what is there.

Each C entry point takes raw device pointers, sizes and the CUDA stream
(`torch.cuda.current_stream().cuda_stream`) and returns
`cudaGetLastError()` after its launch; `check()` raises on anything but
0.  Building or loading never falls back to anything: without `nvcc` or
a card it raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# C signature of every entry point: (argtypes); each returns an int, the
# launch's cudaError_t (beam_prune_capacity: a count, or minus an error;
# flash_attention_design: which of the flash kernels a launch runs;
# flash_attention_ran: which one the last launch ran, or -1)
SIGNATURES = {
    "logmel_launch": (P, P, P, P, I, I, I, I, P),
    "mfcc_launch": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P),
    "tds_conv_launch": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                        F, P),
    "layernorm_launch": (P, P, P, P, P, P, I, I, F, I, P),
    "rmsnorm_launch": (P, P, P, I, I, F, I, P),
    "flash_attention_launch": (P, P, P, P, I, I, I, I, I, I, I, I, I, F, P),
    "flash_attention_design": (I, I),
    "flash_attention_ran": (),
    "hypothesis_unit_launch": (P, P, P, P, P, P, P, P, I, I, I, F, P),
    "int8_matmul_launch": (P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    "beam_prune_launch": (P, P, P, I, F, P),
    "beam_prune_capacity": (),
}

_lock = threading.Lock()
_lib = None
build_seconds = None       # wall time of the last build (None: loaded as is)
build_log = ""             # nvcc's output of the last build (-Xptxas -v)
builds = 0                 # libraries compiled in this process
loads = 0                  # libraries loaded in this process (`lib`)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or $CUDA_HOME/bin)")


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources (in parallel) and link the library; returns
    its path.  Reuses a library built from identical sources."""
    global build_seconds, build_log, builds
    out = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_so = pathlib.Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernel library failed:\n"
                               f"{link.stdout}")
        os.replace(tmp_so, out)        # atomic: readers never see half a file
    build_seconds = time.perf_counter() - t0
    builds += 1
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib, loads
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            loads += 1
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            handle.repro_error_string.argtypes = [ctypes.c_int]
            handle.repro_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: cudaError {err} "
                           f"({msg})")


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Validate one tensor argument of a CUDA wrapper: CUDA, on `device`,
    of `dtype` and rank `ndim`, contiguous.  The kernels take raw
    pointers and row-major strides, so anything else is refused."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got "
                         f"one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def refuse_grad(name: str, *tensors) -> None:
    """Refuse a launch whose output autograd would have to differentiate.

    Every CUDA wrapper calls this with all of its tensor arguments before
    it launches.  A kernel writes a fresh `torch.empty` through a raw
    pointer, so its output has no `grad_fn`, and a gradient through it
    would go missing without a word.  No kernel has a backward (nor has
    the reference one): training runs the plain versions.  This raises
    rather than falling back to them, which would hide the kernel."""
    import torch
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if t is not None and t.requires_grad:
            raise RuntimeError(
                f"{name}: a CUDA kernel has no backward and was given a "
                f"tensor that requires grad; use KernelPolicy('ref') to "
                f"train")


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on `device`."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
