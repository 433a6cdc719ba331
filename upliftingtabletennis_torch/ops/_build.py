"""One-time build of the port's CUDA kernels into `upliftingtabletennis_torch/_build/`.

Each source under `ops/csrc/` is compiled by `nvcc` for `sm_90a` into its
own shared library with a plain C interface, loaded with `ctypes`. No
PyTorch header is included, so a cold build takes seconds rather than the
minutes a `torch.utils.cpp_extension` build costs. All missing libraries
are compiled in parallel, one `nvcc` per source. A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
a stale one is never loaded.

Nothing here runs at import: the build happens at a kernel's first launch
(or when `build()` is called, as `chip_smoke.py` does). A failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("fused_attention.cu", "fused_ffn.cu", "fused_conv.cu", "flash_attention.cu", "nms.cu",
           "dwconv.cu", "fused_attention_probe.cu", "fused_ffn_probe.cu", "physics.cu")
# No --use_fast_math: it would change expf and erff.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Mirrors of csrc/tiles.cuh, for the launch plans computed in Python (ops/fused_attention.py,
# ops/fused_ffn.py): rows of a block's tile, depth and row stride of a streamed chunk, the
# dynamic shared memory a block may use on sm_90, and the LayerNorm's and the product's tiles.
BM, KC, PAD = 128, 64, 8
LDK = KC + PAD
SMEM_LIMIT = 232448
LN_ROWS = 32  # rows per block of the LayerNorm kernel
GEMM_TILE, GEMM_KC, GEMM_STAGES = 128, 64, 3  # the streamed product: 128 x 128 tiles


def gemm_smem() -> int:
    """Dynamic shared memory of one block of `gemm_kernel` (tiles.cuh `gemm_smem`)."""
    return 2 * GEMM_STAGES * 2 * GEMM_TILE * (GEMM_KC + PAD)


_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked in CUDA_HOME, PATH and /usr/local/cuda/bin)")


def _lib_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source whose library is missing, in parallel.

    Returns {source: ptxas report} for the sources compiled by this call
    (empty for those already built). Raises RuntimeError on a failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources if not _lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for s in todo:
        out = _lib_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)
    reports, failed = {}, []
    for s, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed for {s} (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[s] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, building it first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_lib_path(source)))
            lib.uttk_error_string.argtypes = [ctypes.c_int]
            lib.uttk_error_string.restype = ctypes.c_char_p
            _loaded[source] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (a refused launch never runs)."""
    if status != 0:
        msg = lib.uttk_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} ({msg})")


def uses_kernel(t: torch.Tensor, name: str) -> bool:
    """Whether a wrapper launches its kernel for `t`: True on CUDA, False on the CPU
    (the plain version), and an error on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return True


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these operands (grad mode on and one of
    them requires grad)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def call_on_device(t: torch.Tensor, fn):
    """fn(stream handle) on t's device with its current stream (the kernels launch on the
    current device); the device is switched only when it is not already current."""
    if t.device.index == torch.cuda.current_device():
        return fn(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(t.device):
        return fn(torch.cuda.current_stream().cuda_stream)


def operand(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    """A kernel operand: checked for shape and bf16, contiguous and 32-byte aligned."""
    if t.dtype is torch.bfloat16 and t.shape == shape and t.is_contiguous() \
            and not t.data_ptr() % 32:
        return t
    if t.shape != torch.Size(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 32:
        t = t.clone()
    return t
