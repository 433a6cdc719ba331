"""Where the port's streamed product (`gemm_kernel`, `ops/csrc/tiles.cuh`) spends its time
on the card, beside one cuBLAS call (`torch.matmul`) on the same shapes.

`gemm_phases.cu` runs the product's main loop and epilogue with the chunk loads, the
products or the output stores left out (same tiles, warps and ring); this builds it with
nvcc into `upliftingtabletennis_torch/_build/`, runs it, and times `a @ b.t()` in bf16.

    python -m upliftingtabletennis_torch.tools.gemm_phases [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from upliftingtabletennis_torch.ops import _build

SHAPES = ((22400, 1280, 320), (5632, 512, 2048), (8192, 8192, 4096))


def run() -> list:
    """One record per shape: the phases' device us and rates, and cuBLAS's. Needs a CUDA
    device and nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("the GEMM phases are timed on the card: no CUDA device")
    src = Path(__file__).with_suffix(".cu")
    exe = _build.BUILD_DIR / "gemm_phases"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-I", str(_build.CSRC), "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    records = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for rec, (M, N, K) in zip(records, SHAPES):
        a = torch.randn(M, K, device="cuda", dtype=torch.bfloat16)
        b = torch.randn(N, K, device="cuda", dtype=torch.bfloat16)
        for _ in range(3):
            a @ b.t()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            a @ b.t()
        end.record()
        end.synchronize()
        us = 1e3 * start.elapsed_time(end) / 20
        rec.update(cublas_us=us, cublas_tflops=2.0 * M * N * K / us / 1e6)
    return records


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the records to this JSON file")
    opts = ap.parse_args()
    records = run()
    for rec in records:
        print(json.dumps(rec), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
