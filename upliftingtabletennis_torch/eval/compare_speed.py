"""Detector speed harness.

Port of `upliftingtabletennis_tpu/eval/compare_speed.py`:

    python -m upliftingtabletennis_torch.eval.compare_speed [--task ball]
        [--models segformerpp_b0 wasb ...] [--batch 8] [--iters 50] [--device cpu]

Per model at its native input resolution (or `--resolution W H`): milliseconds per batch,
frames per second and the parameter count, on a batch of seeded random input, after a
first forward timed apart (the kernels' build and plans). On the card the forward runs in
bf16 through the port's kernels (an HRNet folds its BatchNorms into bf16 weights at the
first forward, as the detectors do), timed by CUDA events around `iters` forwards; the
card's name and power limit are printed beside the times. On the CPU (`--device cpu`,
f32) the host's clock times the same loop: a CPU time, not a device time.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["card_name", "measure", "main"]


def card_name() -> str:
    """nvidia-smi's "name, power limit" of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def measure(task: str, name: str, batch: int, iters: int, resolution=None, dtype="bfloat16",
            device="cuda"):
    """{"model", "resolution", "sec_per_batch", "fps", "params_M", "first_call_s", "device",
    "dtype"} of the forward of detector `name` (seeded random weights) on a batch of
    `batch` random inputs, averaged over `iters` forwards after the first call (timed
    apart). dtype "bfloat16" or "float32"; the CPU runs f32 whatever is asked, as the
    port's plain path does."""
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.pipeline.interface import init_weights

    dev = resolve_device(device)
    dt = torch.bfloat16 if dtype == "bfloat16" and dev.type == "cuda" else torch.float32
    model, (W, H) = get_detector(name, task, resolution=resolution)
    init_weights(model)
    n_params = sum(p.numel() for p in model.parameters())
    model.eval().to(dev)
    if not getattr(model, "FOLDS_BATCH_NORM", False):
        model.to(dt)
    C = 9 if task == "ball" else 3
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(batch, H, W, C))
                         .astype(np.float32)).to(dev, dt)

    def fwd():
        out = model(x)
        return out[0] if isinstance(out, tuple) else out

    with torch.no_grad():
        t0 = time.perf_counter()
        fwd()  # the first call: the kernels' build and plans, an HRNet's folded weights
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        first = time.perf_counter() - t0
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fwd()
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fwd()
            sec = (time.perf_counter() - t0) / iters
    return {"model": name, "resolution": (W, H), "sec_per_batch": sec, "fps": batch / sec,
            "params_M": n_params / 1e6, "first_call_s": first, "device": str(dev),
            "dtype": str(dt).split(".")[-1]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", choices=["ball", "table"], default="ball")
    p.add_argument("--models", nargs="*", default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--resolution", type=int, nargs=2, default=None)
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                   help="inference dtype on the card (the CPU runs float32)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from upliftingtabletennis_torch.models.factory import BALL_MODELS, TABLE_MODELS

    if resolve_device(args.device).type == "cuda":
        print(f"card: {card_name()}")
    models = args.models or (BALL_MODELS if args.task == "ball" else TABLE_MODELS)
    results = []
    for name in models:
        m = measure(args.task, name, args.batch, args.iters, args.resolution, args.dtype,
                    args.device)
        results.append(m)
        print(f"{m['model']:16s} {m['resolution'][0]}x{m['resolution'][1]}  "
              f"{m['sec_per_batch'] * 1000:8.2f} ms/batch  {m['fps']:8.1f} FPS  "
              f"{m['params_M']:6.2f}M params  (first call {m['first_call_s']:.2f} s; "
              f"{m['device']}, {m['dtype']})")
    return results


if __name__ == "__main__":
    main()
