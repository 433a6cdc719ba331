"""P1: the phase split of K2, the fused LN + MixFFN half-block, on the card.

Port of the JAX package's TPU probe `tools/probe_ffn_phases.py` (`variant_kernel`).
It times K2 with one phase removed, interleaved, at the four segformerpp_b2 stage
shapes of the 1600x896 detector at batch 4 (the JAX probe does stages 1-2):

    full       K2 itself (`ops.fused_ffn.fused_ln_ffn`);
    no_dw      the depthwise stencil keeps its centre tap only: h . dw[1, 1] + bdw;
    no_gelu    the full stencil, no GELU;
    no_dwgelu  both removed (LN + fc1 + fc2).

The variants are K2's own kernels (the fused tile kernel, or the split route's
stencil kernel) compiled with another MODE (`ops/csrc/fused_ffn_probe.cu`), run
along the same plan as K2 at that shape (`ops.fused_ffn.ffn_plan`), so the
difference to `full` is the cost of the phase inside the production path. They compute another function on purpose; each is
held against its plain PyTorch version (`ffn_probe_plain`) at K2's limits before it
is timed.

    python -m upliftingtabletennis_torch.tools.probe_ffn_phases [--batch 4] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build
from upliftingtabletennis_torch.ops import fused_ffn as k2
from upliftingtabletennis_torch.tools import _probe

MODES = ("full", "no_dw", "no_gelu", "no_dwgelu")
_MODE_ID = {"no_dw": 1, "no_gelu": 2, "no_dwgelu": 3}  # fused_ffn.cuh k2::Mode
_SOURCE = "fused_ffn_probe.cu"


def ffn_probe_plain(mode, x, H, W, gamma, beta, w1, b1, dw, bdw, w2, b2, eps=1e-6):
    """Plain PyTorch version of one probe mode, with K2's casts (`ln_ffn_plain`, op for
    op, with the mode's phases replaced). Shapes as `ln_ffn_plain`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
    B, N, C = x.shape
    HID = w1.shape[1]
    dt = x.dtype
    xf = x.float()
    y = F.layer_norm(xf, (C,), gamma.float(), beta.float(), eps).to(dt)
    h = (y.float() @ w1.float() + b1.float()).to(dt)
    h = h.float().reshape(B, H, W, HID).permute(0, 3, 1, 2)
    if mode in ("full", "no_gelu"):
        h = F.conv2d(h, dw.float().permute(2, 0, 1).unsqueeze(1), bdw.float(), padding=1,
                     groups=HID)
    else:
        h = h * dw.float()[1, 1].view(1, HID, 1, 1) + bdw.float().view(1, HID, 1, 1)
    if mode in ("full", "no_dw"):
        h = F.gelu(h, approximate="none")
    z = h.permute(0, 2, 3, 1).reshape(B, N, HID).to(dt)
    return (xf + z.float() @ w2.float() + b2.float()).to(dt)


def ffn_probe(mode, x, H: int, W: int, gamma, beta, w1, b1, dw, bdw, w2, b2,
              eps: float = 1e-6):
    """One probe mode of K2: on CUDA, `full` is K2 itself and the other modes K2's kernels
    with those phases removed, along K2's plan (counted in `ffn_probe.launches`);
    on the CPU the plain version. Arguments as `fused_ln_ffn`, after the mode."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
    params = (gamma, beta, w1, b1, dw, bdw, w2, b2)
    if mode == "full":
        return k2.fused_ln_ffn(x, H, W, *params, eps=eps)
    if x.shape[1] != H * W:
        raise ValueError(f"N={x.shape[1]} != H*W={H}*{W}")
    if not _build.uses_kernel(x, "ffn_probe"):
        return ffn_probe_plain(mode, x, H, W, *params, eps=eps)
    args, plan = k2._operands(x, H, W, *params)
    lib = k2._lib(_SOURCE, "uttk_fused_ffn_probe", nargs=1)
    out = k2.run_kernel(lib, "uttk_fused_ffn_probe", (_MODE_ID[mode],), args, plan, H, W, eps,
                        f"ffn_probe({mode})")
    ffn_probe.launches += 1
    return out


ffn_probe.launches = 0


def run(batch: int = 4, stages=None, rounds: int = 5, reps: int = 10, seed: int = 0,
        plain_iters: int = 0) -> dict:
    """Every mode at every stage: its error against its plain version (f32, on the same
    bf16 inputs) at K2's limits, its median device ms over `rounds` interleaved rounds
    of `reps` calls, and the share of `full` each removed phase accounts for; with
    `plain_iters`, also the median device ms of each plain version (f32) over that many
    calls. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the phase probe times the card: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for name, (H, W, C, _, _) in (stages or _probe.B2_STAGES).items():
        B, N, HID = batch, H * W, 4 * C

        def rnd(*shape, std=1.0):
            return _probe.rnd(gen, "cuda", *shape, std=std)

        x = rnd(B, N, C)
        # w1 and w2 as the model passes them: views of torch Linear weights (out, in)
        params = (1 + rnd(C, std=0.1), rnd(C, std=0.1), rnd(HID, C, std=C ** -0.5).t(),
                  rnd(HID, std=0.1), rnd(3, 3, HID, std=1 / 3), rnd(HID, std=0.1),
                  rnd(C, HID, std=HID ** -0.5).t(), rnd(C, std=0.1))
        fns = {m: (lambda m=m: ffn_probe(m, x, H, W, *params)) for m in MODES}
        plan = k2.ffn_plan(B, H, W, C, HID)
        entry = {"shape": {"B": B, "H": H, "W": W, "C": C, "HID": HID}, "route": plan.route,
                 "tile": [plan.th, plan.tw]}
        f32 = [p.float() for p in params]
        for m in MODES:
            got = fns[m]()
            torch.cuda.synchronize()
            want = ffn_probe_plain(m, x.float(), H, W, *f32)
            err, ok = _probe.compare(got, want)
            entry[m] = {"max_abs_err": err, "ok": ok}
            del got, want
            if plain_iters:
                entry[m]["plain_ms"] = _probe.time_interleaved(
                    {m: lambda m=m: ffn_probe_plain(m, x.float(), H, W, *f32)}, plain_iters, 1)[m]
        torch.cuda.empty_cache()
        ms = _probe.time_interleaved(fns, rounds, reps)
        for m in MODES:
            entry[m]["ms"] = ms[m]
        entry["shares"] = _probe.shares(ms, {"stencil": "no_dw", "gelu": "no_gelu",
                                             "stencil_and_gelu": "no_dwgelu"})
        report[name] = entry
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", help="also write the report to this JSON file")
    opts = ap.parse_args()
    report = run(batch=opts.batch)
    for name, e in report.items():
        print(name, e["route"], json.dumps({m: round(e[m]["ms"], 4) for m in MODES}),
              json.dumps({p: round(s, 3) for p, s in e["shares"].items()}), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
