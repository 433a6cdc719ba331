"""P2: the phase split of K1, the fused attention half-block, on the card.

Port of the JAX package's TPU probe `tools/probe_attn_phases.py` (`variant_kernel`).
It times K1 with one phase removed, interleaved, at the four segformerpp_b2 stage
shapes of the 1600x896 detector at batch 4 (the JAX probe does stages 1-2):

    full        K1 itself (`ops.fused_attention.fused_attention_block`);
    no_softmax  w = logits / Nkv rounded to bf16: no max, no exp, no normalisation;
    no_ln       y = x: no LayerNorm.

The variants are K1's own kernels (`ops/csrc/fused_attention_probe.cu`): no_softmax
the attention kernel compiled with another MODE, no_ln the production kernels
without the LayerNorm launch. So the difference to `full` is the cost of the phase
inside the production path. They compute another function on purpose;
each is held against its plain PyTorch version (`attention_probe_plain`) at K1's
limits before it is timed.

    python -m upliftingtabletennis_torch.tools.probe_attn_phases [--batch 4] [--out FILE]
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from upliftingtabletennis_torch.ops import _build
from upliftingtabletennis_torch.ops import fused_attention as k1
from upliftingtabletennis_torch.tools import _probe

MODES = ("full", "no_softmax", "no_ln")
_MODE_ID = {"no_softmax": 1, "no_ln": 2}  # fused_attention.cuh k1::Mode
_SOURCE = "fused_attention_probe.cu"


def attention_probe_plain(mode, x, heads, gamma, beta, wq, bq, k, v, wp, bp, eps=1e-6):
    """Plain PyTorch version of one probe mode, with K1's casts (`attention_block_plain`,
    op for op, with the mode's phase replaced). Shapes as `attention_block_plain`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
    B, N, C = x.shape
    hd = C // heads
    dt = x.dtype
    xf = x.float()
    if mode == "no_ln":
        y = xf.to(dt)
    else:
        y = F.layer_norm(xf, (C,), gamma.float(), beta.float(), eps).to(dt)
    q = (y.float() @ wq.float() + bq.float()).to(dt).reshape(B, N, heads, hd)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.to(dt).float()) * hd ** -0.5
    if mode == "no_softmax":
        w = (logits * (1.0 / logits.shape[-1])).to(dt)
    else:
        w = torch.softmax(logits, dim=-1).to(dt)
    o = torch.einsum("bhnm,bmhd->bnhd", w.float(), v.to(dt).float())
    o = o.to(dt).reshape(B, N, C)
    return (xf + o.float() @ wp.float() + bp.float()).to(dt)


def attention_probe(mode, x, H: int, W: int, heads: int, gamma, beta, wq, bq, k, v, wp, bp,
                    eps: float = 1e-6):
    """One probe mode of K1: on CUDA, `full` is K1 itself and the other modes K1's kernel
    with that phase removed (counted in `attention_probe.launches`); on the CPU the plain
    version. Arguments as `fused_attention_block`, after the mode."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
    params = (gamma, beta, wq, bq, k, v, wp, bp)
    if mode == "full":
        return k1.fused_attention_block(x, H, W, heads, *params, eps=eps)
    if x.shape[1] != H * W:
        raise ValueError(f"N={x.shape[1]} != H*W={H}*{W}")
    if not _build.uses_kernel(x, "attention_probe"):
        return attention_probe_plain(mode, x, heads, *params, eps=eps)
    if x.shape[2] != 64 * heads:
        raise ValueError("the probe kernels are instantiated for head dim 64 only")
    args, dims = k1._operands(x, heads, *params)
    lib = k1._lib(_SOURCE, "uttk_fused_attention_probe", nargs=1)
    out = k1.run_kernel(lib, "uttk_fused_attention_probe", (_MODE_ID[mode],), args, dims, eps,
                        f"attention_probe({mode})")
    attention_probe.launches += 1
    return out


attention_probe.launches = 0


def run(batch: int = 4, stages=None, rounds: int = 5, reps: int = 10, seed: int = 0,
        plain_iters: int = 0) -> dict:
    """Every mode at every stage: its error against its plain version (f32, on the same
    bf16 inputs) at K1's limits, its median device ms over `rounds` interleaved rounds
    of `reps` calls, and the share of `full` each removed phase accounts for; with
    `plain_iters`, also the median device ms of each plain version (f32) over that many
    calls. Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the phase probe times the card: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for name, (H, W, C, heads, Nkv) in (stages or _probe.B2_STAGES).items():
        B, N, hd = batch, H * W, C // heads

        def rnd(*shape, std=1.0):
            return _probe.rnd(gen, "cuda", *shape, std=std)

        x = rnd(B, N, C)
        # wq and wp as the model passes them: views of torch Linear weights (out, in)
        params = (1 + rnd(C, std=0.1), rnd(C, std=0.1), rnd(C, C, std=C ** -0.5).t(),
                  rnd(C, std=0.1), rnd(B, Nkv, heads, hd), rnd(B, Nkv, heads, hd),
                  rnd(C, C, std=C ** -0.5).t(), rnd(C, std=0.1))
        fns = {m: (lambda m=m: attention_probe(m, x, H, W, heads, *params)) for m in MODES}
        entry = {"shape": {"B": B, "H": H, "W": W, "C": C, "heads": heads, "Nkv": Nkv}}
        f32 = [p.float() for p in params]
        for m in MODES:
            got = fns[m]()
            torch.cuda.synchronize()
            want = attention_probe_plain(m, x.float(), heads, *f32)
            err, ok = _probe.compare(got, want)
            entry[m] = {"max_abs_err": err, "ok": ok}
            del got, want
            if plain_iters:
                entry[m]["plain_ms"] = _probe.time_interleaved(
                    {m: lambda m=m: attention_probe_plain(m, x.float(), heads, *f32)}, plain_iters,
                    1)[m]
        torch.cuda.empty_cache()
        ms = _probe.time_interleaved(fns, rounds, reps)
        for m in MODES:
            entry[m]["ms"] = ms[m]
        entry["shares"] = _probe.shares(ms, {"softmax": "no_softmax", "layernorm": "no_ln"})
        report[name] = entry
    return report


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", help="also write the report to this JSON file")
    opts = ap.parse_args()
    report = run(batch=opts.batch)
    for name, e in report.items():
        print(name, json.dumps({m: round(e[m]["ms"], 4) for m in MODES}),
              json.dumps({p: round(s, 3) for p, s in e["shares"].items()}), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
