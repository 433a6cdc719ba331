"""What the two phase probes share: seeded bf16 inputs, the k1/k2 limits, interleaved
timing with CUDA events."""
from __future__ import annotations

import statistics

import torch

# |kernel - plain| <= ATOL + RTOL |plain|: the k1/k2 limits of chip_smoke.py
ATOL, RTOL = 6e-2, 2e-2
# (H, W, C, heads, Nkv) of segformerpp_b2's four stages at 1600x896
B2_STAGES = {"stage1": (224, 400, 64, 1, 1400), "stage2": (112, 200, 128, 2, 1400),
             "stage3": (56, 100, 320, 5, 1400), "stage4": (28, 50, 512, 8, 1400)}


def rnd(gen, device, *shape, std=1.0):
    return (torch.randn(*shape, generator=gen, device=device) * std).to(torch.bfloat16)


def compare(got, want):
    """(max |got - want|, within the limits) for a bf16 kernel output against its f32
    plain version."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= ATOL + RTOL * want.float().abs()).all().item())
    return err.max().item(), ok


def time_interleaved(fns: dict, rounds: int, reps: int) -> dict:
    """Median device ms of one call of each function, timed in turns (round by round,
    every function once per round, `reps` calls between two CUDA events)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: statistics.median(t) for name, t in times.items()}


def shares(ms: dict, modes: dict) -> dict:
    """The share of the full kernel's time each removed phase accounts for:
    {phase: (ms[full] - ms[mode]) / ms[full]}."""
    return {phase: (ms["full"] - ms[mode]) / ms["full"] for phase, mode in modes.items()}
