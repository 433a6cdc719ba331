"""Production synthetic-dataset generation: the paper's full recipe.

Port of `upliftingtabletennis_tpu/data/generate_production.py`. Generates the 140k-
trajectory training corpus

  intermediate 50k x {left_to_right, right_to_left}
  first_good    5k x 2    first_short 2.5k x 2    first_long 2.5k x 2
  final_win     5k x 2    final_lose   5k x 2

scaled by --scale, one stacked `.npz` store per (mode, direction) shard at
`<out>/<mode>/<direction>.npz` (`data/synthetic.save_store_npz`, the JAX package's layout:
either package loads the other's shards). Each candidate batch is one launch of S1 on the
card (`data/datagen.generate_dataset`); the draws come from one `torch.Generator` seeded
with --seed, shard after shard (an existing shard is skipped and draws nothing). With
--dp and more than one card, each candidate batch is drawn on every card (a dp mesh over
all of them, `parallel/mesh.py`), card i from its own generator seeded with --seed + i;
with one card --dp changes nothing, as in JAX.

    python -m upliftingtabletennis_torch.data.generate_production --out <root> --scale 1.0
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["RECIPE", "main"]

# (mode, per-direction count)
RECIPE = (
    ("intermediate", 50_000),
    ("first_good", 5_000),
    ("first_short", 2_500),
    ("first_long", 2_500),
    ("final_win", 5_000),
    ("final_lose", 5_000),
)


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--scale", type=float, default=1.0,
                   help="multiply every recipe count (1.0 = the paper's 140k)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--modes", type=str, default=None,
                   help="comma-separated subset of modes (default: all)")
    p.add_argument("--max_seconds_per_shard", type=float, default=0.0,
                   help="> 0: cap each capped-mode shard's generation time (after its first "
                        "batch) and keep whatever was accepted")
    p.add_argument("--capped_modes", type=str, default="final_win",
                   help="comma-separated modes the time cap applies to (final_win accepts "
                        "about 0.2%% of its candidates)")
    p.add_argument("--dp", action="store_true",
                   help="simulate --batch candidates on every card per iteration (a dp "
                        "mesh over all cards; one card: no change)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _dp_devices(device: torch.device):
    """The devices --dp spreads over: every card for a CUDA run, the CPU alone else."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def main(argv=None):
    """Generate the shards; returns one record per shard written: mode, direction,
    accepted, requested, seconds, trajectories_per_s, candidates."""
    args = _parser().parse_args(argv)
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data import synthetic as SYN

    dev = resolve_device(args.device)
    only = set(args.modes.split(",")) if args.modes else None
    mesh, devices = None, _dp_devices(dev) if args.dp else [dev]
    if len(devices) > 1:
        from upliftingtabletennis_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=devices)
        gen = [torch.Generator(device=d).manual_seed(args.seed + i)
               for i, d in enumerate(devices)]
        print(f"[mesh] datagen sharded over {len(devices)} devices", flush=True)
    else:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
    shards = []
    t_start = time.perf_counter()
    for mode, n_ref in RECIPE:
        if only and mode not in only:
            continue
        n = max(int(round(n_ref * args.scale)), 1)
        for direction in DG.DIRECTIONS:
            out = os.path.join(args.out, mode, f"{direction}.npz")
            if os.path.exists(out):
                print(f"[skip] {out} exists", flush=True)
                continue
            t0 = time.perf_counter()
            cap = args.max_seconds_per_shard if mode in args.capped_modes.split(",") else 0.0
            sharded = {} if mesh is None else {"mesh": mesh}
            res = DG.generate_dataset(n, mode, direction, batch=args.batch, max_seconds=cap,
                                      generator=gen, device=dev, **sharded)
            store = SYN.store_from_datagen(res)
            SYN.save_store_npz(out, store)
            dt = time.perf_counter() - t0
            got = len(store)
            shards.append({"mode": mode, "direction": direction, "accepted": got,
                           "requested": n, "seconds": dt, "trajectories_per_s": got / dt,
                           "candidates": res["candidates"]})
            print(f"[done] {mode}/{direction}: {got}/{n} trajectories in {dt:.1f}s "
                  f"({got / dt:.0f} traj/s)", flush=True)
    total = sum(s["accepted"] for s in shards)
    print(f"[total] {total} trajectories in {time.perf_counter() - t_start:.1f}s")
    return shards


if __name__ == "__main__":
    main()
