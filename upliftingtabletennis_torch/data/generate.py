"""Synthetic-dataset generation CLI (port of `upliftingtabletennis_tpu/data/generate.py`).

  python -m upliftingtabletennis_torch.data.generate \
      --num_trajectories 50000 --mode intermediate --direction left_to_right \
      --folder <output root> [--batch 8192] [--seed 0] [--device cuda]

Writes the reference on-disk layout `<folder>/<mode>/<direction>/trajectory_%04d/
{positions,velocities,rotations,times,bounces,Mint,Mext}.npy`, one folder per accepted
trajectory cut to its valid frames, so datasets are interchangeable between engines.
Candidates are simulated in batches on `--device` (`data/datagen.py`).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_trajectories", type=int, default=50000)
    p.add_argument("--folder", type=str, default="syntheticdata")
    p.add_argument("--mode", type=str, default="intermediate")
    p.add_argument("--direction", type=str, default="left_to_right")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from upliftingtabletennis_torch._device import resolve_device
    from upliftingtabletennis_torch.core.physics import FPS
    from upliftingtabletennis_torch.data import datagen as DG

    assert args.mode in DG.MODES, f"mode must be one of {DG.MODES}"
    assert args.direction in DG.DIRECTIONS, f"direction must be one of {DG.DIRECTIONS}"

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    res = DG.generate_dataset(args.num_trajectories, args.mode, args.direction, args.batch,
                              generator=gen, device=dev)
    dt = time.perf_counter() - t0
    n = len(res["positions"])
    print(f"[datagen] {n} valid trajectories in {dt:.1f}s ({n / dt:.1f} traj/s)")

    Mext, Mint = (a.numpy() for a in DG.sim_camera("cpu"))
    out = os.path.join(args.folder, args.mode, args.direction)
    os.makedirs(out, exist_ok=True)
    for i in range(n):
        d = os.path.join(out, f"trajectory_{i:04}")
        os.makedirs(d, exist_ok=True)
        T = int(res["frame_valid"][i].sum())
        np.save(os.path.join(d, "positions.npy"), res["positions"][i][:T])
        np.save(os.path.join(d, "velocities.npy"), res["velocities"][i][:T])
        np.save(os.path.join(d, "rotations.npy"), res["rotations"][i][:T])
        np.save(os.path.join(d, "times.npy"), np.arange(T) / FPS)
        nb = int(res["n_bounces"][i])
        np.save(os.path.join(d, "bounces.npy"), res["bounces"][i][:nb])
        np.save(os.path.join(d, "Mext.npy"), np.broadcast_to(Mext, (T, 4, 4)))
        np.save(os.path.join(d, "Mint.npy"), np.broadcast_to(Mint, (T, 3, 3)))
    print(f"[datagen] saved to {out}")


if __name__ == "__main__":
    main()
