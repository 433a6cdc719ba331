"""Write a physics-held-out evaluation set in the TTST on-disk layout.

Port of `upliftingtabletennis_tpu/data/make_synthetic_ttst.py`. The real TTST videos and
annotations are not in the repository, so this simulates held-out trajectories with the
port's datagen (on the card unless `--device cpu`), projects them through the simulation
camera rescaled to the 2560x1440 TTST working resolution, and writes the layout that
`data/ttst.py` and `eval/run_uplifting_eval.py` read
(`<out>/ttst/trajectory_%04d/{r_img, times, Mint, Mext, hits, spin_class}.npy`). The spin
class is the sign of the flight-frame omega_y (topspin 1, backspin 2).

    python -m upliftingtabletennis_torch.data.make_synthetic_ttst --out <root> --num 300
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["write_synthetic_ttst", "main"]


def write_synthetic_ttst(out_root: str, num: int, seed: int = 777, fps: int = 50,
                         modes=("intermediate", "first_good", "first_long"),
                         device="cuda") -> int:
    """Simulate about num / len(modes) accepted trajectories per mode and write the first
    num of at least 8 frames at `fps`. Returns the number written."""
    from upliftingtabletennis_torch.core import geometry as G
    from upliftingtabletennis_torch.data import datagen as DG

    dev = resolve_device(device)
    path = os.path.join(out_root, "ttst")
    os.makedirs(path, exist_ok=True)
    Mext, Mint_sim = DG.sim_camera("cpu")
    Mint = G.rescale_intrinsics(Mint_sim, (1920, 1080), (G.WIDTH, G.HEIGHT))
    gen = torch.Generator(device=dev).manual_seed(seed)
    step = 500 // fps
    i = 0
    per_mode = (num + len(modes) - 1) // len(modes)
    for mode in modes:
        res = DG.generate_dataset(per_mode, mode, "left_to_right", generator=gen, device=dev)
        for k in range(len(res["positions"])):
            if i >= num:
                break
            valid = res["frame_valid"][k]
            pos = res["positions"][k][valid][::step][:50]
            if len(pos) < 8:
                continue
            pos_t = torch.from_numpy(np.ascontiguousarray(pos))
            times = np.arange(len(pos)) / fps
            r_img = G.world2img(pos_t, Mext, Mint).numpy()
            w_local = G.transform_rotation_axes(torch.from_numpy(res["rotations"][k][0]),
                                                pos_t).numpy()
            d = os.path.join(path, f"trajectory_{i:04d}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, "r_img.npy"), r_img)
            np.save(os.path.join(d, "times.npy"), times)
            np.save(os.path.join(d, "hits.npy"), res["bounces"][k][: res["n_bounces"][k]])
            np.save(os.path.join(d, "Mint.npy"), Mint.numpy())
            np.save(os.path.join(d, "Mext.npy"), Mext.numpy())
            np.save(os.path.join(d, "spin_class.npy"), np.array(1.0 if w_local[1] > 0 else 2.0))
            i += 1
    return i


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=300)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    n = write_synthetic_ttst(args.out, args.num, args.seed, device=args.device)
    print(f"wrote {n} trajectories to {os.path.join(args.out, 'ttst')}")
    return n


if __name__ == "__main__":
    main()
