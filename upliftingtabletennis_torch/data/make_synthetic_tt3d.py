"""Write a physics-held-out evaluation set in the TT3D on-disk layout.

Port of `upliftingtabletennis_tpu/data/make_synthetic_tt3d.py`. The real TT3D dataset is
external, so this simulates held-out trajectories with the port's datagen, projects them
through three TT3D-style cameras (back, side, oblique) and writes the layout that
`data/tt3d.py` and `eval/run_uplifting_eval.py --tt3d_dir` read:

  <out>/tt3d/data/evaluation/{view}[_no_noise]/NNNN.csv   (u,v,X,Y,Z,Timestamp)
  <out>/tt3d/data/evaluation/{view}.yaml                  (rvec,tvec,f,h,w)

World points are stored premultiplied by the TT3D change of coordinates and the cameras
as rvec/tvec with Mext = Rt(yaml) @ TRANS, as the reader undoes them. The noisy variants
add NOISE_PX Gaussian noise (`np.random.default_rng(seed)`) to (u, v). Needs PyYAML and
scipy.

    python -m upliftingtabletennis_torch.data.make_synthetic_tt3d --out <root> --num 40
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.core.geometry import TABLE_HEIGHT
from upliftingtabletennis_torch.data.tt3d import TRANS

__all__ = ["VIEWS", "write_synthetic_tt3d", "main"]

# (distance m, azimuth deg from +x, height m) per view
VIEWS = {
    "back": (7.5, 0.0, 2.5),
    "side": (6.0, 90.0, 2.2),
    "oblique": (7.0, 45.0, 2.6),
}
FOCAL, IMG_W, IMG_H = 1900.0, 1920.0, 1080.0
EVAL_FPS = 100  # TT3D tracks are about 100 fps
NOISE_PX = 1.5


def _look_at_extrinsic(cam_pos, target):
    """Mext (4x4) looking from cam_pos at target, z up."""
    f = target - cam_pos
    f = f / np.linalg.norm(f)
    up = np.array([0.0, 0.0, 1.0])
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    Mext = np.eye(4)
    Mext[0, :3], Mext[1, :3], Mext[2, :3] = r, -u, f
    Mext[:3, 3] = -Mext[:3, :3] @ cam_pos
    return Mext


def _inv_rodrigues(R):
    """Rotation matrix -> rotation vector, robust near a half turn (the back view)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(R).as_rotvec()


def write_synthetic_tt3d(out_root: str, num: int, seed: int = 31,
                         modes=("intermediate", "first_good"), device="cuda") -> int:
    """Simulate the trajectories once (at least 10 frames at EVAL_FPS) and write each view
    with and without noise. Returns the number of trajectories."""
    import yaml

    from upliftingtabletennis_torch.data import datagen as DG

    dev = resolve_device(device)
    base = os.path.join(out_root, "tt3d", "data", "evaluation")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    trajs = []
    per_mode = (num + len(modes) - 1) // len(modes)
    step = 500 // EVAL_FPS
    for mode in modes:
        res = DG.generate_dataset(per_mode, mode, "left_to_right", generator=gen, device=dev)
        for k in range(len(res["positions"])):
            pos = res["positions"][k][res["frame_valid"][k]][::step][:50]
            if len(pos) >= 10:
                trajs.append(pos)
    trajs = trajs[:num]

    for view, (dist, az_deg, height) in VIEWS.items():
        az = np.deg2rad(az_deg)
        cam = np.array([dist * np.cos(az), dist * np.sin(az), height])
        Mext = _look_at_extrinsic(cam, np.array([0.0, 0.0, TABLE_HEIGHT]))
        Mint = np.array([[FOCAL, 0, IMG_W / 2], [0, FOCAL, IMG_H / 2], [0, 0, 1]])
        Rt = Mext @ np.linalg.inv(TRANS)  # Rt(yaml) @ TRANS == Mext
        with open(os.path.join(base, f"{view}.yaml"), "w") as f:
            yaml.safe_dump({"rvec": [float(v) for v in _inv_rodrigues(Rt[:3, :3])],
                            "tvec": [float(v) for v in Rt[:3, 3]],
                            "f": FOCAL, "h": IMG_H, "w": IMG_W}, f)
        for noise in (True, False):
            d = os.path.join(base, view if noise else f"{view}_no_noise")
            os.makedirs(d, exist_ok=True)
            for i, pos in enumerate(trajs):
                hom = np.concatenate([pos, np.ones((len(pos), 1))], -1)
                ch = (Mext @ hom.T).T
                uv = (Mint @ (ch[:, :3] / ch[:, 3:4]).T).T
                uv = uv[:, :2] / uv[:, 2:3]
                if noise:
                    uv = uv + rng.normal(0, NOISE_PX, uv.shape)
                xyz = (TRANS @ hom.T).T[:, :3]  # stored in the TT3D frame
                times = np.arange(len(pos)) / EVAL_FPS
                rows = ["u,v,X,Y,Z,Timestamp"] + [
                    f"{uv[t, 0]:.3f},{uv[t, 1]:.3f},{xyz[t, 0]:.6f},{xyz[t, 1]:.6f},"
                    f"{xyz[t, 2]:.6f},{times[t]:.6f}" for t in range(len(pos))]
                with open(os.path.join(d, f"{i:04d}.csv"), "w") as f:
                    f.write("\n".join(rows))
    return len(trajs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, default=40)
    p.add_argument("--seed", type=int, default=31)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    n = write_synthetic_tt3d(args.out, args.num, args.seed, device=args.device)
    print(f"wrote {n} trajectories x 3 views x 2 noise variants under "
          f"{os.path.join(args.out, 'tt3d')}")
    return n


if __name__ == "__main__":
    main()
