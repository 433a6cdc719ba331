"""Dataset sanity checks and trajectory plots (port of
`upliftingtabletennis_tpu/data/simulation_check.py`).

  python -m upliftingtabletennis_torch.data.simulation_check --data_dir <dir> \
      [--n_check 5] [--plot out.png] [--device cuda]

`resimulate_check` re-simulates stored trajectories from their first frame's state
(`ops/physics.py:simulate`, one S1 launch per trajectory on the card) and compares the
positions: the integrator must be deterministic and the stored data self-consistent.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def resimulate_check(data_dir: str, n_check: int = 5, atol: float = 1e-4,
                     device="cuda") -> bool:
    """Re-simulate the first `n_check` trajectories of `data_dir` from frame 0's stored
    (r, v, w) and compare every stored position within `atol` (m). Frame 0 already holds
    the reference's initial step, so frame k is k * substeps steps after it."""
    import torch

    from upliftingtabletennis_torch._device import resolve_device
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import physics as S1

    dev = resolve_device(device)
    dirs = sorted(d for d in os.listdir(data_dir) if d.startswith("trajectory_"))[:n_check]
    ok = True
    for d in dirs:
        p = os.path.join(data_dir, d)
        pos = np.load(os.path.join(p, "positions.npy"))
        state0 = P.BallState(*(torch.as_tensor(np.load(os.path.join(p, f))[0],
                                               dtype=torch.float32, device=dev)
                               for f in ("positions.npy", "velocities.npy", "rotations.npy")))
        traj = S1.simulate(state0, len(pos), first_step=False).r.cpu().numpy()
        err = np.abs(traj - pos).max()
        if err > atol:
            print(f"[check] {d}: max resimulation error {err:.2e} > {atol:.0e}")
            ok = False
    return ok


def plot_trajectories_3d(positions_list, save_path=None):
    """3D trajectory plot with the table wireframe."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from upliftingtabletennis_torch.core.geometry import TABLE_CONNECTIONS, TABLE_POINTS

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    for a, b in TABLE_CONNECTIONS:
        pa, pb = TABLE_POINTS[a], TABLE_POINTS[b]
        ax.plot([pa[0], pb[0]], [pa[1], pb[1]], [pa[2], pb[2]], "k-", lw=1)
    for pos in positions_list:
        pos = np.asarray(pos)
        ax.plot(pos[:, 0], pos[:, 1], pos[:, 2], lw=1.5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", required=True)
    p.add_argument("--n_check", type=int, default=5)
    p.add_argument("--plot", type=str, default=None, help="save a 3D plot to this path")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    ok = resimulate_check(args.data_dir, args.n_check, device=args.device)
    print("[check] deterministic re-simulation:", "OK" if ok else "FAILED")
    if args.plot:
        dirs = sorted(d for d in os.listdir(args.data_dir) if d.startswith("trajectory_"))[:8]
        ps = [np.load(os.path.join(args.data_dir, d, "positions.npy")) for d in dirs]
        plot_trajectories_3d(ps, args.plot)
        print(f"[check] plot saved to {args.plot}")


if __name__ == "__main__":
    main()
