"""Make `tests/calib_tail_witness.npz`: the closed loop's calibration tail, recorded for the
tests, and print how each package calibrates it.

The input is the `rally_diag.json` that `eval/closed_loop.py` writes, here of the 64-rally
evaluation on the card (`python -m upliftingtabletennis_torch.eval.closed_loop --skip_train
--n_eval 64`, a 400-trajectory store from `generate_production --scale 0.004`). The tail
is the rallies whose RANSAC kept 5-7 inliers. The file keeps, per tail rally: its id, the
fused keypoints (13, 3) in the 1920x1080 frame, their truth (13, 2), and the camera, inlier
count and mean reprojection the card fitted (f32, the port's default draws).

Then each tail rally is calibrated on the CPU:

  jax64        JAX in float64, its draws of PRNGKey(42) (drawn in float64);
  port64       the port in float64 from those draws;
  port32       the port in float32 from those draws;
  card32       the card's camera (read from the file);
  jax32        JAX in float32, its float32 draws of PRNGKey(42);
  port32_j32   the port in float32 from JAX's float32 draws;
  port64_own   the port in float64 from its own default draws (seed 42);

and the port in float64 from the draws of seeds 0..N_SEEDS-1. Each entry prints the inlier
count and the mean reprojection (px) over the visible keypoints. Run from the repository
root:

    JAX_PLATFORMS=cpu python tests/make_calib_tail_witness.py <rally_diag.json> [--write]

(about 1 minute on the CPU; `--write` also writes the witness).
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "calib_tail_witness.npz")
RES = (1920, 1080)
TAIL = (5, 7)  # RANSAC inlier counts of the tail
N_SEEDS = 12


def jax_draws(dtype):
    """(ransac_u (100, 13), polish_normal (2, 32, 8)) of the JAX calibrate_camera with
    PRNGKey(42), as numpy arrays of `dtype` (the JAX function draws in its input's
    dtype)."""
    import jax

    from upliftingtabletennis_tpu.core import calibration as JC

    key = jax.random.PRNGKey(42)
    with jax.enable_x64(dtype == np.float64):
        u = jax.vmap(lambda k: jax.random.uniform(k, (13,), dtype))(
            jax.random.split(key, JC.RANSAC_ITERS))
        normal = np.stack([np.asarray(jax.vmap(lambda k: jax.random.normal(k, (8,), dtype))(
            jax.random.split(jax.random.fold_in(key, 1000 + rd), JC.POLISH_RESTARTS)))
            for rd in range(JC.POLISH_ROUNDS)])
        return np.array(u), normal


def reprojection(Mint, Mext, kp):
    """(mean px over the visible keypoints, in float64)."""
    import torch

    from upliftingtabletennis_torch.core.geometry import TABLE_POINTS, world2img

    p = world2img(*(torch.as_tensor(np.asarray(a), dtype=torch.float64)
                    for a in (TABLE_POINTS, Mext, Mint))).numpy()
    vis = kp[:, 2] > 0
    return float(np.linalg.norm(p[vis] - kp[vis, :2], axis=-1).mean())


def jax_calibrate(kp, dtype):
    import jax
    import jax.numpy as jnp

    from upliftingtabletennis_tpu.core import calibration as JC

    with jax.enable_x64(dtype == np.float64):
        K, E, n = JC.calibrate_camera(jnp.asarray(kp[:, :2], dtype), jnp.asarray(kp[:, 2], dtype),
                                      RES, jax.random.PRNGKey(42), True)
        return np.asarray(K), np.asarray(E), int(n)


def port_calibrate(kp, dtype, draws=None, generator=None):
    import torch

    from upliftingtabletennis_torch.core import calibration as C

    tdt = torch.float64 if dtype == np.float64 else torch.float32
    kw = {}
    if draws is not None:
        kw = dict(ransac_u=torch.as_tensor(draws[0], dtype=tdt),
                  polish_normal=torch.as_tensor(draws[1], dtype=tdt))
    K, E, n = C.calibrate_camera(torch.as_tensor(kp[:, :2], dtype=tdt),
                                 torch.as_tensor(kp[:, 2], dtype=tdt), RES, True,
                                 generator=generator, **kw)
    return K.numpy(), E.numpy(), int(n)


def main(argv):
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    diag = json.load(open(argv[0]))
    tail = [r for r in diag if TAIL[0] <= r["n_inliers"] <= TAIL[1]]
    w = {"rally": np.array([r["rally"] for r in tail]),
         "keypoints": np.array([r["table_kp"] for r in tail], np.float64),
         "truth": np.array([r["table_truth"] for r in tail], np.float64),
         "card_Mint": np.array([r["calib_Mint"] for r in tail], np.float64),
         "card_Mext": np.array([r["calib_Mext"] for r in tail], np.float64),
         "card_n_inliers": np.array([r["n_inliers"] for r in tail]),
         "card_reproj_px": np.array([r["calib_reproj_px"] for r in tail])}
    if "--write" in argv:
        np.savez(OUT, **w)
        print(f"wrote {OUT}: {len(tail)} rallies")
    d64, d32 = jax_draws(np.float64), jax_draws(np.float32)
    table = {}
    for i, rid in enumerate(w["rally"]):
        kp = w["keypoints"][i]
        row = {"jax64": jax_calibrate(kp, np.float64),
               "port64": port_calibrate(kp, np.float64, d64),
               "port32": port_calibrate(kp, np.float32, d64),
               "card32": (w["card_Mint"][i], w["card_Mext"][i], int(w["card_n_inliers"][i])),
               "jax32": jax_calibrate(kp, np.float32),
               "port32_j32": port_calibrate(kp, np.float32, d32),
               "port64_own": port_calibrate(kp, np.float64)}
        table[int(rid)] = {k: (v[2], round(reprojection(v[0], v[1], kp), 2))
                           for k, v in row.items()}
        seeds = [round(reprojection(*port_calibrate(kp, np.float64, generator=torch.Generator()
                                                     .manual_seed(s))[:2], kp), 2)
                 for s in range(N_SEEDS)]
        table[int(rid)]["port64_seeds"] = seeds
        print(int(rid), json.dumps(table[int(rid)]), flush=True)
    for k in ("jax64", "port64", "port32", "card32", "jax32", "port32_j32", "port64_own"):
        px = np.array([table[r][k][1] for r in table])
        print(f"{k:11s} mean {px.mean():7.2f} px, median {np.median(px):6.2f}, "
              f"over 10 px on {int((px > 10).sum())} of {len(px)}")
    seeds = np.array([table[r]["port64_seeds"] for r in table])
    print(f"port64 over {N_SEEDS} seeds: over 10 px on {int((seeds > 10).sum())} of {seeds.size} "
          f"(rally, seed) pairs; mean {seeds.mean():.2f} px")
    return table


if __name__ == "__main__":
    main(sys.argv[1:])
