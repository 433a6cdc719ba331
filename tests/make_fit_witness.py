"""Make `tests/fit_witness_1s.npz`: the JAX fit over 1 s tracks, recorded for the port.

tests/test_fitting.py's topspin and backspin states are simulated by the JAX package in
float32, observed at 50 fps for 0.98 s (50 detections, one every 10 frames of the 500
fps grid) through the simulation camera (`data/datagen.py:sim_camera`), and fitted by the
JAX `fit_trajectory` at `fit_physics`'s defaults (32 starts, 250 Adam steps, 12 LM steps,
502 frames) on the CPU, once for each key in KEYS. The file keeps, per state:

  obs (50, 2), times (50,), truth (50, 3) and the camera (Mint, Mext);
  per key: the draws of `default_inits` (z_t, v_mult, v_noise, w_noise, in the order and
  shapes of the port's `fitting.draw_inits`), and the JAX fit's winner: r_world (50, 3),
  state0 (9,), all_loss (32,), reproj_px, basin_spread_m, its spin class and its mean 3D
  error in cm.

`chip_smoke.py` (phase `fit`) feeds the same observations and draws to the port's fit on
the card and compares the outcome with JAX's; `tests/test_torch_fitting.py` checks that
the file's tracks and draws are what the JAX package gives. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/make_fit_witness.py

(about 3 minutes on the CPU for the eight fits).
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "fit_witness_1s.npz")
STATES = {"topspin": ((-1.1, 0.25, 1.05), (7.0, -0.6, 0.8), (5.0, 90.0, -15.0)),
          "backspin": ((-1.0, -0.2, 1.2), (7.0, 0.4, -0.6), (-10.0, -100.0, 15.0))}
N_OBS, STRIDE, N_STARTS = 50, 10, 32
KEYS = (0, 1, 2, 3)


def n_frames_of(times) -> int:
    """`fit_physics`'s horizon: the last time rounded up to a 0.25 s bucket."""
    return int(np.ceil((float(times.max()) + 1e-3) / 0.25)) * 125 + 2


def track(name):
    """(obs, times, truth, Mint, Mext) of a state, float32 numpy, by the JAX package."""
    import jax.numpy as jnp

    from upliftingtabletennis_tpu.core import geometry as G
    from upliftingtabletennis_tpu.core.physics import BallState, simulate_jit
    from upliftingtabletennis_tpu.data.datagen import sim_camera

    s0 = BallState(*(jnp.asarray(x, jnp.float32) for x in STATES[name]))
    idx = np.arange(N_OBS) * STRIDE
    r = simulate_jit(s0, int(idx[-1]) + 1, 2).r[idx]
    Mext, Mint = sim_camera()
    obs = G.world2img(r, Mext, Mint)
    times = (idx / 500.0).astype(np.float32)
    return tuple(np.asarray(a, np.float32) for a in (obs, times, r, Mint, Mext))


def draws_of(key: int):
    """The draws of the JAX `default_inits(PRNGKey(key), ...)` for N_STARTS starts."""
    import jax

    k_z, k_v, k_w, k_m = jax.random.split(jax.random.PRNGKey(key), 4)
    return {"z_t": jax.random.uniform(k_z, (N_STARTS,), minval=0.85, maxval=1.9),
            "v_mult": jax.random.uniform(k_m, (N_STARTS, 1), minval=0.7, maxval=1.3),
            "v_noise": jax.random.normal(k_v, (N_STARTS, 3)),
            "w_noise": jax.random.normal(k_w, (N_STARTS, 3))}


def spin_class(w0, r_world) -> float:
    """`spin_class_from_fit`: 1.0 if the flight-frame w_y is positive, else 2.0."""
    import jax.numpy as jnp

    from upliftingtabletennis_tpu.core import geometry as G

    w_local = G.transform_rotation_axes(jnp.asarray(w0), jnp.asarray(r_world))
    return 1.0 if float(w_local[1]) > 0 else 2.0


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    from upliftingtabletennis_tpu.core import fitting as F

    out = {}
    for name in STATES:
        obs, times, truth, Mint, Mext = track(name)
        out.update({f"{name}/obs": obs, f"{name}/times": times, f"{name}/truth": truth,
                    f"{name}/Mint": Mint, f"{name}/Mext": Mext})
        for key in KEYS:
            p = f"{name}/key{key}/"
            out.update({p + k: np.asarray(v, np.float32) for k, v in draws_of(key).items()})
            res = F.fit_trajectory(obs, times, np.ones(N_OBS, np.float32), Mint, Mext,
                                   key=jax.random.PRNGKey(key), n_frames=n_frames_of(times))
            r_world = np.asarray(res.r_world, np.float32)
            err = 100 * np.linalg.norm(r_world - truth, axis=-1)
            out.update({p + "r_world": r_world,
                        p + "state0": np.concatenate([np.asarray(x, np.float32)
                                                      for x in res.state0]),
                        p + "all_loss": np.asarray(res.all_loss, np.float32),
                        p + "reproj_px": np.float32(res.reproj_px),
                        p + "basin_spread_m": np.float32(res.basin_spread_m),
                        p + "spin_class": np.float32(spin_class(res.state0.w, r_world)),
                        p + "mean_err_cm": np.float32(err.mean())})
            print(f"{name} key {key}: mean error {err.mean():.4f} cm, reproj "
                  f"{float(res.reproj_px):.4f} px, spin class {out[p + 'spin_class']}",
                  flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
