"""Seeded analytic table-tennis flights in `generate_dataset`'s output format, for the
uplifting-trainer tests of the port (tests/test_torch_synthetic.py, test_torch_augment.py,
test_torch_uplifting_train.py, test_torch_uplifting_eval.py).

Each flight crosses the table along x at 3-6 m/s from one end, bounces once on the
opponent's half (restitution 0.85) and lasts 250-500 frames at 500 fps; the spin is
uniform in [-300, 300] rad/s per axis. Simulating real candidates on the CPU costs seconds
per batch (datagen has its own tests); these cost nothing and give the batch assembly,
the cameras and the augmentations realistic inputs.
"""
import numpy as np

G = 9.81
TABLE_TOP = 0.76 + 0.02  # the ball's centre on the table


def analytic_datagen(n: int, seed: int = 0, n_frames: int = 500, n_valid=None) -> dict:
    """n flights; n_valid fixes every flight's valid frames (else 250-500 each)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / 500.0
    positions = np.zeros((n, n_frames, 3), np.float32)
    bounces = np.zeros((n, 4), np.float32)
    n_bounces = np.zeros((n,), np.int64)
    frame_valid = np.zeros((n, n_frames), bool)
    for i in range(n):
        x0, vx = -1.6 + 0.3 * rng.random(), 3.0 + 3.0 * rng.random()
        y0, vy = rng.uniform(-0.3, 0.3), rng.uniform(-0.4, 0.4)
        z0, vz = rng.uniform(1.0, 1.2), rng.uniform(0.0, 1.5)
        # the first time z reaches the table top: z0 + vz t - g t^2 / 2 = TABLE_TOP
        tb = (vz + np.sqrt(vz ** 2 + 2 * G * (z0 - TABLE_TOP))) / G
        vz_b = 0.85 * (G * tb - vz)
        z = np.where(t < tb, z0 + vz * t - G * t ** 2 / 2,
                     TABLE_TOP + vz_b * (t - tb) - G * (t - tb) ** 2 / 2)
        positions[i] = np.stack([x0 + vx * t, y0 + vy * t, z], -1)
        length = int(rng.integers(250, n_frames + 1)) if n_valid is None else n_valid
        frame_valid[i, :length] = True
        if tb < length / 500.0:
            bounces[i, 0], n_bounces[i] = tb, 1
    rotations = np.broadcast_to(rng.uniform(-300, 300, (n, 1, 3)),
                                (n, n_frames, 3)).astype(np.float32)
    return {"positions": positions, "velocities": np.zeros_like(positions),
            "rotations": rotations, "frame_valid": frame_valid, "bounces": bounces,
            "n_bounces": n_bounces, "times": t.astype(np.float32)}
