"""Synthetic uplifting dataset: storage, camera sampling and batch assembly in torch.

Port of `upliftingtabletennis_tpu/data/synthetic.py`. A store holds 500 fps trajectories
(numpy on the host, `store_to_device` puts it on the card once); `assemble_batch` turns
trajectory indices into one training or validation batch on the device:

* fps resampling: train fps ~ randint[20, 65], eval fps 50; positions taken by nearest
  neighbour on the uniform 500 fps grid (round half to even, as `jnp.round`);
* a random camera per trajectory in training: NUM_CAMERA_TRIES candidates (focal
  lengths, distance, azimuth and elevation, look-at jitter, up-vector epsilon) and the
  first whose projection of every valid frame lies in the image and spans more than 15%
  of its width or height, else the last candidate; validation keeps the stored camera;
* a crop to SEQUENCE_LEN frames with a mask, all 13 table keypoints visible.

The random draws are explicit: `draw_batch` takes them from a `torch.Generator` on the
device (the fps and 11 uniform streams per camera candidate), `assemble_batch_from_draws`
is a function of them, and `cameras_from_uniforms` maps [0, 1) uniforms as
`jax.random.uniform` maps its own, so a test can feed JAX's draws. The on-disk layouts
(the reference's `trajectory_%04d/*.npy` directories, one `.npz` per shard) are the JAX
package's, so the shards of either package load in the other.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.core.geometry import (BASE_FX, BASE_FY, HEIGHT, TABLE_HEIGHT,
                                                      TABLE_LENGTH, TABLE_POINTS, TABLE_WIDTH,
                                                      WIDTH, get_Mext, world2img)
from upliftingtabletennis_torch.core.physics import FPS as BLUR_FPS
from upliftingtabletennis_torch.data.datagen import _over_fps

__all__ = ["SEQUENCE_LEN", "RESAMPLE_CAP", "FPS_BOUNDS", "EVAL_FPS", "NUM_CAMERA_TRIES",
           "N_CAMERA_STREAMS", "TrajectoryStore", "store_to_device", "store_from_datagen",
           "save_reference_layout", "save_store_npz", "load_store_npz", "concat_stores",
           "store_from_disk", "split_indices", "draw_camera_uniforms", "cameras_from_uniforms",
           "pick_valid_camera", "BatchDraws", "draw_batch", "assemble_batch_from_draws",
           "assemble_batch"]

SEQUENCE_LEN = 50
RESAMPLE_CAP = 70  # slots for the resampled sequence before the crop (fps <= 65)
FPS_BOUNDS = (20, 65)
EVAL_FPS = 50
NUM_CAMERA_TRIES = 100
N_CAMERA_STREAMS = 11  # the JAX sampler's keys: fx, fy, distance, phi, theta, look-at x and
# y, epsilon, is-back, back azimuth, back side

_PHI0 = float(np.rad2deg(np.arctan2(TABLE_WIDTH / 2, TABLE_LENGTH / 2)))
SAMPLED_PHIS = (_PHI0, _PHI0 + 180.0)
SAMPLED_DISTANCES = (7.0, 17.0)
SAMPLED_THETAS = (30.0, 70.0)
SAMPLED_FX = (0.6 * BASE_FX, 2.0 * BASE_FX)
SAMPLED_FY = (0.6 * BASE_FY, 2.0 * BASE_FY)


class TrajectoryStore(NamedTuple):
    """Stacked, padded 500 fps trajectories (numpy, or torch after `store_to_device`)."""

    blur_positions: np.ndarray  # (N, TB, 3)
    blur_mask: np.ndarray       # (N, TB) bool
    rotations: np.ndarray       # (N, 3) initial spin
    bounces: np.ndarray         # (N, 1) first table-bounce time, -1 if none
    Mint: np.ndarray            # (N, 3, 3) stored simulation camera
    Mext: np.ndarray            # (N, 4, 4)

    def __len__(self):
        return self.blur_positions.shape[0]

    def subset(self, idx):
        return TrajectoryStore(*(np.asarray(f)[idx] for f in self))


def store_to_device(store: TrajectoryStore, device="cuda") -> TrajectoryStore:
    """The store as torch tensors on `device` (float32, the mask bool)."""
    dev = resolve_device(device)
    return TrajectoryStore(*(torch.as_tensor(np.ascontiguousarray(a)).to(
        dev, torch.bool if name == "blur_mask" else torch.float32)
        for name, a in zip(TrajectoryStore._fields, store)))


def store_from_datagen(res: dict, Mext=None, Mint=None) -> TrajectoryStore:
    """A store from `datagen.generate_dataset` output, with the simulation camera unless
    given (Mext (N, 4, 4), Mint (N, 3, 3))."""
    from upliftingtabletennis_torch.data.datagen import sim_camera

    n = res["positions"].shape[0]
    if Mext is None or Mint is None:
        Mext_t, Mint_t = sim_camera("cpu")
        Mext = np.broadcast_to(Mext_t.numpy(), (n, 4, 4))
        Mint = np.broadcast_to(Mint_t.numpy(), (n, 3, 3))
    first_bounce = np.where(res["n_bounces"] > 0, res["bounces"][:, 0],
                            -1.0).astype(np.float32)[:, None]
    return TrajectoryStore(
        blur_positions=res["positions"].astype(np.float32),
        blur_mask=res["frame_valid"].astype(bool),
        rotations=res["rotations"][:, 0].astype(np.float32),
        bounces=first_bounce,
        Mint=np.asarray(Mint, np.float32),
        Mext=np.asarray(Mext, np.float32),
    )


def save_reference_layout(path: str, store: TrajectoryStore):
    """Write the reference's trajectory_%04d/*.npy directories."""
    os.makedirs(path, exist_ok=True)
    for i in range(len(store)):
        d = os.path.join(path, f"trajectory_{i:04}")
        os.makedirs(d, exist_ok=True)
        n = int(store.blur_mask[i].sum())
        np.save(os.path.join(d, "positions.npy"), store.blur_positions[i, :n])
        np.save(os.path.join(d, "times.npy"), np.arange(n) / BLUR_FPS)
        b = store.bounces[i]
        np.save(os.path.join(d, "bounces.npy"), b[b >= 0])
        np.save(os.path.join(d, "rotations.npy"), np.broadcast_to(store.rotations[i], (n, 3)))
        np.save(os.path.join(d, "Mint.npy"), np.broadcast_to(store.Mint[i], (n, 3, 3)))
        np.save(os.path.join(d, "Mext.npy"), np.broadcast_to(store.Mext[i], (n, 4, 4)))


def save_store_npz(path: str, store: TrajectoryStore):
    """One stacked file per shard: one open on load, where the per-trajectory directories
    cost a syscall per file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f: np.asarray(getattr(store, f)) for f in TrajectoryStore._fields})


def load_store_npz(path: str) -> TrajectoryStore:
    with np.load(path) as z:
        return TrajectoryStore(*(z[f] for f in TrajectoryStore._fields))


# fields whose axis 1 is the padded 500 fps time axis
_TIME_AXIS_FIELDS = ("blur_positions", "blur_mask")


def concat_stores(stores) -> TrajectoryStore:
    """Stores concatenated along the trajectory axis, time axes padded to the longest."""
    stores = list(stores)
    TB = max(s.blur_positions.shape[1] for s in stores)

    def padded(a, f):
        if f in _TIME_AXIS_FIELDS and a.shape[1] != TB:
            return np.pad(a, [(0, 0), (0, TB - a.shape[1])] + [(0, 0)] * (a.ndim - 2))
        return a

    return TrajectoryStore(
        *(np.concatenate([padded(np.asarray(getattr(s, f)), f) for s in stores], axis=0)
          for f in TrajectoryStore._fields))


def store_from_disk(path: str, pad_to: Optional[int] = None) -> TrajectoryStore:
    """Read the reference's on-disk layout into a padded store."""
    dirs = sorted(d for d in os.listdir(path) if d.startswith("trajectory_"))
    pos, rot, bnc, mint, mext = [], [], [], [], []
    for d in dirs:
        p = os.path.join(path, d)
        pos.append(np.load(os.path.join(p, "positions.npy")))
        r = np.load(os.path.join(p, "rotations.npy"))
        rot.append(r[0] if r.ndim == 2 else r)
        b = np.load(os.path.join(p, "bounces.npy"))
        bnc.append(b[0] if len(b) else -1.0)
        Mi = np.load(os.path.join(p, "Mint.npy"))
        Me = np.load(os.path.join(p, "Mext.npy"))
        mint.append(Mi[0] if Mi.ndim == 3 else Mi)
        mext.append(Me[0] if Me.ndim == 3 else Me)
    TB = pad_to or max(len(x) for x in pos)
    N = len(pos)
    bp = np.zeros((N, TB, 3), np.float32)
    bm = np.zeros((N, TB), bool)
    for i, x in enumerate(pos):
        n = min(len(x), TB)
        bp[i, :n] = x[:n]
        bm[i, :n] = True
    return TrajectoryStore(bp, bm, np.asarray(rot, np.float32),
                           np.asarray(bnc, np.float32)[:, None], np.asarray(mint, np.float32),
                           np.asarray(mext, np.float32))


def split_indices(n: int, mode: str):
    """70/10/20 train/val/test split over sorted indices."""
    i70, i80 = int(0.7 * n), int(0.8 * n)
    if mode == "train":
        return np.arange(0, i70)
    if mode == "val":
        return np.arange(i70, i80)
    if mode == "test":
        return np.arange(i80, n)
    raise ValueError(mode)


# --- camera sampling ------------------------------------------------------------------
def draw_camera_uniforms(shape, generator: Optional[torch.Generator] = None,
                         device="cuda") -> torch.Tensor:
    """The camera sampler's draws: (N_CAMERA_STREAMS, *shape) uniforms in [0, 1)."""
    return torch.rand((N_CAMERA_STREAMS, *shape), generator=generator,
                      device=resolve_device(device))


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jax.random.uniform's map of [0, 1) draws onto [lo, hi): max(lo, u (hi - lo) + lo),
    the width taken in float32 as JAX takes it."""
    return torch.clamp_min(u * float(np.float32(hi) - np.float32(lo)) + lo, lo)


def cameras_from_uniforms(u: torch.Tensor, back_frac: float = 0.0):
    """(Mint (..., 3, 3), Mext (..., 4, 4)) from the draws u (N_CAMERA_STREAMS, ...).

    back_frac > 0 takes that share of the cameras from behind the table (azimuth 0 or 180
    degrees within the table's corner angle, elevation 30-80 degrees; the elevation reuses
    stream 4's draw over the wider range, as the JAX sampler does)."""
    shape = u.shape[1:]
    fx = _uniform(u[0], *SAMPLED_FX)
    fy = _uniform(u[1], *SAMPLED_FY)
    distance = _uniform(u[2], *SAMPLED_DISTANCES)
    phi = torch.deg2rad(_uniform(u[3], *SAMPLED_PHIS))
    theta = torch.deg2rad(_uniform(u[4], *SAMPLED_THETAS))
    if back_frac > 0.0:
        is_back = u[8] < back_frac
        phi_b = torch.deg2rad(_uniform(u[9], -_PHI0, _PHI0)) + torch.where(
            u[10] < 0.5, 0.0, float(np.pi)).to(u.dtype)
        theta_b = torch.deg2rad(_uniform(u[4], 30.0, 80.0))
        phi = torch.where(is_back, phi_b, phi)
        theta = torch.where(is_back, theta_b, theta)
    lookat = torch.stack([_uniform(u[5], -0.2, 0.2), _uniform(u[6], -0.2, 0.2),
                          torch.full_like(fx, TABLE_HEIGHT)], -1)
    eps = _uniform(u[7], -0.1, 0.1)

    c = torch.stack([distance * torch.sin(theta) * torch.cos(phi),
                     distance * torch.sin(theta) * torch.sin(phi),
                     distance * torch.cos(theta) + TABLE_HEIGHT], -1)
    f = lookat - c
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    f0, f1, f2 = f.unbind(-1)
    ones = torch.ones_like(fx)
    r1 = torch.stack([-f1 / f0 - f2 / f0 * eps, ones, eps], -1)
    r1 = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True)
    u1 = -torch.linalg.cross(f, r1)
    # flip the right vector where the up vector would point down
    r2 = torch.stack([f1 / f0 - f2 / f0 * eps, -ones, eps], -1)
    r2 = r2 / torch.linalg.norm(r2, dim=-1, keepdim=True)
    r = torch.where((u1[..., 2] < 0)[..., None], r2, r1)

    Mext = get_Mext(c, f, r)
    zeros = torch.zeros_like(fx)
    Mint = torch.stack([torch.stack([fx, zeros, torch.full_like(fx, (WIDTH - 1) / 2)], -1),
                        torch.stack([zeros, fy, torch.full_like(fx, (HEIGHT - 1) / 2)], -1),
                        torch.stack([zeros, zeros, ones], -1)], -2)
    assert Mint.shape == (*shape, 3, 3)
    return Mint, Mext


def pick_valid_camera(r_world: torch.Tensor, frame_mask: torch.Tensor, u: torch.Tensor,
                      back_frac: float = 0.0):
    """The first valid of the candidate cameras u (N_CAMERA_STREAMS, B, K) per trajectory
    r_world (B, T, 3) with valid frames frame_mask (B, T), else the last candidate.

    Valid: every valid frame projects inside the image and the projection spans more than
    15% of its width or height. Returns (Mint (B, 3, 3), Mext (B, 4, 4), found (B,),
    pick (B,))."""
    B, K = u.shape[1:]
    Mint, Mext = cameras_from_uniforms(u, back_frac)  # (B, K, ...)
    r_img = world2img(r_world[:, None], Mext, Mint)  # (B, K, T, 2)
    m = frame_mask[:, None, :, None]
    wh = torch.tensor([WIDTH, HEIGHT], dtype=r_img.dtype, device=r_img.device)
    inside = (((r_img >= 0) & (r_img < wh)) | ~m).all(-1).all(-1)  # (B, K)
    big = (torch.where(m, r_img, -float("inf")).amax(2)
           - torch.where(m, r_img, float("inf")).amin(2))
    span_ok = (big[..., 0] > 0.15 * WIDTH) | (big[..., 1] > 0.15 * HEIGHT)
    valid = inside & span_ok
    k = torch.arange(K, device=u.device)
    found = valid.any(1)
    pick = torch.where(found, torch.where(valid, k, K).amin(1), K - 1)
    b = torch.arange(B, device=u.device)
    return Mint[b, pick], Mext[b, pick], found, pick


# --- batch assembly ---------------------------------------------------------------------
def _resample(blur_positions, blur_mask, fps):
    """Nearest-neighbour fps resample on the uniform 500 fps grid: (r_world (B, RESAMPLE_CAP,
    3), mask (B, RESAMPLE_CAP), times (B, RESAMPLE_CAP))."""
    n_blur = blur_mask.sum(1)
    end_time = _over_fps((n_blur - 1).to(torch.float32))  # BLUR_FPS is datagen's FPS
    k = torch.arange(RESAMPLE_CAP, dtype=torch.float32, device=blur_positions.device)[None, :]
    times = k / fps[:, None].to(torch.float32)
    mask = times < end_time[:, None]
    nn = torch.round(times * BLUR_FPS).to(torch.int64)
    nn = torch.minimum(torch.clamp_min(nn, 0), (n_blur - 1)[:, None])
    r_world = torch.gather(blur_positions, 1, nn[..., None].expand(-1, -1, 3))
    times = torch.where(mask, times, 0.0)
    r_world = torch.where(mask[..., None], r_world, 0.0)
    return r_world, mask, times


class BatchDraws(NamedTuple):
    """The draws of one batch: fps (B,) int64 and camera uniforms (N_CAMERA_STREAMS, B,
    NUM_CAMERA_TRIES); both None for a validation batch."""

    fps: Optional[torch.Tensor]
    camera_u: Optional[torch.Tensor]


def draw_batch(n: int, train: bool = True, generator: Optional[torch.Generator] = None,
               device="cuda", n_tries: int = NUM_CAMERA_TRIES) -> BatchDraws:
    """A batch's draws on `device`: fps ~ randint[20, 65] and the cameras' uniforms in
    training; nothing for validation (fps 50, the stored cameras)."""
    dev = resolve_device(device)
    if not train:
        return BatchDraws(None, None)
    fps = torch.randint(FPS_BOUNDS[0], FPS_BOUNDS[1] + 1, (n,), generator=generator, device=dev)
    return BatchDraws(fps, draw_camera_uniforms((n, n_tries), generator, dev))


def assemble_batch_from_draws(store: TrajectoryStore, idx, draws: BatchDraws,
                              train: bool = True, back_frac: float = 0.0) -> dict:
    """Gather, resample, pick the camera and project the trajectories idx of a store on the
    device, cropped to SEQUENCE_LEN, not yet augmented or normalised. Returns the sample
    dict of `data/augment.py`; in training also `camera_pick` (B,) and `camera_found`
    (B,), the picked candidate and whether it was valid."""
    idx = torch.as_tensor(idx, device=store.blur_positions.device)
    bp = store.blur_positions[idx]
    bm = store.blur_mask[idx]
    B = bp.shape[0]
    fps = (draws.fps if train else
           torch.full((B,), EVAL_FPS, dtype=torch.int64, device=bp.device))
    r_world_full, mask_full, times_full = _resample(bp, bm, fps)
    extra = {}
    if train:
        Mint, Mext, found, pick = pick_valid_camera(r_world_full, mask_full, draws.camera_u,
                                                    back_frac)
        extra = {"camera_pick": pick, "camera_found": found}
    else:
        Mint, Mext = store.Mint[idx], store.Mext[idx]

    r_world = r_world_full[:, :SEQUENCE_LEN]
    mask = mask_full[:, :SEQUENCE_LEN]
    times = times_full[:, :SEQUENCE_LEN]
    r_img = world2img(r_world, Mext[:, None], Mint[:, None])
    r_img = torch.where(mask[..., None], r_img, 0.0)
    table = torch.as_tensor(TABLE_POINTS, device=bp.device)[None]
    table_img = world2img(table, Mext[:, None], Mint[:, None])
    table_img = torch.cat([table_img, torch.ones_like(table_img[..., :1])], -1)
    return {"r_img": r_img, "r_world": r_world, "times": times,
            "mask": mask.to(torch.float32), "table_img": table_img, "hits": store.bounces[idx],
            "rotation": store.rotations[idx], "Mint": Mint, "Mext": Mext,
            "blur_positions": bp, "blur_mask": bm.to(torch.float32), **extra}


def assemble_batch(store: TrajectoryStore, idx, train: bool = True, back_frac: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> dict:
    """`assemble_batch_from_draws` with the draws taken from `generator` (on the store's
    device)."""
    draws = draw_batch(len(idx), train, generator, store.blur_positions.device)
    return assemble_batch_from_draws(store, idx, draws, train, back_frac)
