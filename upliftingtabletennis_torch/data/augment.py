"""Detection-noise augmentations of the uplifting trainer, batched in torch.

Port of `upliftingtabletennis_tpu/data/augment.py`: six augmentations over fixed-shape
padded batches, applied in the reference's order by `train_augment`, then the
normalisation of pixel coordinates by (WIDTH, HEIGHT):

  motion_blur -> randomize_detections -> random_stop -> random_detection
  -> random_missing -> table_missing -> normalize_img_coords

Each augmentation is `fn(sample, draws..., strength) -> sample` with its random draws
explicit, and `draw_augment` takes all of them from a `torch.Generator`: uniforms in
[0, 1) and standard normals of the JAX function's shapes, so a test can feed JAX's.
An augmentation whose strength or probability is 0 returns its input and draws nothing
(motion_blur, random_detection, random_missing, table_missing), as the JAX functions
return early.

Sample fields (batched, T = 50): r_img (B, T, 2) px, r_world (B, T, 3), times (B, T) s,
mask (B, T) {0, 1}, table_img (B, 13, 3) px + visibility, hits (B, 1) the first bounce
time, blur_positions (B, TB, 3) and blur_mask (B, TB) the 500 fps source, Mint (B, 3, 3),
Mext (B, 4, 4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from upliftingtabletennis_torch.core.geometry import HEIGHT, KEYPOINT_INVISIBLE, WIDTH, world2img
from upliftingtabletennis_torch.core.physics import FPS as BLUR_FPS

__all__ = ["AugmentConfig", "motion_blur", "randomize_detections", "random_stop",
           "random_detection", "random_missing", "table_missing", "normalize_img_coords",
           "draw_augment", "train_augment", "eval_augment"]


class AugmentConfig(NamedTuple):
    """Noise hyperparameters (the paper's defaults)."""

    blur_strength: float = 0.4
    randomize_std: float = 2.0
    stop_prob: float = 0.5
    randdet_prob: float = 0.0
    randmiss_prob: float = 0.05
    tablemiss_prob: float = 0.05


def _wh(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor([WIDTH, HEIGHT], dtype=torch.float32, device=x.device)


def motion_blur(sample: dict, u: torch.Tensor, strength: float) -> dict:
    """Each detection replaced by a true position drawn (u (B, T) uniform) within +-strength
    of the gaps to its neighbours on the 500 fps grid, reprojected."""
    if strength == 0:
        return sample
    times = sample["times"]
    mask = sample["mask"] > 0.5
    B, T = times.shape
    length = mask.sum(1)
    idx = torch.arange(T, device=times.device)[None, :]
    prev_t = torch.where(idx - 1 >= 0, torch.roll(times, 1, 1), times)
    next_t = torch.where(idx + 1 < length[:, None], torch.roll(times, -1, 1), times)
    lo_t = times + strength * (prev_t - times)
    hi_t = times + strength * (next_t - times)

    # the grid is uniform at BLUR_FPS: valid indices are [ceil(lo fps), floor(hi fps)]
    n_blur = (sample["blur_mask"] > 0.5).sum(1)[:, None]
    lo_i = torch.ceil(lo_t * BLUR_FPS - 1e-6).to(torch.int64)
    hi_i = torch.floor(hi_t * BLUR_FPS + 1e-6).to(torch.int64)
    lo_i = torch.minimum(torch.clamp_min(lo_i, 0), n_blur - 1)
    hi_i = torch.minimum(torch.clamp_min(hi_i, 0), n_blur - 1)
    pick = lo_i + torch.floor(u * (hi_i - lo_i + 1).to(torch.float32)).to(torch.int64)
    pick = torch.minimum(torch.maximum(pick, lo_i), hi_i)

    new_world = torch.gather(sample["blur_positions"], 1, pick[..., None].expand(-1, -1, 3))
    new_img = world2img(new_world, sample["Mext"][:, None], sample["Mint"][:, None])
    m = mask[..., None]
    return {**sample, "r_world": torch.where(m, new_world, sample["r_world"]),
            "r_img": torch.where(m, new_img, sample["r_img"])}


def randomize_detections(sample: dict, n_ball: torch.Tensor, n_table: torch.Tensor,
                         std: float) -> dict:
    """Gaussian pixel noise of std px on the ball (n_ball (B, T, 2) standard normals) and
    the table keypoints (n_table (B, 13, 2))."""
    tab = sample["table_img"]
    return {**sample, "r_img": sample["r_img"] + std * n_ball,
            "table_img": torch.cat([tab[..., :2] + std * n_table, tab[..., 2:]], -1)}


def random_stop(sample: dict, u_do: torch.Tensor, u_len: torch.Tensor,
                stop_prob: float) -> dict:
    """With probability stop_prob (u_do (B,)) cut the sequence 4 or more frames after the
    first bounce, the length after it drawn by u_len (B,): the opponent's return."""
    times, mask = sample["times"], sample["mask"] > 0.5
    B, T = times.shape
    do = u_do < stop_prob
    hit_time = sample["hits"][:, 0]
    has_hit = hit_time > 0
    hit_ind = torch.argmin(torch.abs(times - hit_time[:, None]) + 1e6 * (~mask), 1)
    seq_len = mask.sum(1)
    room = seq_len - hit_ind
    can = room >= 4
    # the length after the hit ~ randint[4, room]
    len_after = 4 + torch.floor(u_len * torch.clamp_min(room - 3, 1).to(torch.float32)).to(
        torch.int64)
    cut = hit_ind + len_after
    apply = do & has_hit & can
    idx = torch.arange(T, device=times.device)[None, :]
    new_mask = mask & torch.where(apply[:, None], idx < cut[:, None], True)
    m = new_mask[..., None]
    return {**sample, "mask": new_mask.to(sample["mask"].dtype),
            "r_img": torch.where(m, sample["r_img"], 0.0),
            "r_world": torch.where(m, sample["r_world"], 0.0),
            "times": torch.where(new_mask, times, 0.0)}


def random_detection(sample: dict, u_ball: torch.Tensor, pts_ball: torch.Tensor,
                     u_table: torch.Tensor, pts_table: torch.Tensor, p: float) -> dict:
    """Valid detections (u_ball (B, T) < p) and table keypoints (u_table (B, 13) < p)
    replaced by uniform points of the image (pts_* uniforms (..., 2))."""
    if p == 0:
        return sample
    wh = _wh(u_ball)
    swap_ball = (u_ball < p) & (sample["mask"] > 0.5)
    tab = sample["table_img"]
    swap_tab = u_table < p
    return {**sample,
            "r_img": torch.where(swap_ball[..., None], pts_ball * wh, sample["r_img"]),
            "table_img": torch.cat([torch.where(swap_tab[..., None], pts_table * wh,
                                                tab[..., :2]), tab[..., 2:]], -1)}


def random_missing(sample: dict, u: torch.Tensor, p: float) -> dict:
    """Valid frames dropped with probability p (u (B, T)), the survivors compacted to the
    left in time order (a stable sort)."""
    if p == 0:
        return sample
    mask = sample["mask"] > 0.5
    B, T = mask.shape
    keep = mask & ~((u < p) & mask)
    ar = torch.arange(T, device=mask.device)[None, :]
    order = torch.argsort(torch.where(keep, ar, T + ar), dim=1, stable=True)

    def g(x):
        return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1])
                            if x.ndim == 3 else order)

    new_mask = ar < keep.sum(1)[:, None]
    m3 = new_mask[..., None]
    return {**sample, "mask": new_mask.to(sample["mask"].dtype),
            "r_img": torch.where(m3, g(sample["r_img"]), 0.0),
            "r_world": torch.where(m3, g(sample["r_world"]), 0.0),
            "times": torch.where(new_mask, g(sample["times"]), 0.0)}


def table_missing(sample: dict, u: torch.Tensor, pts: torch.Tensor, p: float) -> dict:
    """Table keypoints (u (B, 13) < p) marked invisible, their coordinates uniform points of
    the image (pts (B, 13, 2) uniforms)."""
    if p == 0:
        return sample
    tab = sample["table_img"]
    miss = u < p
    coords = torch.where(miss[..., None], pts * _wh(u), tab[..., :2])
    vis = torch.where(miss, float(KEYPOINT_INVISIBLE), tab[..., 2])
    return {**sample, "table_img": torch.cat([coords, vis[..., None]], -1)}


def normalize_img_coords(sample: dict) -> dict:
    """Pixel coordinates divided by (WIDTH, HEIGHT)."""
    wh = _wh(sample["r_img"])
    tab = sample["table_img"]
    return {**sample, "r_img": sample["r_img"] / wh,
            "table_img": torch.cat([tab[..., :2] / wh, tab[..., 2:]], -1)}


def draw_augment(B: int, T: int, cfg: AugmentConfig = AugmentConfig(),
                 generator: Optional[torch.Generator] = None, device="cuda",
                 n_table: int = 13) -> dict:
    """The draws of `train_augment` for a batch (B, T), per augmentation in its order; an
    augmentation that `cfg` turns off draws nothing (its entry is None)."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {
        "motion_blur": (rand(B, T),) if cfg.blur_strength != 0 else None,
        "randomize_detections": (randn(B, T, 2), randn(B, n_table, 2)),
        "random_stop": (rand(B), rand(B)),
        "random_detection": ((rand(B, T), rand(B, T, 2), rand(B, n_table),
                              rand(B, n_table, 2)) if cfg.randdet_prob != 0 else None),
        "random_missing": (rand(B, T),) if cfg.randmiss_prob != 0 else None,
        "table_missing": ((rand(B, n_table), rand(B, n_table, 2))
                          if cfg.tablemiss_prob != 0 else None),
    }


def train_augment(sample: dict, cfg: AugmentConfig = AugmentConfig(),
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> dict:
    """The training pipeline in the reference's order, then the normalisation. The draws
    come from `draws` (`draw_augment`'s layout) or else from `generator`."""
    if draws is None:
        B, T = sample["mask"].shape
        draws = draw_augment(B, T, cfg, generator, sample["mask"].device,
                             sample["table_img"].shape[1])
    d = draws
    if d["motion_blur"] is not None:
        sample = motion_blur(sample, *d["motion_blur"], cfg.blur_strength)
    sample = randomize_detections(sample, *d["randomize_detections"], cfg.randomize_std)
    sample = random_stop(sample, *d["random_stop"], cfg.stop_prob)
    if d["random_detection"] is not None:
        sample = random_detection(sample, *d["random_detection"], cfg.randdet_prob)
    if d["random_missing"] is not None:
        sample = random_missing(sample, *d["random_missing"], cfg.randmiss_prob)
    if d["table_missing"] is not None:
        sample = table_missing(sample, *d["table_missing"], cfg.tablemiss_prob)
    return normalize_img_coords(sample)


def eval_augment(sample: dict) -> dict:
    """The validation pipeline: the normalisation only."""
    return normalize_img_coords(sample)
