"""Batched synthetic-trajectory generation (the rejection sampler that replaces MuJoCo).

Port of `upliftingtabletennis_tpu/data/datagen.py`: sample B candidate initial
conditions, simulate all of them (one launch of the S1 kernel on the card,
`ops/physics.py`), evaluate the validity rules on every frame, and keep the accepted
rows, gathered on the device. The rules are the JAX module's (and through it the
reference's):

* 6 modes x 2 directions with exact (opponent, own, ground) bounce-count signatures;
* the initial-condition distributions (INIT_*);
* per-frame validity: the mode's out-of-bounds box and the fixed broadcast camera's frame;
* the mode's trajectory cutting rules; net clearance, maximum height, final side and
  minimum length;
* bounce times from run intervals (0.75 x interval midpoint + 0.25 x lowest frame).

The draws come from a `torch.Generator` (`draw_initial_conditions`), and
`initial_conditions_from_draws` maps them to states as the JAX sampler maps its own, so
a test can feed it JAX's. `validate_candidates` takes explicit initial states. Entry
points run on the card unless given `device="cpu"`.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.core import physics as P
from upliftingtabletennis_torch.core.geometry import (NET_TOTAL_HEIGHT, NET_TOTAL_WIDTH,
                                                      TABLE_HEIGHT, TABLE_LENGTH, TABLE_WIDTH,
                                                      get_Mext, world2img)
from upliftingtabletennis_torch.ops import physics as S1

__all__ = ["SIM_WIDTH", "SIM_HEIGHT", "sim_camera", "MODES", "DIRECTIONS", "OOB",
           "BOUNCE_SIGNATURE", "MAX_HITS", "N_FRAMES", "MIN_TRAJ_LEN_FRAMES",
           "draw_initial_conditions", "initial_conditions_from_draws",
           "sample_initial_conditions", "count_hits", "validate_candidates",
           "generate_candidates", "generate_dataset"]

# --- the fixed broadcast-like simulation camera --------------------------------------
SIM_WIDTH, SIM_HEIGHT = 1920, 1080
SIM_FX, SIM_FY = 2033, 2180
_CAMERA_POS = np.array([0.04381194, 8.92938715, 5.40070126])
_CAMERA_UP = np.array([7.81340900e-04, -4.33644716e-01, 9.01083598e-01])
_CAMERA_RIGHT = np.array([-0.99998599, 0.00437903, 0.0029745])


def sim_camera(device="cuda"):
    """(Mext 4x4, Mint 3x3) float32 of the fixed simulation camera on `device`: forward =
    -(right x up), built by get_Mext(c, f, r) in float64."""
    dev = resolve_device(device)
    f = -np.cross(_CAMERA_RIGHT, _CAMERA_UP)
    f = f / np.linalg.norm(f)
    Mext = get_Mext(*(torch.from_numpy(a) for a in (_CAMERA_POS, f, _CAMERA_RIGHT)))
    Mint = torch.tensor([[SIM_FX, 0.0, (SIM_WIDTH - 1) / 2], [0.0, SIM_FY, (SIM_HEIGHT - 1) / 2],
                         [0.0, 0.0, 1.0]], dtype=torch.float64)
    return Mext.float().to(dev), Mint.float().to(dev)


@functools.lru_cache(maxsize=None)
def _camera_on(device: str, dtype: torch.dtype):
    """(Mext, Mint, the frame's (W, H)) on `device` in `dtype`, made once per pair."""
    Mext, Mint = (a.to(device=device, dtype=dtype) for a in sim_camera("cpu"))
    return Mext, Mint, torch.tensor([SIM_WIDTH, SIM_HEIGHT], dtype=dtype, device=device)


# --- constants -------------------------------------------------------------------------
MODES = ("intermediate", "final_win", "final_lose", "first_good", "first_short", "first_long")
DIRECTIONS = ("left_to_right", "right_to_left")

INIT_VEL_SPEED_RANGE = (3.0, 30.0)
INIT_VEL_PHI_DEV = 60.0  # degrees
INIT_VEL_THETA_DEV = (25.0, 60.0)
INIT_ANG_VEL_RANGE = (0.0, 500.0)
MIN_TRAJ_LEN_FRAMES = 100  # 0.2 s at 500 fps
MIN_CUT_TIME = 0.2
MAX_HEIGHT = {"first": 1.4, "other": 1.8}
NET_CLEAR_X = 0.04
HIT_Z_TABLE = TABLE_HEIGHT + 0.04
HIT_Z_GROUND = 0.08
HIT_X_MARGIN = 0.01

OOB = {  # (x, y, z_min) per mode
    "final_lose": (6.0, 3.0, -1.0),
    "final_win": (TABLE_LENGTH / 2, TABLE_WIDTH, 0.7),
    "intermediate": (4.5, 2.5, -1.0),
    "first_good": (2.5, 1.5, -1.0),
    "first_short": (2.5, 1.5, 0.5),
    "first_long": (2.5, 1.5, -1.0),
}
BOUNCE_SIGNATURE = {  # (opponent, own, ground)
    "final_lose": (0, 0, 0),
    "final_win": (2, 0, 0),
    "intermediate": (1, 0, 0),
    "first_good": (1, 1, 0),
    "first_short": (0, 2, 0),
    "first_long": (0, 1, 0),
}
MAX_HITS = 4  # fixed slots per hit category (>= 3 needed by the cutting rules)

N_FRAMES = int(P.MAX_SIMULATION_TIME * P.FPS)  # 500
_FIELDS = ("positions", "velocities", "rotations", "frame_valid", "bounces", "n_bounces")


def _sign(direction: str) -> float:
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
    return 1.0 if direction == "left_to_right" else -1.0


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _over_fps(x: torch.Tensor) -> torch.Tensor:
    """x / FPS as a true division (on CUDA PyTorch multiplies by the reciprocal of a
    Python number)."""
    return x / torch.full_like(x, float(P.FPS))


# --- initial conditions ----------------------------------------------------------------
def draw_initial_conditions(n: int, generator: Optional[torch.Generator] = None,
                            device="cuda", dtype=torch.float32) -> torch.Tensor:
    """The sampler's draws: (10, n) uniforms in [0, 1) on `device`, one row per quantity
    (the JAX sampler's ten keys)."""
    return torch.rand((10, n), generator=generator, device=resolve_device(device), dtype=dtype)


def initial_conditions_from_draws(u: torch.Tensor, mode: str, direction: str) -> P.BallState:
    """Initial states (n, 3) from the draws u (10, n): the position in the serve or rally
    region, a velocity aimed at the opponent's side within the INIT_VEL_* cone, and a
    spin of uniform direction and magnitude."""
    _check_mode(mode)
    is_first, sign_x = "first" in mode, _sign(direction)

    def uniform(i, lo, hi):
        """jax.random.uniform's map of [0, 1) onto [lo, hi): the bounds in u's dtype, then
        max(lo, u (hi - lo) + lo). Number bounds are subtracted on the host in that dtype."""
        if torch.is_tensor(lo):
            return torch.maximum(lo, u[i] * (hi - lo) + lo)
        width = np.float32 if u.dtype == torch.float32 else np.float64
        return torch.clamp_min(u[i] * float(width(hi) - width(lo)) + lo, lo)

    if is_first:
        x = uniform(0, 1.0, 2.5) * sign_x
        y = uniform(1, -1.5, 1.5)
        z = uniform(2, 0.8, 1.6)
        c_y = torch.where(y > 0, torch.full_like(y, TABLE_WIDTH / 2), -TABLE_WIDTH / 2)
        c_x = TABLE_LENGTH / 2 * sign_x
    else:
        x = uniform(0, 0.1, 4.0) * sign_x
        y = uniform(1, -2.0, 2.0)
        over_table = (torch.abs(x) < TABLE_LENGTH / 2) & (torch.abs(y) < TABLE_WIDTH / 2)
        z = torch.where(over_table, uniform(2, 0.8, 1.8), uniform(3, 0.5, 1.8))
        c_y = 0.0
        c_x = -TABLE_LENGTH / 2 * sign_x
    r = torch.stack([x, y, z], -1)

    # aim toward the opponent-side target point
    base_phi = 180.0 + torch.rad2deg(torch.atan2(y - c_y, x - c_x))
    base_theta = 90.0 - torch.rad2deg(torch.atan2(z - TABLE_HEIGHT, torch.abs(x - c_x)))
    below = z < TABLE_HEIGHT
    lo_dev, hi_dev = INIT_VEL_THETA_DEV
    min_theta = torch.where(below, torch.clamp_min(base_theta - lo_dev, 90.0),
                            torch.clamp_min(base_theta - lo_dev, 10.0))
    max_theta = torch.where(below, torch.clamp_max(base_theta + hi_dev, 170.0),
                            torch.clamp_max(base_theta + hi_dev, 150.0))
    speed = uniform(4, *INIT_VEL_SPEED_RANGE)
    phi = torch.deg2rad(uniform(5, base_phi - INIT_VEL_PHI_DEV, base_phi + INIT_VEL_PHI_DEV))
    theta = torch.deg2rad(uniform(6, min_theta, max_theta))
    v = torch.stack([speed * torch.sin(theta) * torch.cos(phi),
                     speed * torch.sin(theta) * torch.sin(phi),
                     speed * torch.cos(theta)], -1)

    wspeed = uniform(7, *INIT_ANG_VEL_RANGE)
    wphi = uniform(8, 0.0, 2 * np.pi)
    wtheta = uniform(9, 0.0, np.pi)
    w = torch.stack([wspeed * torch.sin(wtheta) * torch.cos(wphi),
                     wspeed * torch.sin(wtheta) * torch.sin(wphi),
                     wspeed * torch.cos(wtheta)], -1)
    return P.BallState(r, v, w)


def sample_initial_conditions(n: int, mode: str, direction: str,
                              generator: Optional[torch.Generator] = None,
                              device="cuda") -> P.BallState:
    """n initial states (n, 3) float32 on `device`, drawn from `generator` (on that
    device)."""
    dev = resolve_device(device)
    return initial_conditions_from_draws(draw_initial_conditions(n, generator, dev), mode,
                                         direction)


# --- bounce detection ------------------------------------------------------------------
def _interval_hits(mask, z, valid):
    """Up to MAX_HITS closed True intervals of mask (B, T) within `valid`: (times
    (B, MAX_HITS), closed (B, MAX_HITS), count (B,)), each time 0.75 x the interval's
    midpoint + 0.25 x its lowest frame, over FPS. An interval counts once the mask has
    returned to False inside the valid region."""
    B, T = mask.shape
    m = mask & valid
    prev = torch.cat([torch.zeros_like(m[:, :1]), m[:, :-1]], 1)
    starts = m & ~prev  # the first frame of an interval
    ends_next = ~m & prev & valid  # the frame after an interval's end
    sid = torch.cumsum(starts, 1)
    idx = torch.arange(T, device=mask.device)[None, :]
    times, closed = [], []
    for h in range(MAX_HITS):
        in_h = m & (sid == h + 1)
        start = torch.where(in_h, idx, T + 1).amin(1)
        end_next = ends_next & (sid == h + 1)
        has_end = end_next.any(1)
        end = torch.where(end_next, idx, T + 1).amin(1) - 1
        zin = torch.where(in_h & (idx <= end[:, None]), z, torch.full_like(z, float("inf")))
        argmin_z = torch.argmin(zin, 1)
        t_hit = (_over_fps(0.75 * (end + start).to(z.dtype) / 2.0)
                 + _over_fps(0.25 * argmin_z.to(z.dtype)))
        times.append(torch.where(has_end, t_hit, torch.zeros_like(t_hit)))
        closed.append(has_end)
    times, closed = torch.stack(times, 1), torch.stack(closed, 1)
    return times, closed, closed.sum(1)


def count_hits(positions, valid, direction):
    """Opponent-table, own-table and ground hits of positions (B, T, 3) over the valid
    frames (B, T); direction the string or its sign (+1.0 = left_to_right). Returns
    {"opponent", "own", "ground"} -> (times, closed, count)."""
    x, y, z = positions.unbind(-1)
    s = _sign(direction) if isinstance(direction, str) else direction
    xs = x * s  # the opponent's side is xs < 0 in the signed frame
    opp = (-HIT_X_MARGIN > xs) & (xs > -TABLE_LENGTH / 2)
    own = (TABLE_LENGTH / 2 > xs) & (xs > HIT_X_MARGIN)
    low = z < HIT_Z_TABLE
    on_y = torch.abs(y) < TABLE_WIDTH / 2
    return {name: _interval_hits(m, z, valid)
            for name, m in (("opponent", low & on_y & opp), ("own", low & on_y & own),
                            ("ground", z <= HIT_Z_GROUND))}


def _first_false(mask):
    """Index of the first False along axis 1, or T if none. mask: (B, T)."""
    T = mask.shape[1]
    idx = torch.arange(T, device=mask.device)[None, :]
    return torch.where(~mask, idx, T).amin(1)


# --- validation ------------------------------------------------------------------------
_OOB_TABLE = {m: np.array(OOB[m], np.float32) for m in MODES}  # as the JAX tables hold them


def validate_candidates(state0: P.BallState, mode: str, direction: str) -> dict:
    """Simulate the initial states (n, 3) for N_FRAMES frames and evaluate every rule.

    Returns: positions, velocities, rotations (n, N_FRAMES, 3); times (N_FRAMES,); frame_valid
    (n, N_FRAMES) the frames kept after the out-of-bounds, in-frame and cutting rules;
    bounces (n, MAX_HITS) the sorted table-hit times (0-padded); n_bounces (n,); accept
    (n,)."""
    _check_mode(mode)
    sign_x = _sign(direction)
    is_first = "first" in mode
    traj = S1.simulate(state0, N_FRAMES)
    r, v, w = (t.transpose(0, 1) for t in traj)  # (n, T, 3)
    n, T = r.shape[:2]
    dev = r.device
    times = _over_fps(torch.arange(T, dtype=torch.float32, device=dev))
    idx = torch.arange(T, device=dev)[None, :]
    x, y, z = r.unbind(-1)
    correct_side = (x * sign_x) < 0

    # per-frame out-of-bounds rule of the mode
    ox, oy, oz = (float(c) for c in _OOB_TABLE[mode])
    box = (torch.abs(x) > ox) | (torch.abs(y) > oy)
    zlt = z < oz
    if mode == "final_lose":
        oob = box
    elif mode in ("intermediate", "final_win"):
        oob = correct_side & (box | zlt)
    elif mode == "first_short":
        oob = box | zlt
    else:  # first_good, first_long
        oob = correct_side & box

    # in the fixed camera's frame
    Mext, Mint, size = _camera_on(str(dev), r.dtype)
    r_img = world2img(r, Mext, Mint)
    in_frame = ((r_img >= 0) & (r_img < size)).all(-1)

    # frames are saved until the first violation
    n_saved = _first_false(~oob & in_frame)
    saved = idx < n_saved[:, None]
    zmax = torch.where(saved, z, torch.full_like(z, -float("inf"))).amax(1)
    height_ok = zmax <= MAX_HEIGHT["first" if is_first else "other"]

    hits = count_hits(r, saved, sign_x)
    t_opp, c_opp, n_opp = hits["opponent"]
    t_own, c_own, n_own = hits["own"]
    t_gnd, c_gnd, n_gnd = hits["ground"]
    t_grid = times.to(r.dtype)[None, :]
    zero = torch.zeros_like(n_opp)

    def cut_at(t_hit, use):
        """The frame count when cutting strictly before time t_hit."""
        n_cut = (saved & (t_grid < t_hit[:, None])).sum(1) - 1
        return torch.where(use, n_cut, n_saved)

    def ge(t, c, i):
        return c[:, i] & (t[:, i] >= MIN_CUT_TIME)

    if mode == "final_win":  # cut at the 3rd opponent hit, else at the ground
        use1 = ge(t_opp, c_opp, 2)
        use2 = ~use1 & ge(t_gnd, c_gnd, 0)
        n_keep = torch.where(use2, cut_at(t_gnd[:, 0], use2), cut_at(t_opp[:, 2], use1))
        counts = (torch.where(use1, torch.clamp_max(n_opp, 2), n_opp), n_own,
                  torch.where(use1 | use2, zero, n_gnd))
    elif mode == "first_good":  # cut at the 2nd opponent hit, else at the ground
        use1 = ge(t_opp, c_opp, 1)
        use2 = ~use1 & ge(t_gnd, c_gnd, 0)
        n_keep = torch.where(use2, cut_at(t_gnd[:, 0], use2), cut_at(t_opp[:, 1], use1))
        counts = (torch.where(use1, torch.clamp_max(n_opp, 1), n_opp), n_own,
                  torch.where(use1 | use2, zero, n_gnd))
    elif mode == "first_short":  # the 3rd own hit, else the 1st opponent hit, else ground
        use1 = ge(t_own, c_own, 2)
        use2 = ~use1 & ge(t_opp, c_opp, 0)
        use3 = ~use1 & ~use2 & ge(t_gnd, c_gnd, 0)
        n_keep = cut_at(t_own[:, 2], use1)
        n_keep = torch.where(use2, cut_at(t_opp[:, 0], use2), n_keep)
        n_keep = torch.where(use3, cut_at(t_gnd[:, 0], use3), n_keep)
        counts = (torch.where(use1 | use2, zero, n_opp),
                  torch.where(use1, torch.clamp_max(n_own, 2), n_own),
                  torch.where(use1 | use2 | use3, zero, n_gnd))
    else:  # intermediate, final_lose, first_long: cut at the ground
        use = ge(t_gnd, c_gnd, 0)
        n_keep = cut_at(t_gnd[:, 0], use)
        counts = (n_opp, n_own, torch.where(use, zero, n_gnd))

    frame_valid = idx < n_keep[:, None]
    len_ok = (n_saved >= MIN_TRAJ_LEN_FRAMES) & (n_keep >= MIN_TRAJ_LEN_FRAMES)

    # net clearance over the kept frames
    near_net = frame_valid & (torch.abs(x) < NET_CLEAR_X)
    max_h_net = torch.where(near_net, z, torch.full_like(z, -float("inf"))).amax(1)
    min_w_net = torch.where(near_net, torch.abs(y), torch.full_like(y, float("inf"))).amin(1)
    net_fail = near_net.any(1) & (max_h_net < NET_TOTAL_HEIGHT) & (min_w_net < NET_TOTAL_WIDTH / 2)

    # the final side
    last_x = x.gather(1, torch.clamp_min(n_keep - 1, 0)[:, None])[:, 0]
    side_ok = (last_x * sign_x < 0) if mode in ("final_lose", "first_long") \
        else torch.ones_like(len_ok)

    sig = BOUNCE_SIGNATURE[mode]
    sig_ok = (counts[0] == sig[0]) & (counts[1] == sig[1]) & (counts[2] == sig[2])
    accept = len_ok & height_ok & ~net_fail & side_ok & sig_ok

    # the sorted table-bounce times inside the kept region
    keep_t = _over_fps(n_keep.to(torch.float32)).to(r.dtype)
    all_t = torch.cat([t_opp, t_own], 1)
    all_valid = torch.cat([c_opp, c_own], 1) & (all_t < keep_t[:, None])
    all_t = torch.where(all_valid, all_t, torch.full_like(all_t, float("inf")))
    bounces = torch.sort(all_t, 1).values[:, :MAX_HITS]
    finite = torch.isfinite(bounces)
    return {"positions": r, "velocities": v, "rotations": w, "times": times,
            "frame_valid": frame_valid, "bounces": torch.where(finite, bounces, 0.0),
            "n_bounces": finite.sum(1), "accept": accept}


def generate_candidates(n: int, mode: str, direction: str,
                        generator: Optional[torch.Generator] = None, device="cuda") -> dict:
    """Sample n candidates on `device` and evaluate every rule (`validate_candidates`)."""
    return validate_candidates(sample_initial_conditions(n, mode, direction, generator, device),
                               mode, direction)


def generate_dataset(num_trajectories: int, mode: str = "intermediate",
                     direction: str = "left_to_right", batch: int = 4096,
                     max_seconds: float = 0.0, mesh=None, generator=None,
                     device="cuda") -> dict:
    """Sample batches until `num_trajectories` are accepted (a host loop), keeping each
    batch's accepted rows by a gather on the device. Returns numpy arrays cut to
    num_trajectories: positions, velocities, rotations (N, 500, 3), frame_valid (N, 500),
    bounces (N, MAX_HITS), n_bounces (N,) and times (500,); and the counts `candidates`
    (simulated) and `accepted_total` (accepted, before the per-batch and final cuts). max_seconds > 0 bounds the
    wall time after the first batch and returns what was accepted so far. `generator`
    (on `device`) defaults to seed 0.

    mesh: a ('dp', 'mp') `parallel.mesh.Mesh`: each dp device draws its own batch of
    `batch` candidates per iteration from its own generator and compacts it, and the
    accepted rows are concatenated in device order (`device` is then ignored).
    `generator` is then one `torch.Generator` per dp device, on it (a single generator
    serves a one-device mesh); the default seeds device i's with i."""
    _check_mode(mode)
    if mesh is not None:
        from upliftingtabletennis_torch.parallel.mesh import dp_devices

        devs = dp_devices(mesh)
        if generator is None:
            gens = [torch.Generator(device=d).manual_seed(i) for i, d in enumerate(devs)]
        elif isinstance(generator, torch.Generator):
            gens = [generator]
        else:
            gens = list(generator)
        if len(gens) != len(devs):
            raise ValueError(f"{len(gens)} generator(s) for a mesh of {len(devs)} dp devices")
    else:
        dev = resolve_device(device)
        devs = [dev]
        gens = [generator if generator is not None
                else torch.Generator(device=dev).manual_seed(0)]
    out = {k: [] for k in _FIELDS}
    times, total, t0 = None, 0, None
    candidates = accepted = 0
    max_keep = max(batch // 8, 64)  # acceptance rates are a few percent
    while total < num_trajectories:
        if max_seconds and t0 is not None and time.perf_counter() - t0 > max_seconds:
            break
        # every device's batch is launched before any of them is read back
        cands = [generate_candidates(batch, mode, direction, g, d) for d, g in zip(devs, gens)]
        kept = [torch.nonzero(cand["accept"])[:, 0] for cand in cands]
        candidates += batch * len(cands)
        accepted += sum(len(idx) for idx in kept)
        if t0 is None:
            t0 = time.perf_counter()  # the first batch's build is not budget
        for cand, idx in zip(cands, kept):
            idx = idx[:max_keep]
            for k in out:
                out[k].append(cand[k][idx].cpu().numpy())
            times = cand["times"].cpu().numpy()
            total += len(idx)
    res = {k: np.concatenate(v)[:num_trajectories] for k, v in out.items()}
    res.update(times=times, candidates=candidates, accepted_total=accepted)
    return res
