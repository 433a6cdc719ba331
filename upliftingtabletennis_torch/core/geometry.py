"""Camera geometry and table constants in torch.

Port of the parts of `upliftingtabletennis_tpu/core/geometry.py` that the rally
path, the physics fit and the uplifting trainer use: the constants, the world -> camera
-> image projection, `get_Mext`, the camera's location and axes, the flight frame of the
spin transforms and `rescale_intrinsics`. Every function is written against the
trailing dimensions and broadcasts over leading batch dimensions. The 3x3 and 4x4
products are matmuls in the input's dtype, f32 on the card under PyTorch's default of
no TF32 (the JAX module runs them at `Precision.HIGHEST`).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["WIDTH", "HEIGHT", "MAX_FPS", "BASE_FX", "BASE_FY", "TABLE_HEIGHT", "TABLE_POINTS",
           "NUM_TABLE_KEYPOINTS", "KEYPOINT_VISIBLE", "KEYPOINT_INVISIBLE", "TABLE_WIDTH",
           "TABLE_LENGTH", "NET_HEIGHT_ABOVE_TABLE", "NET_TOTAL_HEIGHT", "NET_TOTAL_WIDTH",
           "TABLE_CONNECTIONS", "to_homogeneous", "world2cam", "cam2img", "world2img",
           "get_Mext", "get_camera_location", "get_forward", "get_up", "get_right",
           "transform_rotation_axes", "inverse_transform_rotation_axes", "rescale_intrinsics"]

# The uplifting data's working resolution (the synthetic cameras, TTST); inference runs
# at 1920x1080 (`pipeline/interface.py`).
HEIGHT, WIDTH = 1440, 2560
# RoPE time base: the smallest timestep the rotary time embedding resolves.
MAX_FPS = 500
# Focal lengths regressed from a broadcast video.
BASE_FX, BASE_FY = 2710, 2907

# ITTF table dimensions in metres.
TABLE_HEIGHT = 0.76
TABLE_WIDTH = 1.525
TABLE_LENGTH = 2.74
NET_POST_OFFSET = 0.1525
NET_HEIGHT_ABOVE_TABLE = 0.1525
NET_TOTAL_HEIGHT = TABLE_HEIGHT + NET_HEIGHT_ABOVE_TABLE
NET_TOTAL_WIDTH = TABLE_WIDTH + 2 * NET_POST_OFFSET

KEYPOINT_VISIBLE = 1
KEYPOINT_INVISIBLE = 0

# The 13 table and net keypoints in world coordinates: origin at the table centre on
# the floor, z up, x along the table's length, y along its width.
TABLE_POINTS = np.array(
    [
        [-TABLE_LENGTH / 2, TABLE_WIDTH / 2, TABLE_HEIGHT],   # 0 close left
        [-TABLE_LENGTH / 2, -TABLE_WIDTH / 2, TABLE_HEIGHT],  # 1 close right
        [0.0, TABLE_WIDTH / 2, TABLE_HEIGHT],                 # 2 centre left
        [0.0, -TABLE_WIDTH / 2, TABLE_HEIGHT],                # 3 centre right
        [TABLE_LENGTH / 2, TABLE_WIDTH / 2, TABLE_HEIGHT],    # 4 far left
        [TABLE_LENGTH / 2, -TABLE_WIDTH / 2, TABLE_HEIGHT],   # 5 far right
        [0.0, TABLE_WIDTH / 2 + NET_POST_OFFSET, TABLE_HEIGHT],       # 6 net left bottom
        [0.0, -(TABLE_WIDTH / 2 + NET_POST_OFFSET), TABLE_HEIGHT],    # 7 net right bottom
        [0.0, 0.0, TABLE_HEIGHT],                             # 8 net centre bottom
        [0.0, TABLE_WIDTH / 2 + NET_POST_OFFSET, NET_TOTAL_HEIGHT],   # 9 net left top
        [0.0, -(TABLE_WIDTH / 2 + NET_POST_OFFSET), NET_TOTAL_HEIGHT],  # 10 net right top
        [-TABLE_LENGTH / 2, 0.0, TABLE_HEIGHT],               # 11 close centre
        [TABLE_LENGTH / 2, 0.0, TABLE_HEIGHT],                # 12 far centre
    ],
    dtype=np.float32,
)
NUM_TABLE_KEYPOINTS = 13
# The table's wireframe as pairs of TABLE_POINTS indices.
TABLE_CONNECTIONS = (
    (0, 2), (2, 4), (1, 3), (3, 5), (0, 1), (4, 5),
    (6, 2), (2, 3), (3, 7), (6, 9), (7, 10), (9, 10),
    (11, 8), (12, 8),
)


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """Append a one along the last dimension."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M (..., i, j) applied to v (..., j), broadcasting."""
    return (M @ v[..., None])[..., 0]


def _align_matrix(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Match a matrix's batch dims (*Bm, r, c) to the LEADING batch dims of points
    (*Bv, d): a camera batch (B, 4, 4) applies to points (B, T, 3), shared over T."""
    extra = (v.ndim - 1) - (M.ndim - 2)
    if M.ndim > 2 and extra > 0:
        M = M.reshape(*M.shape[:-2], *((1,) * extra), *M.shape[-2:])
    return M


def world2cam(r_world: torch.Tensor, Mext: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> camera coordinates through Mext (..., 4, 4)."""
    r_h = to_homogeneous(r_world)
    r_cam = _matvec(_align_matrix(Mext, r_h), r_h)
    return r_cam[..., :3] / r_cam[..., 3:4]


def cam2img(r_cam: torch.Tensor, Mint: torch.Tensor) -> torch.Tensor:
    """Camera points (..., 3) -> pixels through the top-left 3x3 block of Mint."""
    K = Mint[..., :3, :3]
    r_img = _matvec(_align_matrix(K, r_cam), r_cam)
    return r_img[..., :2] / r_img[..., 2:3]


def world2img(r_world: torch.Tensor, Mext: torch.Tensor, Mint: torch.Tensor) -> torch.Tensor:
    """World (..., 3) -> pixels (..., 2)."""
    return cam2img(world2cam(r_world, Mext), Mint)


def get_Mext(c: torch.Tensor, f: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """4x4 extrinsics from the camera position c, forward f and right r: the rows of R
    are [right; up; forward] with up = normalize(f x r)."""
    up = torch.linalg.cross(f, r)
    up = up / torch.linalg.norm(up, dim=-1, keepdim=True)
    R = torch.stack([r, up, f], dim=-2)
    t = -_matvec(R, c)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def get_camera_location(Mext: torch.Tensor) -> torch.Tensor:
    """Camera centre in world coordinates: c = -R^T t."""
    R = Mext[..., :3, :3]
    t = Mext[..., :3, 3]
    return -_matvec(R.transpose(-1, -2), t)


def get_forward(Mext: torch.Tensor) -> torch.Tensor:
    """Unit forward direction (the third row of R)."""
    f = Mext[..., 2, :3]
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def get_up(Mext: torch.Tensor) -> torch.Tensor:
    """Unit up direction (minus the second row of R)."""
    u = -Mext[..., 1, :3]
    return u / torch.linalg.norm(u, dim=-1, keepdim=True)


def get_right(Mext: torch.Tensor) -> torch.Tensor:
    """Unit right direction (the first row of R)."""
    r = Mext[..., 0, :3]
    return r / torch.linalg.norm(r, dim=-1, keepdim=True)


def _flight_frame(r_traj: torch.Tensor):
    """Local frame of the first step: e_x the initial x-y flight direction, e_z the
    world z, e_y = e_z x e_x."""
    v0_xy = r_traj[..., 1, :2] - r_traj[..., 0, :2]
    v0 = torch.cat([v0_xy, torch.zeros_like(v0_xy[..., :1])], dim=-1)
    e_x = v0 / torch.linalg.norm(v0, dim=-1, keepdim=True)
    e_z = torch.zeros_like(e_x)
    e_z[..., 2] = 1.0
    e_y = torch.linalg.cross(e_z, e_x)
    return e_x, e_y, e_z


def transform_rotation_axes(rotation: torch.Tensor, r_traj: torch.Tensor) -> torch.Tensor:
    """World-frame spin (..., 3) -> the flight frame of r_traj (..., T, 3)."""
    e_x, e_y, e_z = _flight_frame(r_traj)
    return torch.stack([(rotation * e).sum(-1) for e in (e_x, e_y, e_z)], dim=-1)


def inverse_transform_rotation_axes(local_rotation: torch.Tensor,
                                    r_traj: torch.Tensor) -> torch.Tensor:
    """Flight-frame spin (..., 3) -> the world frame."""
    e_x, e_y, e_z = _flight_frame(r_traj)
    R_T = torch.stack([e_x, e_y, e_z], dim=-1)  # columns are the basis vectors
    return _matvec(R_T, local_rotation)


def rescale_intrinsics(Mint: torch.Tensor, src_wh, dst_wh) -> torch.Tensor:
    """Mint (..., 3, 3) rescaled from resolution src_wh to dst_wh, pixel-centre-aware:
    focal lengths times the scale, principal point (c + 0.5) s - 0.5."""
    sx, sy = dst_wh[0] / src_wh[0], dst_wh[1] / src_wh[1]
    out = Mint.clone()
    out[..., 0, 0] = Mint[..., 0, 0] * sx
    out[..., 1, 1] = Mint[..., 1, 1] * sy
    out[..., 0, 2] = (Mint[..., 0, 2] + 0.5) * sx - 0.5
    out[..., 1, 2] = (Mint[..., 1, 2] + 0.5) * sy - 0.5
    return out
