"""The pose-estimation loss library (the mmpose losses the reference vendors), in torch.

Port of `upliftingtabletennis_tpu/models/losses.py`, function for function: heatmap
(joint MSE, OHKM, the wing family, the bottom-up heatmap loss), associative embedding,
regression, bone, classification and combined-target losses, the rotation helpers, and
the mesh, GAN, semi-supervision and multi-stage losses. No trainer of either package
calls them; they are here so that the port does what the JAX package does.

Layer decay (the ViT optimiser's per-layer learning rates) becomes per-parameter
multipliers of the update: `layer_decay_multipliers(model, depth)` gives one per
parameter, and `scale_by_layer_decay` scales a list of updates by them in place, as the
JAX package's optax transform does.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import torch
import torch.nn.functional as F

__all__ = ["joints_mse_loss", "joints_ohkm_mse_loss", "wing_loss", "soft_wing_loss",
           "adaptive_wing_loss", "layer_decay_schedule", "vit_layer_index",
           "layer_decay_multipliers", "scale_by_layer_decay",
           "bottomup_heatmap_loss", "ae_loss_single", "ae_loss", "smooth_l1_loss",
           "l1_regression_loss", "mse_regression_loss", "mpjpe_loss", "bone_loss", "bce_loss",
           "combined_target_mse_loss", "quat_to_rotmat", "batch_rodrigues", "rot6d_to_rotmat",
           "perspective_projection", "mesh_project_points", "mesh_loss", "gan_loss",
           "project_joints", "semi_supervision_loss", "multi_stage_loss"]


def joints_mse_loss(pred, target, target_weight=None, use_target_weight=False):
    """Per-joint MSE over flattened heatmaps, halved. pred/target (B, K, H, W);
    target_weight (B, K, 1)."""
    B, K = pred.shape[:2]
    p, t = pred.reshape(B, K, -1), target.reshape(B, K, -1)
    if use_target_weight and target_weight is not None:
        w = target_weight.reshape(B, K, 1)
        p, t = p * w, t * w
    return (0.5 * ((p - t) ** 2).mean(-1)).mean()


def joints_ohkm_mse_loss(pred, target, target_weight=None, topk: int = 8):
    """Online hard-keypoint mining: the mean of each sample's top-k per-joint losses."""
    B, K = pred.shape[:2]
    p, t = pred.reshape(B, K, -1), target.reshape(B, K, -1)
    if target_weight is not None:
        w = target_weight.reshape(B, K, 1)
        p, t = p * w, t * w
    per_joint = 0.5 * ((p - t) ** 2).mean(-1)
    k = min(topk, K)
    top = torch.topk(per_joint, k, dim=1).values
    return (top.sum(1) / k).mean()


def wing_loss(pred, target, target_weight=None, omega=10.0, epsilon=2.0):
    """Wing loss for coordinate regression (Feng et al. 2018). pred/target (B, K, D)."""
    delta = (pred - target).abs()
    C = omega - omega * torch.log(torch.tensor(1.0 + omega / epsilon, dtype=pred.dtype))
    loss = torch.where(delta < omega, omega * torch.log(1.0 + delta / epsilon), delta - C)
    if target_weight is not None:
        loss = loss * target_weight
    return loss.mean()


def soft_wing_loss(pred, target, target_weight=None, omega1=2.0, omega2=20.0, epsilon=0.5):
    """Soft wing loss (Wang et al. 2021)."""
    delta = (pred - target).abs()
    B = omega1 - omega2 * torch.log(torch.tensor(1.0 + omega1 / epsilon, dtype=pred.dtype))
    loss = torch.where(delta < omega1, delta, omega2 * torch.log(1.0 + delta / epsilon) + B)
    if target_weight is not None:
        loss = loss * target_weight
    return loss.mean()


def adaptive_wing_loss(pred, target, target_weight=None, alpha=2.1, omega=14.0, epsilon=1.0,
                       theta=0.5):
    """Adaptive wing loss for heatmaps (Wang et al. 2019). pred/target (B, K, H, W);
    target_weight (B, K)."""
    delta = (pred - target).abs()
    expo = alpha - target
    r = theta / epsilon
    A = omega * (1.0 / (1.0 + r ** expo)) * expo * (r ** (expo - 1.0)) / epsilon
    C = theta * A - omega * torch.log(1.0 + r ** expo)
    loss = torch.where(delta < theta, omega * torch.log(1.0 + (delta / epsilon) ** expo),
                       A * delta - C)
    if target_weight is not None:
        loss = loss * target_weight[..., None, None]
    return loss.mean()


def layer_decay_schedule(depth: int, decay_rate: float = 0.75) -> Dict[int, float]:
    """Learning-rate multipliers of a ViT's layers: layer i of `depth` gets
    decay_rate ** (depth - i); index depth (the head) gets 1."""
    return {i: decay_rate ** (depth - i) for i in range(depth + 1)}


def vit_layer_index(path_parts: Sequence[str], depth: int) -> int:
    """A parameter's layer: the patch and position embeddings 0, blocks_i i + 1, anything
    after the backbone `depth`. `path_parts`: the name split at '.'."""
    for p in path_parts:
        p = str(p)
        if p.startswith("blocks_"):
            return int(p.split("_")[1]) + 1
        if p in ("patch_embed_proj", "pos_embed"):
            return 0
    return depth


def layer_decay_multipliers(model: torch.nn.Module, depth: int,
                            decay_rate: float = 0.75) -> List[float]:
    """One multiplier per parameter of `model`, in `model.parameters()` order."""
    sched = layer_decay_schedule(depth, decay_rate)
    return [sched[vit_layer_index(name.split("."), depth)]
            for name, _ in model.named_parameters()]


@torch.no_grad()
def scale_by_layer_decay(updates: Iterable[torch.Tensor], multipliers: Sequence[float]):
    """Scale each update by its parameter's multiplier, in place (the optax transform of
    the JAX package, applied after the optimiser's update)."""
    for u, m in zip(updates, multipliers):
        u.mul_(m)
    return updates


# bottom-up (associative embedding) losses

def bottomup_heatmap_loss(pred, gt, mask, supervise_empty: bool = True):
    """Masked per-image heatmap MSE. pred/gt (N, K, H, W); mask (N, H, W) -> (N,)."""
    se = (pred - gt) ** 2
    if not supervise_empty:
        se = se * (gt.sum((2, 3), keepdim=True) > 0).to(pred.dtype)
    se = se * mask[:, None]
    return se.mean((1, 2, 3))


def ae_loss_single(pred_tag, joints, loss_type: str = "exp"):
    """Associative-embedding push / pull loss of one image (Newell et al.).

    pred_tag (K*H*W,) flattened tag map; joints (M, K, 2) int: per person and joint,
    (flat index, visibility > 0). Returns (push, pull) with the reference's
    normalisation, a single tagged person keeping its pull undivided."""
    idx = joints[..., 0].long()
    vis = (joints[..., 1] > 0).to(pred_tag.dtype)  # (M, K)
    t = pred_tag[idx]
    cnt = vis.sum(1)
    has = cnt > 0
    mean_t = (t * vis).sum(1) / cnt.clamp_min(1.0)
    pull_m = (((t - mean_t[:, None]) ** 2) * vis).sum(1) / cnt.clamp_min(1.0)
    pull_raw = torch.where(has, pull_m, torch.zeros_like(pull_m)).sum()
    n = has.to(torch.int32).sum()
    diff = mean_t[:, None] - mean_t[None, :]
    pair = (has[:, None] & has[None, :]).to(pred_tag.dtype)
    if loss_type == "exp":
        push_raw = (torch.exp(-(diff ** 2)) * pair).sum() - n
    elif loss_type == "max":
        push_raw = (torch.clamp(1.0 - diff.abs(), min=0.0) * pair).sum() - n
    else:
        raise ValueError(f"Unknown ae loss type {loss_type}")
    nf = n.to(pred_tag.dtype)
    zero = torch.zeros((), dtype=pred_tag.dtype, device=pred_tag.device)
    push = torch.where(n > 1, push_raw / torch.clamp((nf - 1.0) * nf, min=1.0) * 0.5, zero)
    pull = torch.where(n > 1, pull_raw / nf.clamp_min(1.0),
                       torch.where(n == 1, pull_raw, zero))
    return push, pull


def ae_loss(tags, joints, loss_type: str = "exp"):
    """Batched AE loss. tags (N, K*H*W) or (N, K*H*W, 1); joints (N, M, K, 2) int.
    Returns (push (N,), pull (N,))."""
    if tags.ndim == 3:
        tags = tags[..., 0]
    out = [ae_loss_single(t, j, loss_type) for t, j in zip(tags, joints)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


# regression losses

def _weighted(fn, output, target, target_weight, use_target_weight):
    if use_target_weight:
        return fn(output * target_weight, target * target_weight)
    return fn(output, target)


def _smooth_l1(a, b):
    d = (a - b).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def smooth_l1_loss(output, target, target_weight=None, use_target_weight=False,
                   loss_weight=1.0):
    """SmoothL1. output/target (N, K, D)."""
    return _weighted(lambda a, b: _smooth_l1(a, b).mean(), output, target, target_weight,
                     use_target_weight) * loss_weight


def l1_regression_loss(output, target, target_weight=None, use_target_weight=False,
                       loss_weight=1.0):
    return _weighted(lambda a, b: (a - b).abs().mean(), output, target, target_weight,
                     use_target_weight) * loss_weight


def mse_regression_loss(output, target, target_weight=None, use_target_weight=False,
                        loss_weight=1.0):
    return _weighted(lambda a, b: ((a - b) ** 2).mean(), output, target, target_weight,
                     use_target_weight) * loss_weight


def mpjpe_loss(output, target, target_weight=None, use_target_weight=False, loss_weight=1.0):
    """Mean per-joint position error."""
    return _weighted(lambda a, b: torch.linalg.vector_norm(a - b, dim=-1).mean(), output,
                     target, target_weight, use_target_weight) * loss_weight


def bone_loss(output, target, joint_parents, target_weight=None, use_target_weight=False,
              loss_weight=1.0):
    """Bone-length consistency. output/target (N, K, D); joint_parents: K parent indices
    (the root its own); target_weight (N, K_nonroot)."""
    parents = torch.as_tensor(list(joint_parents), device=output.device)
    nr = torch.as_tensor([i for i, p in enumerate(joint_parents) if p != i],
                         device=output.device)
    ob = torch.linalg.vector_norm(output - output[:, parents], dim=-1)[:, nr]
    tb = torch.linalg.vector_norm(target - target[:, parents], dim=-1)[:, nr]
    if use_target_weight:
        loss = ((ob * target_weight).mean(0) - (tb * target_weight).mean(0)).abs().mean()
    else:
        loss = (ob.mean(0) - tb.mean(0)).abs().mean()
    return loss * loss_weight


# classification and combined-target losses

def bce_loss(output, target, target_weight=None, use_target_weight=False, loss_weight=1.0,
             eps=1e-12):
    """Binary cross entropy on probabilities. output/target (N, K) in [0, 1];
    target_weight (N, K) or (N,)."""
    o = output.clamp(eps, 1.0 - eps)
    per = -(target * torch.log(o) + (1.0 - target) * torch.log(1.0 - o))
    if use_target_weight:
        w = target_weight[:, None] if target_weight.ndim == 1 else target_weight
        return (per * w).mean() * loss_weight
    return per.mean() * loss_weight


def combined_target_mse_loss(output, target, target_weight=None, use_target_weight=False,
                             loss_weight=1.0):
    """UDP combined-target MSE: (heatmap, offset x, offset y) per joint, the offsets
    supervised where the target's response map is live. output/target (N, 3K, H, W)."""
    N, C = output.shape[:2]
    K = C // 3
    p, t = output.reshape(N, K, 3, -1), target.reshape(N, K, 3, -1)
    hm_p, hm_t = p[:, :, 0], t[:, :, 0]
    if use_target_weight:
        w = target_weight.reshape(N, K, 1)
        hm_p, hm_t = hm_p * w, hm_t * w
    loss = 0.5 * ((hm_p - hm_t) ** 2).mean((0, 2))
    for a in (1, 2):
        loss = loss + 0.5 * ((hm_t * p[:, :, a] - hm_t * t[:, :, a]) ** 2).mean((0, 2))
    return loss.mean() * loss_weight


# rotation representations and mesh losses

def quat_to_rotmat(quat):
    """(B, 4) wxyz quaternions -> (B, 3, 3) rotation matrices."""
    q = quat / torch.linalg.vector_norm(quat, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=1).reshape(-1, 3, 3)


def batch_rodrigues(theta):
    """(B, 3) axis-angle -> (B, 3, 3), by the reference's quaternion route (with its
    +1e-8 inside the norm)."""
    angle = torch.linalg.vector_norm(theta + 1e-8, dim=1)[:, None]
    normalized = theta / angle
    half = angle * 0.5
    return quat_to_rotmat(torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=1))


def rot6d_to_rotmat(x):
    """(B, 6) continuous 6D rotation (Zhou et al. 2019) -> (B, 3, 3): Gram-Schmidt on the
    two columns, the third their cross product."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=1, keepdim=True).clamp_min(1e-12)
    a2p = a2 - (b1 * a2).sum(1, keepdim=True) * b1
    b2 = a2p / torch.linalg.vector_norm(a2p, dim=1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=1)
    return torch.stack((b1, b2, b3), dim=-1)


def perspective_projection(points, rotation, translation, focal_length, camera_center):
    """Pinhole projection of (B, N, 3) points -> (B, N, 2)."""
    pts = torch.einsum("bij,bkj->bki", rotation, points) + translation[:, None]
    pts = pts / pts[:, :, -1:]
    x = focal_length[:, None] * pts[:, :, 0] + camera_center[:, None, 0]
    y = focal_length[:, None] * pts[:, :, 1] + camera_center[:, None, 1]
    return torch.stack([x, y], dim=-1)


def mesh_project_points(points_3d, camera, img_res, focal_length=5000.0):
    """A weak-perspective (scale, tx, ty) camera -> 2D points."""
    B = points_3d.shape[0]
    cam_t = torch.stack([camera[:, 1], camera[:, 2],
                         2.0 * focal_length / (img_res * camera[:, 0] + 1e-9)], dim=-1)
    rot = torch.eye(3, dtype=points_3d.dtype, device=points_3d.device).expand(B, 3, 3)
    f = torch.full((B,), focal_length, dtype=points_3d.dtype, device=points_3d.device)
    c = torch.zeros((B, 2), dtype=points_3d.dtype, device=points_3d.device)
    return perspective_projection(points_3d, rot, cam_t, f, c)


def mesh_loss(output, target, joints_2d_loss_weight, joints_3d_loss_weight, vertex_loss_weight,
              smpl_pose_loss_weight, smpl_beta_loss_weight, img_res, focal_length=5000.0):
    """The 3D-mesh loss: L1 vertices, pelvis-centred smooth-L1 3D joints, smooth-L1 2D
    joints through the weak-perspective camera (and the SMPL pose / shape MSE when
    predicted), each gated by visibility or has_smpl. Dicts of tensors in and out."""
    losses = {}
    has_smpl = target["has_smpl"].to(torch.float32)
    v_l1 = (output["vertices"] - target["vertices"]).abs()
    losses["vertex_loss"] = (has_smpl[:, None, None] * v_l1).mean() * vertex_loss_weight
    if "pose" in output and "beta" in output:
        gt_rotmat = batch_rodrigues(target["pose"].reshape(-1, 3)).reshape(-1, 24, 3, 3)
        pose_mse = (output["pose"] - gt_rotmat) ** 2
        beta_mse = (output["beta"] - target["beta"]) ** 2
        losses["smpl_pose_loss"] = ((has_smpl[:, None, None, None] * pose_mse).mean()
                                    * smpl_pose_loss_weight)
        losses["smpl_beta_loss"] = (has_smpl[:, None] * beta_mse).mean() * smpl_beta_loss_weight
    pred_j3d, gt_j3d = output["joints_3d"], target["joints_3d"]
    conf3 = target["joints_3d_visible"].to(torch.float32)
    gt_pelvis = (gt_j3d[:, 2] + gt_j3d[:, 3]) / 2.0
    pred_pelvis = (pred_j3d[:, 2] + pred_j3d[:, 3]) / 2.0
    losses["joints_3d_loss"] = (conf3 * _smooth_l1(pred_j3d - pred_pelvis[:, None],
                                                   gt_j3d - gt_pelvis[:, None])).mean() \
        * joints_3d_loss_weight
    conf2 = target["joints_2d_visible"].to(torch.float32)
    pred_j2d = mesh_project_points(pred_j3d, output["camera"], img_res, focal_length)
    pred_j2d = 2.0 * pred_j2d / (img_res - 1.0)
    gt_j2d = 2.0 * target["joints_2d"] / (img_res - 1.0) - 1.0
    losses["joints_2d_loss"] = (conf2 * _smooth_l1(pred_j2d, gt_j2d)).mean() \
        * joints_2d_loss_weight
    return losses


def gan_loss(x, target_is_real: bool, gan_type: str = "vanilla", real_label_val=1.0,
             fake_label_val=0.0, loss_weight=1.0, is_disc: bool = False):
    """The mesh adversary's GAN objective; `loss_weight` applies to the generator only."""
    target_val = real_label_val if target_is_real else fake_label_val
    if gan_type == "vanilla":  # BCE with logits
        loss = (torch.clamp(x, min=0) - x * target_val + torch.log1p(torch.exp(-x.abs()))).mean()
    elif gan_type == "lsgan":
        loss = ((x - target_val) ** 2).mean()
    elif gan_type == "wgan":
        loss = -x.mean() if target_is_real else x.mean()
    elif gan_type == "hinge":
        if is_disc:
            loss = F.relu(1.0 + (-x if target_is_real else x)).mean()
        else:
            loss = -x.mean()
    else:
        raise NotImplementedError(f"GAN type {gan_type} is not implemented.")
    return loss if is_disc else loss * loss_weight


# semi-supervision loss

def project_joints(x, intrinsics):
    """Project (N, K, 3) joints with (N, 4) [f, c] or (N, 9) [f, c, k, p] intrinsics, with
    radial and tangential distortion for the latter."""
    intr = intrinsics[:, None, :]
    f, c = intr[..., :2], intr[..., 2:4]
    _x = (x[:, :, :2] / x[:, :, 2:]).clamp(-1.0, 1.0)
    if intrinsics.shape[-1] == 9:
        k, p = intr[..., 4:7], intr[..., 7:9]
        r2 = (_x ** 2).sum(-1, keepdim=True)
        radial = 1.0 + (k * torch.cat((r2, r2 ** 2, r2 ** 3), dim=-1)).sum(-1, keepdim=True)
        tan = (p * _x).sum(-1, keepdim=True)
        _x = _x * (radial + tan) + p * r2
    return f * _x + c


def semi_supervision_loss(output, target, joint_parents, projection_loss_weight=1.0,
                          bone_loss_weight=1.0):
    """Projection and bone consistency on unlabelled data (Pavllo et al. 2019); the caller
    gates the warm-up, as in the JAX package."""
    unlabeled_2d = project_joints(output["unlabeled_pose"] + output["unlabeled_traj"],
                                  target["intrinsics"])
    return {"proj_loss": mpjpe_loss(unlabeled_2d, target["unlabeled_target_2d"],
                                    loss_weight=projection_loss_weight),
            "bone_loss": bone_loss(output["unlabeled_pose"], output["labeled_pose"],
                                   joint_parents, loss_weight=bone_loss_weight)}


# the multi-stage bottom-up loss

def multi_stage_loss(outputs, heatmaps, masks, joints, num_joints, ae_loss_type="exp",
                     with_ae_loss=(True,), push_loss_factor=(0.001,),
                     pull_loss_factor=(0.001,), with_heatmaps_loss=(True,),
                     heatmaps_loss_factor=(1.0,), supervise_empty=True):
    """Per-stage heatmap and AE losses of a bottom-up model. outputs[i] (N, C_i, H, W):
    the first num_joints channels heatmaps, the rest tag maps. Returns (heatmap losses,
    push losses, pull losses), None where a stage's loss is off."""
    hm_losses, push_losses, pull_losses = [], [], []
    for i, out in enumerate(outputs):
        offset = 0
        if with_heatmaps_loss[i]:
            offset = num_joints
            hm = bottomup_heatmap_loss(out[:, :num_joints], heatmaps[i], masks[i],
                                       supervise_empty)
            hm_losses.append(hm * heatmaps_loss_factor[i])
        else:
            hm_losses.append(None)
        if with_ae_loss[i]:
            push, pull = ae_loss(out[:, offset:].reshape(out.shape[0], -1), joints[i],
                                 ae_loss_type)
            push_losses.append(push * push_loss_factor[i])
            pull_losses.append(pull * pull_loss_factor[i])
        else:
            push_losses.append(None)
            pull_losses.append(None)
    return hm_losses, push_losses, pull_losses
