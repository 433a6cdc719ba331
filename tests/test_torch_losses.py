"""The port's loss library (`models/losses.py`) against the JAX package's, function for
function, on seeded inputs.

Every function of `upliftingtabletennis_tpu/models/losses.py` runs on the same numpy
inputs (made from a seed) in both packages, f32; the outputs agree within RTOL of their
magnitude (ATOL absolute for values near 0). Layer decay: Adam with the layer
multipliers over 3 steps on a small ViTPose-named parameter set against
`optax.chain(optax.adam(lr), scale_by_layer_decay(depth))`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upliftingtabletennis_tpu.models import losses as JL
from upliftingtabletennis_torch.models import losses as PL

RTOL, ATOL = 1e-5, 1e-6
PARENTS = (0, 0, 1, 2, 0, 4, 5)  # a 7-joint tree, the root its own parent


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(r, *shape, lo=None, hi=None):
    if lo is not None:
        return r.uniform(lo, hi, shape).astype(np.float32)
    return r.normal(size=shape).astype(np.float32)


def _joints(r, N, M, K, HW):
    """(N, M, K, 2) int32: a flat index and a visibility flag, some people empty."""
    j = np.stack([r.integers(0, K * HW, (N, M, K)), r.integers(0, 2, (N, M, K))], -1)
    j[:, -1, :, 1] = 0  # the last person has no visible joint
    return j.astype(np.int32)


def _mesh_case(r, with_smpl):
    B = 3
    out = {"vertices": _f32(r, B, 20, 3), "joints_3d": _f32(r, B, 6, 3),
           "camera": np.stack([_f32(r, B, lo=0.5, hi=1.5), _f32(r, B), _f32(r, B)], 1)}
    tgt = {"vertices": _f32(r, B, 20, 3), "joints_3d": _f32(r, B, 6, 3),
           "joints_3d_visible": r.integers(0, 2, (B, 6, 1)).astype(np.float32),
           "joints_2d": _f32(r, B, 6, 2, lo=0, hi=224),
           "joints_2d_visible": r.integers(0, 2, (B, 6, 1)).astype(np.float32),
           "has_smpl": np.array([1, 0, 1], np.float32)}
    if with_smpl:
        out["pose"] = _f32(r, B, 24, 3, 3)
        out["beta"] = _f32(r, B, 10)
        tgt["pose"] = _f32(r, B, 72) * 0.3
        tgt["beta"] = _f32(r, B, 10)
    return (out, tgt, 1.0, 2.0, 0.5, 0.3, 0.7, 224.0), {}


def _semi_case(r, n_intr):
    N, K = 4, 7
    intr = np.concatenate([_f32(r, N, 2, lo=800, hi=1200), _f32(r, N, 2, lo=400, hi=600),
                           _f32(r, N, n_intr - 4) * 0.05], 1)
    out = {"unlabeled_pose": _f32(r, N, K, 3) * 0.3, "labeled_pose": _f32(r, N, K, 3) * 0.3,
           "unlabeled_traj": np.concatenate([_f32(r, N, 1, 2) * 0.2,
                                             _f32(r, N, 1, 1, lo=3, hi=5)], -1)}
    tgt = {"intrinsics": intr, "unlabeled_target_2d": _f32(r, N, K, 2, lo=0, hi=1000)}
    return (out, tgt, PARENTS), {"projection_loss_weight": 0.7, "bone_loss_weight": 1.3}


def _multi_stage_case(r):
    N, K, H, W = 2, 3, 8, 8
    outs = [_f32(r, N, 2 * K, H, W), _f32(r, N, K, H, W)]
    hms = [_f32(r, N, K, H, W, lo=0, hi=1), _f32(r, N, K, H, W, lo=0, hi=1)]
    masks = [r.integers(0, 2, (N, H, W)).astype(np.float32) for _ in range(2)]
    joints = [_joints(r, N, 4, K, H * W), _joints(r, N, 4, K, H * W)]
    return (outs, hms, masks, joints, K), dict(
        with_ae_loss=(True, False), push_loss_factor=(0.001, 0.001),
        pull_loss_factor=(0.001, 0.001), with_heatmaps_loss=(True, True),
        heatmaps_loss_factor=(1.0, 0.5))


def _case(name, seed=0):
    """(positional args, keyword args) of one function, numpy."""
    r = _rng(seed)
    if name == "project_joints":
        pts = np.concatenate([_f32(r, 4, 7, 2) * 0.5, _f32(r, 4, 7, 1, lo=2, hi=4)], -1)
        intr = np.concatenate([_f32(r, 4, 4, lo=100, hi=500), _f32(r, 4, 5) * 0.05], 1)
        return (pts, intr), {}
    hm = (_f32(r, 2, 5, 8, 8), _f32(r, 2, 5, 8, 8, lo=0, hi=1))
    reg = (_f32(r, 4, 7, 3), _f32(r, 4, 7, 3))
    w3 = r.uniform(0, 1, (4, 7, 1)).astype(np.float32)
    cases = {
        "joints_mse_loss": (hm + (r.uniform(0, 1, (2, 5, 1)).astype(np.float32), True), {}),
        "joints_ohkm_mse_loss": (hm + (r.uniform(0, 1, (2, 5, 1)).astype(np.float32),),
                                 {"topk": 3}),
        "wing_loss": ((reg[0] * 8, reg[1] * 8, w3), {}),
        "soft_wing_loss": ((reg[0] * 3, reg[1] * 3, w3), {}),
        "adaptive_wing_loss": (hm + (r.uniform(0, 1, (2, 5)).astype(np.float32),), {}),
        "bottomup_heatmap_loss": (hm + (r.integers(0, 2, (2, 8, 8)).astype(np.float32),),
                                  {"supervise_empty": False}),
        "ae_loss_single": ((_f32(r, 3 * 64), _joints(r, 1, 4, 3, 64)[0]), {}),
        "ae_loss": ((_f32(r, 2, 3 * 64, 1), _joints(r, 2, 4, 3, 64)), {"loss_type": "max"}),
        "smooth_l1_loss": (reg + (w3, True), {"loss_weight": 0.5}),
        "l1_regression_loss": (reg + (w3, True), {}),
        "mse_regression_loss": (reg, {"loss_weight": 2.0}),
        "mpjpe_loss": (reg + (w3, True), {}),
        "bone_loss": (reg + (PARENTS, r.uniform(0, 1, (4, 6)).astype(np.float32), True), {}),
        "bce_loss": ((_f32(r, 6, 4, lo=0, hi=1), r.integers(0, 2, (6, 4)).astype(np.float32),
                      _f32(r, 6, lo=0, hi=1), True), {}),
        "combined_target_mse_loss": ((_f32(r, 2, 9, 6, 6), _f32(r, 2, 9, 6, 6, lo=0, hi=1),
                                      _f32(r, 2, 3, 1, lo=0, hi=1), True), {}),
        "quat_to_rotmat": ((_f32(r, 5, 4),), {}),
        "batch_rodrigues": ((_f32(r, 5, 3),), {}),
        "rot6d_to_rotmat": ((_f32(r, 5, 6),), {}),
        "perspective_projection": ((_f32(r, 2, 6, 3) + np.array([0, 0, 5], np.float32),
                                    np.stack([np.eye(3, dtype=np.float32)] * 2),
                                    _f32(r, 2, 3), _f32(r, 2, lo=500, hi=1000),
                                    _f32(r, 2, 2, lo=100, hi=300)), {}),
        "mesh_project_points": ((_f32(r, 2, 6, 3), np.stack([_f32(r, 2, lo=0.5, hi=1.5),
                                                             _f32(r, 2), _f32(r, 2)], 1),
                                 224.0), {}),
        "mesh_loss": _mesh_case(r, True),
        "mesh_loss_no_smpl": _mesh_case(r, False),
        "gan_loss": ((_f32(r, 8) * 3, True), {"gan_type": "vanilla", "loss_weight": 0.5}),
        "gan_loss_hinge_disc": ((_f32(r, 8), False), {"gan_type": "hinge", "is_disc": True}),
        "gan_loss_lsgan": ((_f32(r, 8), False), {"gan_type": "lsgan"}),
        "gan_loss_wgan": ((_f32(r, 8), True), {"gan_type": "wgan", "loss_weight": 2.0}),
        "semi_supervision_loss": _semi_case(r, 9),
        "semi_supervision_loss_4": _semi_case(r, 4),
        "multi_stage_loss": _multi_stage_case(r),
        "layer_decay_schedule": ((12,), {"decay_rate": 0.65}),
        "vit_layer_index": ((("model_backbone", "blocks_3", "attn_qkv", "kernel"), 12), {}),
    }
    return cases[name]


FUNCS = ["joints_mse_loss", "joints_ohkm_mse_loss", "wing_loss", "soft_wing_loss",
         "adaptive_wing_loss", "bottomup_heatmap_loss", "ae_loss_single", "ae_loss",
         "smooth_l1_loss", "l1_regression_loss", "mse_regression_loss", "mpjpe_loss",
         "bone_loss", "bce_loss", "combined_target_mse_loss", "quat_to_rotmat",
         "batch_rodrigues", "rot6d_to_rotmat", "perspective_projection",
         "mesh_project_points", "mesh_loss", "mesh_loss_no_smpl", "gan_loss",
         "gan_loss_hinge_disc", "gan_loss_lsgan", "gan_loss_wgan", "project_joints",
         "semi_supervision_loss", "semi_supervision_loss_4", "multi_stage_loss",
         "layer_decay_schedule", "vit_layer_index"]


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    if isinstance(tree, np.ndarray):
        return fn(tree)
    return tree


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    if tree is None:
        return [None]
    return [np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree,
                       dtype=np.float64)]


@pytest.mark.parametrize("name", FUNCS)
def test_loss_function_matches_jax(name):
    args, kw = _case(name, seed=FUNCS.index(name))
    fn = name.replace("_no_smpl", "").replace("_hinge_disc", "").replace(
        "_lsgan", "").replace("_wgan", "").replace("_4", "")
    want = getattr(JL, fn)(*_to(list(args), jnp.asarray), **kw)
    got = getattr(PL, fn)(*_to(list(args), torch.from_numpy), **kw)
    want, got = _flat(want), _flat(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * max(1.0, np.abs(w).max()))
        assert np.isfinite(w).all()


def test_adam_with_layer_decay_matches_optax():
    """clip-free Adam(lr) then the layer multipliers, over 3 steps, from the same
    gradients: the port's `apply` (Adam written out as the trainers do) scaled by
    `scale_by_layer_decay` against optax.chain(adam, JAX's scale_by_layer_decay)."""
    from upliftingtabletennis_torch.models.vit import VitPoseNet

    depth, lr = 12, 1e-2
    model = VitPoseNet(1, 1, resolution=(32, 32))
    names = [n for n, _ in model.named_parameters()]
    r = _rng(3)
    params = {n: r.normal(size=p.shape).astype(np.float32) for n, p in model.named_parameters()}
    grads = [{n: r.normal(size=v.shape).astype(np.float32) for n, v in params.items()}
             for _ in range(3)]
    # JAX: the same parameters as a nested tree, so vit_layer_index sees the path
    def tree(d):
        out = {}
        for k, v in d.items():
            node = out
            *mods, leaf = k.split(".")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = jnp.asarray(v)
        return out

    tx = optax.chain(optax.adam(lr), JL.scale_by_layer_decay(depth))
    jp = tree(params)
    state = tx.init(jp)

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for g in grads:
        jp, state = update(tree(g), state, jp)
    want = {n: np.asarray(_lookup(jp, n)) for n in names}

    mults = PL.layer_decay_multipliers(model, depth)
    assert sorted(set(mults)) == sorted(set(JL.layer_decay_schedule(depth).values()))
    p = [torch.from_numpy(params[n].copy()) for n in names]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    for step, g in enumerate(grads, 1):
        upd = []
        for i, n in enumerate(names):
            gt = torch.from_numpy(g[n])
            mu[i] = 0.1 * gt + 0.9 * mu[i]
            nu[i] = 0.001 * gt ** 2 + 0.999 * nu[i]
            mh = mu[i] / (1 - torch.tensor(0.9) ** step)
            nh = nu[i] / (1 - torch.tensor(0.999) ** step)
            upd.append(-lr * (mh / (torch.sqrt(nh) + 1e-8)))
        PL.scale_by_layer_decay(upd, mults)
        for t, u in zip(p, upd):
            t.add_(u)
    for n, t in zip(names, p):
        np.testing.assert_allclose(t.numpy(), want[n], rtol=1e-5, atol=1e-6, err_msg=n)


def _lookup(tree, name):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node
