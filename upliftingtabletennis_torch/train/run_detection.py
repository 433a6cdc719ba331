"""Detector trainer (ball and table) for the SegFormer, HRNet and ViTPose models, CLI.

Port of `upliftingtabletennis_tpu/train/run_detection.py` (`main`, `:29-413`):

    python -m upliftingtabletennis_torch.train.run_detection \\
        --task ball --model segformerpp_b2 --data_root <root with tthq/>

The same recipe: the augmentation of `data/image_transforms.py`, Gaussian targets at
the 1920x1080 evaluation resolution, the weighted MSE on the logits upscaled
bilinearly to it, the batch statistics of the BatchNorms (a SegFormer's head; every
BatchNorm of WASB and the table HRNet, built with `remat` as the JAX trainer builds
them; ViTPose's head, with stochastic depth in its blocks), optax's
`clip_by_global_norm(5.0)` then Adam (lr 1e-3), an EMA of the parameters (0.999),
validation of the EMA weights with the current batch statistics every
`--val_iterations` steps by PCK at 2, 5, 10 and 20 px, and a checkpoint of the best
PCK@5. The step is factored (`loss_fn`, `apply_update`, `infer`, `validate`) so each
piece can be held against the JAX trainer.

Parameters and Adam's state are f32, as in JAX. On the card the forward runs in bf16:
a SegFormer through the differentiable kernels K1 and K2, whose backward recomputes
through K4; an HRNet through cuDNN convolutions (unfolded, BatchNorm statistics in f32);
ViTPose through `F.scaled_dot_product_attention` (the JAX package has no kernel there);
the loss is f32. Validation runs the inference model (an HRNet folded, through K5).
Random draws (augmentation, ViTPose's drop-path masks) come from a `torch.Generator`
seeded with `--seed`, not from `jax.random`. Logs go to stdout and, one JSON line per
validation, to `<logdir>/<identifier>/metrics.jsonl`; where `torch.utils.tensorboard`
imports, rank 0 also writes a TensorBoard run there (the training loss and the PCKs at
each validation, and the heatmap overlay of the first validation batch,
`utils/visualization.heatmap_overlay_image`), as the JAX trainer does.

Data: `--data tthq` (the default) or `--data blurball`, the pretraining set
(`data/detection.py`; 10 epochs by default, the blur streak's ends in the ball's PCK).
A BlurBall ball run also writes its best checkpoint to
`<save_dir>/pretraining_blurball/<model>/model.pt`, where `--pretraining` reads it: the
pretraining -> fine-tuning handoff of the ball detector needs no copy. A table run keeps
only its own run directory, so it never overwrites the ball's pretrained weights.

Initialisation: `--torch_init` loads the reference's raw pretrained torch weights
(WASB's `model.pth` for wasb / hrnet, an MAE `mae_pretrain_vit_*.pth` for vitpose; the
`["model"]` and `["state_dict"]` layouts are unwrapped), filtered by name and shape, the
first conv widened to the input frames (`utils/port_torch.torch_init_detector`);
`--hf_backbone` loads a HuggingFace mit-bN encoder into a SegFormer's backbone, its
first patch embedding tiled over the input frames.

Data parallelism: `--dp N` trains over N processes, one per card, launched by
`torchrun --nproc_per_node N` (NCCL on cards, gloo with `--device cpu`). Each rank
loads its slice of the global batch, draws the global batch's augmentation and drop
masks from the shared generator and keeps its slice, and runs the model under
`DistributedDataParallel`; the BatchNorms take their statistics over the global batch
(`models/batch_norm.sync_batch_stats`), as JAX's sharded step does. The default is the
world size; a batch that the world size does not divide falls back to 1 (every rank then
runs the whole batch alone). Logs, validation and checkpoints are rank 0's.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from upliftingtabletennis_torch._device import resolve_device
from upliftingtabletennis_torch.data import detection as D
from upliftingtabletennis_torch.data.image_transforms import (ImageAugmentConfig,
                                                             augment_detection_batch,
                                                             draw_affine_uniforms,
                                                             draw_jitter_uniforms)
from upliftingtabletennis_torch.eval import metrics as M
from upliftingtabletennis_torch.models import batch_norm as BN
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.vit import VitPoseNet, draw_drop_masks
from upliftingtabletennis_torch.ops.peak import extract_peaks
from upliftingtabletennis_torch.parallel import distributed as dist_util
from upliftingtabletennis_torch.pipeline.interface import init_weights
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["main", "heatmap", "n_points", "loss_fn", "init_adam", "apply_update", "eval_coords",
           "train_step", "infer", "validate", "load_torch_weights", "init_from_torch",
           "init_hf_backbone", "overlay_image", "pretraining_path", "warm_start",
           "TRAINABLE_MODELS"]

TRAINABLE_MODELS = ("segformerpp_b0", "segformerpp_b2", "vitpose", "wasb", "hrnet")
CLIP_NORM = 5.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PCK_TOLERANCES = (2, 5, 10, 20)


def heatmap(out) -> torch.Tensor:
    """A detector's heatmap (B, h, w, P): SegFormer and WASB return (heatmap, extra), the
    table HRNet the heatmap alone."""
    return out[0] if isinstance(out, tuple) else out


def _unwrap(model):
    """The detector inside a `DistributedDataParallel` wrapper, or the model itself."""
    return getattr(model, "module", model)


def n_points(model) -> int:
    """The heatmap channels of a detector."""
    model = _unwrap(model)
    head = getattr(model, "decode_head", None)
    if head is not None:
        return head.conv_seg.out_channels
    if isinstance(model, VitPoseNet):
        return model.model_keypoint_head.final_layer.out_channels
    return model.out_channels


def loss_fn(model, imgs, target, drop_masks=None):
    """Forward of a model in training mode, logits upscaled (bilinear, half-pixel) to the
    target's resolution in f32, weighted MSE. imgs (B, H, W, C_in); target (B, P, EH, EW);
    drop_masks: ViTPose's (depth, 2, B) stochastic-depth masks.
    Returns (loss, the model's batch statistics, updated by this forward)."""
    out = model(imgs) if drop_masks is None else model(imgs, drop_masks)
    logits = heatmap(out).permute(0, 3, 1, 2).float()
    logits = F.interpolate(logits, size=tuple(target.shape[-2:]), mode="bilinear",
                           align_corners=False)
    return M.weighted_mse_loss(logits, target), dict(model.named_buffers())


def init_adam(params: Sequence[torch.Tensor]) -> Dict:
    """Adam's state: the step count and f32 first and second moments."""
    return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params]}


@torch.no_grad()
def apply_update(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: Dict,
                 ema: Sequence[torch.Tensor], lr: float = 1e-3, ema_decay: float = 0.999,
                 max_norm: float = CLIP_NORM) -> None:
    """One optimizer step, in place: optax's `clip_by_global_norm(max_norm)` (g kept when
    the global norm is below max_norm, else (g / norm) * max_norm), then `adam(lr)`
    (eps outside the square root), then the EMA of the parameters."""
    g_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = g_norm < max_norm
    grads = [torch.where(keep, g, (g / g_norm) * max_norm) for g in grads]
    state["count"] += 1
    dev = params[0].device
    c1 = 1 - torch.tensor(ADAM_B1, device=dev) ** state["count"]
    c2 = 1 - torch.tensor(ADAM_B2, device=dev) ** state["count"]
    for p, g, mu, nu, e in zip(params, grads, state["mu"], state["nu"], ema):
        mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
        nu.copy_((1 - ADAM_B2) * g ** 2 + ADAM_B2 * nu)
        update = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
        p.add_(-lr * update)
        e.copy_(ema_decay * e + (1 - ema_decay) * p)


def eval_coords(c_model, model_wh, eval_wh):
    """Coordinates at the model's input resolution -> the evaluation resolution
    (pixel-centre scaling)."""
    (MW, MH), (EW, EH) = model_wh, eval_wh
    return torch.stack([(c_model[..., 0] + 0.5) * EW / MW - 0.5,
                        (c_model[..., 1] + 0.5) * EH / MH - 0.5], -1)


def train_step(model, params, opt_state, ema, gen, images, coords, vis, model_wh, eval_wh,
               aug_cfg: ImageAugmentConfig, sigma: float = 6.0, lr: float = 1e-3,
               ema_decay: float = 0.999, dtype=torch.float32, shard=None):
    """One training step on a batch at the source resolution (images (B, H, W, C_in) f32 in
    [0, 255], coords (B, P', 2) in source pixels, vis (B, P')): augmentation, targets at
    the evaluation resolution, `loss_fn` with the forward in `dtype`, the gradients of
    `params`, `apply_update`. Returns the loss (a device scalar).

    The draws come from `gen`: the augmentation's uniforms, then ViTPose's drop masks.
    shard (data parallelism, `model` a `DistributedDataParallel`): (this rank's slice of
    the global batch, the global batch size); the batch given is the rank's slice, the
    draws are made for the global batch and sliced, the gradients are the global batch's
    (DDP's average), and the loss returned is the global batch's."""
    B = images.shape[0] if shard is None else shard[1]
    draws = (draw_affine_uniforms(gen, B, images.device),
             draw_jitter_uniforms(gen, B, images.device))
    net = _unwrap(model)
    masks = None
    if isinstance(net, VitPoseNet):
        masks = draw_drop_masks(gen, B, images.device)
    if shard is not None:
        draws = tuple(d[:, shard[0]] for d in draws)
        masks = None if masks is None else masks[:, :, shard[0]]
    imgs, c_model, v = augment_detection_batch(gen, images, coords, vis, model_wh, aug_cfg,
                                               True, draws=draws)
    P = n_points(model)
    c_eval = eval_coords(c_model, model_wh, eval_wh)
    target = M.render_gaussian_heatmaps(c_eval[:, :P], v[:, :P], eval_wh[1], eval_wh[0], sigma)
    loss, _ = loss_fn(model, imgs.to(dtype), target, masks)
    if shard is None:
        # parameters no output reaches (an HRNet's last fuse layers) get zeros, as in JAX
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
    else:  # DDP averages the gradients over the ranks in the backward
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        for p in params:
            p.grad = None
        loss = dist_util.all_reduce_mean(loss.detach())
    apply_update(params, grads, opt_state, ema, lr, ema_decay)
    return loss.detach()


@torch.no_grad()
def infer(eval_model, images, coords, vis, task, model_wh, eval_wh, dtype=torch.float32):
    """Predicted peaks (B, P, 3) and ground truth (B, P', 3) at the evaluation resolution
    of one validation batch: the eval branch's resize, the model in inference mode, peaks
    with threshold -inf for the ball and 0.1 for the table."""
    imgs, c_model, v = augment_detection_batch(None, images, coords, vis, model_wh, train=False)
    heat = heatmap(eval_model(imgs.to(dtype))).permute(0, 3, 1, 2).float()
    threshold = float("-inf") if task == "ball" else 0.1
    preds = extract_peaks(heat, eval_wh[0], eval_wh[1], threshold=threshold)
    gts = torch.cat([eval_coords(c_model, model_wh, eval_wh), v[..., None]], -1)
    return preds, gts


def validate(eval_model, batches, task, model_wh, eval_wh, dtype=torch.float32):
    """PCK at 2, 5, 10 and 20 px over validation batches of (images, coords, vis) tensors:
    against the blur streak for the ball, over visible keypoints for the table."""
    preds, gts = [], []
    for images, coords, vis in batches:
        p, g = infer(eval_model, images, coords, vis, task, model_wh, eval_wh, dtype)
        preds.append(p)
        gts.append(g)
    if not preds:
        return {}
    preds, gts = torch.cat(preds), torch.cat(gts)
    out = {}
    for tol in PCK_TOLERANCES:
        if task == "ball":
            pck = M.pck_ball(preds[:, 0], gts[:, 0, :2], gts[:, 1, :2], gts[:, 2, :2], tol)
        else:
            pck = M.pck_keypoints(preds, gts, tol)
        out[f"pck{tol}"] = float(pck)
    return out


@torch.no_grad()
def overlay_image(eval_model, images, coords, vis, model_wh, dtype=torch.float32):
    """The validation overlay of the first sample of a batch: its centre frame at the
    model's resolution (de-normalised), the predicted heatmap and the ground truth
    (`utils/visualization.heatmap_overlay_image`)."""
    from upliftingtabletennis_torch.data.image_transforms import IMAGENET_MEAN, IMAGENET_STD
    from upliftingtabletennis_torch.utils.visualization import heatmap_overlay_image

    imgs, c_model, v = augment_detection_batch(None, images[:1], coords[:1], vis[:1],
                                               model_wh, train=False)
    heat = heatmap(eval_model(imgs.to(dtype))).permute(0, 3, 1, 2).float()
    x0 = imgs[0].float().cpu().numpy()
    center = x0[..., 3:6] if x0.shape[-1] == 9 else x0[..., :3]
    center = (center * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)) * 255.0
    gt = np.concatenate([c_model[0].cpu().numpy(), v[0].cpu().numpy()[:, None]], -1)
    return heatmap_overlay_image(center, heat[0].cpu().numpy(), gt_coords=gt)


def pretraining_path(save_dir: str, model: str) -> str:
    """Where a BlurBall ball run keeps its best checkpoint and `--pretraining` reads it."""
    return os.path.join(save_dir, "pretraining_blurball", model, "model.pt")


def warm_start(model, path: str, what: str):
    """Load the checkpoint at `path` into `model`, every tensor at its shape, as the JAX
    trainer takes the warm tree whole. Returns (tensors loaded, tensors of the model);
    raises ValueError when the checkpoint does not fit (`what` names the model)."""
    warm = load_checkpoint(path)[0]
    target = model.state_dict()
    fits = {k: v for k, v in warm.items() if k in target and v.shape == target[k].shape}
    missing = model.load_state_dict(fits, strict=False).missing_keys
    n_loaded = len(target) - len(missing)
    if missing or len(fits) < len(warm):
        raise ValueError(f"{path} does not fit {what}: loaded {n_loaded}/{len(target)} "
                         f"tensors, {len(warm) - len(fits)} of the checkpoint's left over")
    return n_loaded, len(target)


def summary_writer(log_dir: str):
    """A TensorBoard writer at log_dir where `torch.utils.tensorboard` imports, else None."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", choices=["ball", "table"], default="ball")
    p.add_argument("--model", type=str, default="segformerpp_b2")
    p.add_argument("--data", choices=["tthq", "blurball"], default="tthq",
                   help="blurball: the pretraining set")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--pretraining", action="store_true",
                   help="warm-start from <save_dir>/pretraining_blurball/<model>/model.pt")
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="warm-start checkpoint (a torch state dict; overrides --pretraining)")
    p.add_argument("--torch_init", type=str, default=None,
                   help="the reference's raw pretrained torch weights: wasb / hrnet "
                        "(initialization/wasb/model.pth) or vitpose "
                        "(initialization/vitpose/mae_pretrain_vit_*.pth), filtered by name "
                        "and shape, the first conv widened to the input frames")
    p.add_argument("--hf_backbone", type=str, default=None,
                   help="a HuggingFace nvidia/mit-bN torch state dict (.pt/.bin): the "
                        "SegFormer backbone's initial weights")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=None,
                   help="default: 10 on blurball, 50 for the ball and 700 for the table on tthq")
    p.add_argument("--val_iterations", type=int, default=500)
    p.add_argument("--val_samples", type=int, default=None,
                   help="cap the validation set (default: a full pass)")
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_dir", type=str, default="saved_models")
    p.add_argument("--logdir", type=str, default="runs")
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel processes, one per card under torchrun (default: the "
                        "world size; 1 when it does not divide the batch)")
    p.add_argument("--max_steps", type=int, default=None, help="stop after this many steps")
    p.add_argument("--resolution", type=int, nargs=2, default=None,
                   help="model input resolution W H in place of the model's own")
    p.add_argument("--eval_resolution", type=int, nargs=2, default=None,
                   help="evaluation resolution W H in place of 1920x1080")
    p.add_argument("--in_frames", type=int, choices=(1, 3), default=None,
                   help="ball input frames, 1 or 3; the table takes 1")
    p.add_argument("--heatmap_sigma", type=float, default=6.0,
                   help="Gaussian target sigma at the evaluation resolution")
    p.add_argument("--not_use_invis", action="store_true",
                   help="leave invisible-ball samples out of training and validation")
    p.add_argument("--exp_id", type=str, default=None,
                   help="experiment tag in the run identifier")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection: a NaN in the backward raises where it "
                        "arose (the JAX trainer's jax_debug_nans)")
    p.add_argument("--debug", action="store_true",
                   help="logs and checkpoints to <dir>_tmp, and --debug_nans")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _check_args(args):
    if args.model not in TRAINABLE_MODELS:
        raise ValueError(f"--model {args.model}: unknown; the trainable detectors are "
                         f"{TRAINABLE_MODELS}")
    if args.hf_backbone and "segformer" not in args.model:
        raise ValueError("--hf_backbone needs a segformer model")


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict from a file, unwrapped from an MAE checkpoint's `["model"]` or
    a `["state_dict"]`, as the JAX trainer reads `--torch_init`."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]  # the MAE checkpoint layout
    elif isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return sd


def init_from_torch(model, path: str, model_name: str, in_frames: int):
    """`--torch_init`: the reference's raw pretrained weights into `model` in place.
    Returns (n_loaded, n_total)."""
    from upliftingtabletennis_torch.utils.port_torch import torch_init_detector

    state, n_loaded, n_total = torch_init_detector(model.state_dict(), load_torch_weights(path),
                                                   model_name, in_frames)
    model.load_state_dict(state)
    return n_loaded, n_total


def init_hf_backbone(model, path: str, in_frames: int) -> None:
    """`--hf_backbone`: a HuggingFace mit-bN encoder into a SegFormer's backbone, in place;
    the first patch embedding (OIHW) tiled over the input frames along its input channels
    and divided by their count. Every backbone tensor must be given, at its shape."""
    from upliftingtabletennis_torch.utils.port_torch import port_hf_segformer_backbone

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    ported = port_hf_segformer_backbone(sd)
    if in_frames != 1:
        ported["patch_embed_0.weight"] = (ported["patch_embed_0.weight"]
                                          .repeat(1, in_frames, 1, 1) / in_frames)
    model.backbone.load_state_dict(ported, strict=True)


def _to_device(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32) for a in arrays]


def _data_parallel(args):
    """(dp, world) of the run: dp is `--dp` or the world size, 1 when it does not
    divide the batch (every rank then runs the whole batch); more than the world raises,
    as the JAX mesh does, and so does a dp between 1 and the world size."""
    world = dist_util.process_count()
    dp = args.dp or world
    if args.batch_size % dp != 0:
        dp = 1
    if dp > world:
        raise ValueError(f"--dp {dp} needs {dp} processes (torchrun --nproc_per_node {dp}), "
                         f"have {world}")
    if 1 < dp < world:
        raise ValueError(f"--dp {dp}: data parallelism runs over every process ({world}) or "
                         f"none")
    return dp, world


def main(argv=None):
    args = _parser().parse_args(argv)
    _check_args(args)
    if args.debug:
        args.debug_nans = True
        args.logdir = args.logdir.rstrip("/") + "_tmp"
        args.save_dir = args.save_dir.rstrip("/") + "_tmp"
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.num_epochs is None:
        args.num_epochs = 10 if args.data == "blurball" else (50 if args.task == "ball" else 700)
    device = resolve_device(args.device)
    started = dist_util.initialize_multihost(device=device)
    try:
        _train(args, dist_util.local_device(device))
    finally:
        if started:
            dist_util.shutdown()


def _train(args, device):
    # bf16 forward on the card (the kernels' type), f32 parameters and optimizer state
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    dp, world = _data_parallel(args)
    main_rank = dist_util.is_main_process()
    say = dist_util.main_process_only(functools.partial(print, flush=True))

    task = args.task
    in_frames = (args.in_frames or 3) if task == "ball" else 1
    model, (MW, MH) = get_detector(args.model, task, in_frames=in_frames, train=True,
                                   remat=True, resolution=args.resolution)
    eval_model, _ = get_detector(args.model, task, in_frames=in_frames, train=False,
                                 resolution=args.resolution)
    EW, EH = args.eval_resolution or (D.EVAL_WIDTH, D.EVAL_HEIGHT)
    # a flip would swap the table's left and right keypoints
    aug_cfg = ImageAugmentConfig(flip_prob=0.5 if task == "ball" else 0.0)

    use_invis = not args.not_use_invis
    if task == "ball":
        index_fn, batch_fn = ((D.load_tthq_ball_index, D.load_ball_batch) if args.data == "tthq"
                              else (D.load_blurball_index, D.load_blurball_ball_batch))
        index_tr = index_fn(args.data_root, "train", use_invisible=use_invis)
        index_va = index_fn(args.data_root, "val", use_invisible=use_invis)

        def load(root, samples):
            return batch_fn(root, samples, in_frames=in_frames)
    else:
        index_fn, load = ((D.load_tthq_table_index, D.load_table_batch) if args.data == "tthq"
                          else (D.load_blurball_table_index, D.load_blurball_table_batch))
        index_tr = index_fn(args.data_root, "train")
        index_va = index_fn(args.data_root, "val")
    say(f"[data] {args.data}: {len(index_tr)} train / {len(index_va)} val samples")
    if not index_tr:  # the JAX trainer would run its epochs without a step
        raise ValueError(f"--data {args.data}: no training samples under {args.data_root}")
    say(f"[parallel] dp={dp} process(es) of {world}")

    init_weights(model, args.seed)
    init_ckpt = args.init_checkpoint
    if init_ckpt is None and args.pretraining:
        init_ckpt = pretraining_path(args.save_dir, args.model)
    if init_ckpt:
        n_loaded, n_total = warm_start(model, init_ckpt, f"{task}/{args.model}")
        say(f"[init] warm-started from {init_ckpt}: loaded {n_loaded}/{n_total} tensors")
    if args.torch_init:
        n_loaded, n_total = init_from_torch(model, args.torch_init, args.model, in_frames)
        say(f"[init] loaded {n_loaded}/{n_total} tensors from {args.torch_init}")
    if args.hf_backbone:
        init_hf_backbone(model, args.hf_backbone, in_frames)
        say(f"[init] MiT backbone initialized from {args.hf_backbone}")
    model.to(device)
    eval_model.to(device)
    params = list(model.parameters())
    ema = [p.detach().clone() for p in params]
    opt_state = init_adam(params)
    gen = torch.Generator().manual_seed(args.seed)
    net, shard = model, None
    if dp > 1:
        from torch.nn.parallel import DistributedDataParallel

        BN.sync_batch_stats(model)
        # an HRNet's last fuse layers reach no output: their parameters get no gradient
        net = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, find_unused_parameters=args.model in ("wasb", "hrnet"))
        shard = (dist_util.local_batch_slice(args.batch_size), args.batch_size)

    exp = f"_exp:{args.exp_id}" if args.exp_id else ""
    identifier = f"{task}_{args.model}{exp}_{time.strftime('%m%d%Y-%H%M%S')}"
    hparams = {"task": task, "model": args.model, "lr": args.lr, "batch_size": args.batch_size,
               "resolution": [MW, MH], "in_frames": in_frames,
               "heatmap_sigma": args.heatmap_sigma, "use_invis": use_invis,
               "exp_id": args.exp_id, "data": args.data}
    log_dir = os.path.join(args.logdir, identifier)
    writer = None
    if main_rank:
        os.makedirs(log_dir, exist_ok=True)
        writer = summary_writer(log_dir)

    def ema_model():
        """The eval model with the EMA weights and the current batch statistics."""
        with torch.no_grad():
            for q, e in zip(eval_model.parameters(), ema):
                q.copy_(e)
            for q, b in zip(eval_model.buffers(), model.buffers()):
                q.copy_(b)
        return eval_model.train(False)  # an HRNet folds the new weights

    def val_batches():  # full batches only, as the reference validates
        n_val = len(index_va) if args.val_samples is None else min(len(index_va),
                                                                   args.val_samples)
        for s in range(0, n_val, args.batch_size):
            batch = index_va[s:s + args.batch_size]
            if len(batch) < args.batch_size:
                return
            yield _to_device(device, *load(args.data_root, batch))

    best_pck5 = -1.0
    it = 0
    loss = None
    steps_per_epoch = len(index_tr) // args.batch_size
    rng_np = np.random.default_rng(args.seed)
    try:
        for epoch in range(args.num_epochs):
            order = rng_np.permutation(len(index_tr))

            def make_batch(i):
                sel = [index_tr[j] for j in order[i * args.batch_size:(i + 1) * args.batch_size]]
                return load(args.data_root, sel if shard is None else sel[shard[0]])

            for batch in D.Prefetcher(make_batch, steps_per_epoch):
                loss = train_step(net, params, opt_state, ema, gen, *_to_device(device, *batch),
                                  (MW, MH), (EW, EH), aug_cfg, args.heatmap_sigma, args.lr,
                                  args.ema_decay, dtype, shard)
                it += 1
                done = bool(args.max_steps and it >= args.max_steps)
                if main_rank and (it % args.val_iterations == 0 or done):
                    metrics = validate(ema_model(), val_batches(), task, (MW, MH), (EW, EH), dtype)
                    print(f"it {it}: loss {float(loss):.4f} {metrics}", flush=True)
                    with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
                        f.write(json.dumps({"it": it, "loss": float(loss), **metrics}) + "\n")
                    if writer is not None:
                        writer.add_scalar("train/loss", float(loss), it)
                        for mk, mv in metrics.items():
                            writer.add_scalar(f"val/{mk}", mv, it)
                        if len(index_va):
                            first = _to_device(device, *load(args.data_root, index_va[:1]))
                            writer.add_image("val/overlay", overlay_image(
                                eval_model, *first, (MW, MH), dtype), it, dataformats="HWC")
                    if metrics.get("pck5", -1) > best_pck5:
                        best_pck5 = metrics["pck5"]
                        state = eval_model.state_dict()  # the EMA weights, the batch statistics
                        info = {"epoch": epoch, **hparams}
                        save_checkpoint(os.path.join(args.save_dir, identifier, "model.pt"), state,
                                        identifier, info)
                        if args.data == "blurball" and task == "ball":
                            save_checkpoint(pretraining_path(args.save_dir, args.model), state,
                                            identifier, info)
                if done:
                    say(f"[done] max_steps reached, final loss {float(loss):.4f}")
                    return
            if loss is not None:
                say(f"epoch {epoch}: loss {float(loss):.4f}")
    finally:
        if writer is not None:
            writer.close()

if __name__ == "__main__":
    main()
