"""Detector trainer (ball and table) for the SegFormer and HRNet models, CLI.

Port of `upliftingtabletennis_tpu/train/run_detection.py` (`main`, `:29-413`):

    python -m upliftingtabletennis_torch.train.run_detection \\
        --task ball --model segformerpp_b2 --data_root <root with tthq/>

The same recipe: the augmentation of `data/image_transforms.py`, Gaussian targets at
the 1920x1080 evaluation resolution, the weighted MSE on the logits upscaled
bilinearly to it, the batch statistics of the BatchNorms (a SegFormer's head; every
BatchNorm of WASB and the table HRNet, built with `remat` as the JAX trainer builds
them), optax's
`clip_by_global_norm(5.0)` then Adam (lr 1e-3), an EMA of the parameters (0.999),
validation of the EMA weights with the current batch statistics every
`--val_iterations` steps by PCK at 2, 5, 10 and 20 px, and a checkpoint of the best
PCK@5. The step is factored (`loss_fn`, `apply_update`, `infer`, `validate`) so each
piece can be held against the JAX trainer.

Parameters and Adam's state are f32, as in JAX. On the card the forward runs in bf16:
a SegFormer through the differentiable kernels K1 and K2, whose backward recomputes
through K4; an HRNet through cuDNN convolutions (unfolded, BatchNorm statistics in f32);
the loss is f32. Validation runs the inference model (an HRNet folded, through K5). Random draws come from a `torch.Generator`
seeded with `--seed`, not from `jax.random`. Logs go to stdout and, one JSON line per
validation, to `<logdir>/<identifier>/metrics.jsonl`.

Not ported yet (each raises, naming the ROADMAP item that ports it): `--model vitpose`,
`--data blurball`, `--dp`, `--torch_init` and `--hf_backbone`.
"""
from __future__ import annotations

import argparse
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
                                                             augment_detection_batch)
from upliftingtabletennis_torch.eval import metrics as M
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.ops.peak import extract_peaks
from upliftingtabletennis_torch.pipeline.interface import init_weights
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["main", "heatmap", "n_points", "loss_fn", "init_adam", "apply_update", "eval_coords", "train_step",
           "infer", "validate", "TRAINABLE_MODELS"]

TRAINABLE_MODELS = ("segformerpp_b0", "segformerpp_b2", "wasb", "hrnet")
CLIP_NORM = 5.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PCK_TOLERANCES = (2, 5, 10, 20)


def heatmap(out) -> torch.Tensor:
    """A detector's heatmap (B, h, w, P): SegFormer and WASB return (heatmap, extra), the
    table HRNet the heatmap alone."""
    return out[0] if isinstance(out, tuple) else out


def n_points(model) -> int:
    """The heatmap channels of a detector."""
    head = getattr(model, "decode_head", None)
    return head.conv_seg.out_channels if head is not None else model.out_channels


def loss_fn(model, imgs, target):
    """Forward of a model in training mode, logits upscaled (bilinear, half-pixel) to the
    target's resolution in f32, weighted MSE. imgs (B, H, W, C_in); target (B, P, EH, EW).
    Returns (loss, the model's batch statistics, updated by this forward)."""
    logits = heatmap(model(imgs)).permute(0, 3, 1, 2).float()
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
               ema_decay: float = 0.999, dtype=torch.float32):
    """One training step on a batch at the source resolution (images (B, H, W, C_in) f32 in
    [0, 255], coords (B, P', 2) in source pixels, vis (B, P')): augmentation, targets at
    the evaluation resolution, `loss_fn` with the forward in `dtype`, the gradients of
    `params`, `apply_update`. Returns the loss (a device scalar)."""
    imgs, c_model, v = augment_detection_batch(gen, images, coords, vis, model_wh, aug_cfg, True)
    P = n_points(model)
    c_eval = eval_coords(c_model, model_wh, eval_wh)
    target = M.render_gaussian_heatmaps(c_eval[:, :P], v[:, :P], eval_wh[1], eval_wh[0], sigma)
    loss, _ = loss_fn(model, imgs.to(dtype), target)
    # parameters no output reaches (an HRNet's last fuse layers) get zeros, as in JAX
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
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


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--task", choices=["ball", "table"], default="ball")
    p.add_argument("--model", type=str, default="segformerpp_b2")
    p.add_argument("--data", choices=["tthq", "blurball"], default="tthq")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--pretraining", action="store_true",
                   help="warm-start from <save_dir>/pretraining_blurball/<model>/model.pt")
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="warm-start checkpoint (a torch state dict; overrides --pretraining)")
    p.add_argument("--torch_init", type=str, default=None)
    p.add_argument("--hf_backbone", type=str, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=None,
                   help="default: 50 for the ball, 700 for the table")
    p.add_argument("--val_iterations", type=int, default=500)
    p.add_argument("--val_samples", type=int, default=None,
                   help="cap the validation set (default: a full pass)")
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_dir", type=str, default="saved_models")
    p.add_argument("--logdir", type=str, default="runs")
    p.add_argument("--dp", type=int, default=None)
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


def _refuse_unported(args):
    if args.model not in TRAINABLE_MODELS:
        raise ValueError(f"--model {args.model}: only {TRAINABLE_MODELS} train in the port so "
                         f"far; the ViTPose trainer is ROADMAP queue 1 item 5")
    if args.data == "blurball":
        raise ValueError("--data blurball: the BlurBall readers are ROADMAP queue 1 item 7")
    for flag in ("dp", "torch_init", "hf_backbone"):
        if getattr(args, flag) is not None:
            raise ValueError(f"--{flag} is not ported yet (ROADMAP queue 1 item 5)")


def _to_device(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32) for a in arrays]


def main(argv=None):
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.debug:
        args.debug_nans = True
        args.logdir = args.logdir.rstrip("/") + "_tmp"
        args.save_dir = args.save_dir.rstrip("/") + "_tmp"
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    if args.num_epochs is None:
        args.num_epochs = 50 if args.task == "ball" else 700
    device = resolve_device(args.device)
    # bf16 forward on the card (the kernels' type), f32 parameters and optimizer state
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    task = args.task
    in_frames = (args.in_frames or 3) if task == "ball" else 1
    model, (MW, MH) = get_detector(args.model, task, in_frames=in_frames, train=True,
                                   remat=True)
    eval_model, _ = get_detector(args.model, task, in_frames=in_frames, train=False)
    if args.resolution:
        MW, MH = args.resolution
    EW, EH = args.eval_resolution or (D.EVAL_WIDTH, D.EVAL_HEIGHT)
    # a flip would swap the table's left and right keypoints
    aug_cfg = ImageAugmentConfig(flip_prob=0.5 if task == "ball" else 0.0)

    use_invis = not args.not_use_invis
    if task == "ball":
        index_tr = D.load_tthq_ball_index(args.data_root, "train", use_invisible=use_invis)
        index_va = D.load_tthq_ball_index(args.data_root, "val", use_invisible=use_invis)

        def load(root, samples):
            return D.load_ball_batch(root, samples, in_frames=in_frames)
    else:
        index_tr = D.load_tthq_table_index(args.data_root, "train")
        index_va = D.load_tthq_table_index(args.data_root, "val")
        load = D.load_table_batch
    print(f"[data] {args.data}: {len(index_tr)} train / {len(index_va)} val samples")

    init_weights(model, args.seed)
    init_ckpt = args.init_checkpoint
    if init_ckpt is None and args.pretraining:
        init_ckpt = os.path.join(args.save_dir, "pretraining_blurball", args.model, "model.pt")
    if init_ckpt:
        model.load_state_dict(load_checkpoint(init_ckpt)[0])
        print(f"[init] warm-started from {init_ckpt}")
    model.to(device)
    eval_model.to(device)
    params = list(model.parameters())
    ema = [p.detach().clone() for p in params]
    opt_state = init_adam(params)
    gen = torch.Generator().manual_seed(args.seed)

    exp = f"_exp:{args.exp_id}" if args.exp_id else ""
    identifier = f"{task}_{args.model}{exp}_{time.strftime('%m%d%Y-%H%M%S')}"
    hparams = {"task": task, "model": args.model, "lr": args.lr, "batch_size": args.batch_size,
               "resolution": [MW, MH], "in_frames": in_frames,
               "heatmap_sigma": args.heatmap_sigma, "use_invis": use_invis,
               "exp_id": args.exp_id, "data": args.data}
    log_dir = os.path.join(args.logdir, identifier)
    os.makedirs(log_dir, exist_ok=True)

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
    for epoch in range(args.num_epochs):
        order = rng_np.permutation(len(index_tr))

        def make_batch(i):
            sel = [index_tr[j] for j in order[i * args.batch_size:(i + 1) * args.batch_size]]
            return load(args.data_root, sel)

        for batch in D.Prefetcher(make_batch, steps_per_epoch):
            loss = train_step(model, params, opt_state, ema, gen, *_to_device(device, *batch),
                              (MW, MH), (EW, EH), aug_cfg, args.heatmap_sigma, args.lr,
                              args.ema_decay, dtype)
            it += 1
            done = bool(args.max_steps and it >= args.max_steps)
            if it % args.val_iterations == 0 or done:
                metrics = validate(ema_model(), val_batches(), task, (MW, MH), (EW, EH), dtype)
                print(f"it {it}: loss {float(loss):.4f} {metrics}")
                with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
                    f.write(json.dumps({"it": it, "loss": float(loss), **metrics}) + "\n")
                if metrics.get("pck5", -1) > best_pck5:
                    best_pck5 = metrics["pck5"]
                    state = eval_model.state_dict()  # the EMA weights, the batch statistics
                    save_checkpoint(os.path.join(args.save_dir, identifier, "model.pt"), state,
                                    identifier, {"epoch": epoch, **hparams})
            if done:
                print(f"[done] max_steps reached, final loss {float(loss):.4f}")
                return
        if loss is not None:
            print(f"epoch {epoch}: loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
