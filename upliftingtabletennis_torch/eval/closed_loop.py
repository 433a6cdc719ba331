"""Closed-loop pipeline accuracy against physics truth, with no real data.

Port of `upliftingtabletennis_tpu/eval/closed_loop.py`. The protocol:

1. Physics trajectories (`data/datagen.py`) are projected through sampled broadcast-like
   cameras (`data/synthetic.py`) and rendered into frames on the device
   (`data/render_rally.py`).
2. A ball and a table detector train on frames rendered inside the loop (each sample
   rendered at 1920x1080 and resized to the detector's input, as the pipeline resizes).
3. The whole pipeline (`TableTennisPipeline.run_rally`: detect, the dual-model filter,
   the DBSCAN table fusion, RANSAC calibration, uplifting) runs on held-out rallies
   rendered at 1920x1080 and is scored against the simulation: ball and table px
   error, calibration reprojection, 3D error (cm), the spin label; and, optionally, the
   training-free physics-fit arm (`core/fitting.py`) seeded by the uplifting model.

    python -m upliftingtabletennis_torch.eval.closed_loop \\
        --data_dir <syntheticdata root> --out <dir> --train_steps 600 --n_eval 32 \\
        [--uplifting_checkpoint <port checkpoint>] [--skip_train]

Checkpoints are port checkpoints (`utils/checkpoint.py`): `<out>/<task>_detector` and
its `.json` (model, task, render_res, val_px_err). The draws come from
`torch.Generator`s seeded as the JAX package seeds its keys (the store, each training
task, each validation batch, each held-out rally's camera and noise), not from
`jax.random`. The detectors train as the HRNet and SegFormer trainers do on the card:
a bf16 forward, the BatchNorm statistics and the loss in f32, f32 parameters and Adam.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["EVAL_W", "EVAL_H", "EMA_DECAY", "ema_update", "ema_finalize", "ema_decay_for",
           "warmup_cosine_lr", "soft_argmax_px", "detector_loss", "sample_rendered",
           "make_batch", "train_detectors", "score_rally", "render_held_out",
           "evaluate_pipeline", "main"]

EVAL_W, EVAL_H = 1920, 1080  # the pipeline's working resolution
EMA_DECAY = 0.999


def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float = EMA_DECAY) -> List[torch.Tensor]:
    """One step of a zero-initialised EMA (finish with `ema_finalize`)."""
    return [decay * e + (1.0 - decay) * q for e, q in zip(ema, params)]


def ema_finalize(ema: Sequence[torch.Tensor], n_steps: int,
                 decay: float = EMA_DECAY) -> List[torch.Tensor]:
    """Debias a zero-initialised EMA: for constant parameters p the result is p at any
    step count (an EMA started at the random initialisation keeps decay**n of it)."""
    bias_corr = 1.0 - decay ** n_steps
    return [e / bias_corr for e in ema]


def ema_decay_for(train_steps: int, decay: float = EMA_DECAY) -> float:
    """The EMA's horizon scaled to the run: at most about 10% of it."""
    return min(decay, 1.0 - 10.0 / max(train_steps, 20))


def warmup_cosine_lr(step: int, lr: float, warmup: int, n_updates: int) -> float:
    """optax's warmup_cosine_decay_schedule(0, lr, warmup, n_updates, 0.03 lr) at `step`:
    linear from 0 to lr over `warmup` updates, then a cosine down to 0.03 lr at
    `n_updates`."""
    if step < warmup:
        return lr * step / warmup
    decay_steps = n_updates - warmup
    t = min(step - warmup, decay_steps)
    alpha = 0.03
    return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)


def _load_store(data_dir, modes=("intermediate",), device="cuda"):
    """The trajectory store: the shards `<data_dir>/<mode>/<direction>.npz`, or 256
    intermediate trajectories generated on `device` (seed 0)."""
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data import synthetic as SYN

    stores = []
    if data_dir and os.path.isdir(data_dir):
        for mode in modes:
            for direction in DG.DIRECTIONS:
                npz = os.path.join(data_dir, mode, f"{direction}.npz")
                if os.path.isfile(npz):
                    stores.append(SYN.load_store_npz(npz))
    if not stores:
        dev = resolve_device(device)
        res = DG.generate_dataset(256, "intermediate", "left_to_right",
                                  generator=torch.Generator(device=dev).manual_seed(0),
                                  device=dev)
        stores.append(SYN.store_from_datagen(res))
    return SYN.concat_stores(stores)


def _detector_meta(ckpt, default_name, default_res):
    """(model, render_res) from a checkpoint's metadata: a --skip_train evaluation runs
    the detectors as they were trained, whatever --render_res says."""
    try:
        with open(ckpt + ".json") as f:
            info = json.load(f)["additional_info"]
        name = info.get("model", default_name)
        res = tuple(info.get("render_res", default_res))
    except (OSError, ValueError, KeyError):
        return default_name, tuple(default_res)
    if tuple(default_res) != res:
        print(f"[closed_loop] WARNING: --render_res {tuple(default_res)} != the checkpoint's "
              f"trained resolution {res} ({ckpt}); using the checkpoint's", flush=True)
    return name, res


def _pipeline_from(ball_ckpt, table_ckpt, uplifting_checkpoint, model_res, chunk=8,
                   device="cuda"):
    """A pipeline with the closed-loop detectors. Main and aux share one model per task,
    so the dual-model filter always agrees (it, the DBSCAN fusion, the calibration and
    the uplifting still run)."""
    from upliftingtabletennis_torch.pipeline.interface import (BallDetector, TableDetector,
                                                               TableTennisPipeline,
                                                               UpliftingModel)

    ball_name, ball_res = _detector_meta(ball_ckpt, "wasb", model_res)
    table_name, table_res = _detector_meta(table_ckpt, "hrnet", model_res)
    pipe = TableTennisPipeline.__new__(TableTennisPipeline)
    pipe.ball_detector = pipe.ball_detector_aux = BallDetector(
        ball_name, ball_ckpt, chunk, resolution=ball_res, device=device)
    pipe.table_detector = pipe.table_detector_aux = TableDetector(
        table_name, table_ckpt, chunk, resolution=table_res, device=device)
    if uplifting_checkpoint:
        pipe.uplifting_model = UpliftingModel(uplifting_checkpoint, device=device)
    else:
        print("[closed_loop] WARNING: no --uplifting_checkpoint: the uplifting arm runs "
              "random weights; its 3D and spin numbers are noise (the physics-fit arm is "
              "unaffected)", flush=True)
        pipe.uplifting_model = UpliftingModel(name="connectstage", size="small", device=device)
    pipe.KEYPOINT_VISIBLE = 1
    return pipe


# --- detector training ----------------------------------------------------------------
def sample_rendered(store, pool, batch: int, task: str, render_res, gen: torch.Generator):
    """A batch rendered on the store's device: images (B, RH, RW, 9 | 3) in [0, 255]
    (the ball's prev, cur, next frames; the table's one), coords (B, 1 | 13, 2) at
    1920x1080 and visibility (B, 1 | 13). Each frame is rendered at 1920x1080 and resized
    to render_res (bilinear, half-pixel, no antialias; rounded half to even), as the
    pipeline's resize makes the detectors' inputs."""
    from upliftingtabletennis_torch.core.geometry import HEIGHT as UPL_H, WIDTH as UPL_W
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.render_rally import (project_context, render_frames,
                                                               rescale_px)

    RW, RH = render_res
    dev = store.blur_positions.device
    pool = torch.as_tensor(np.asarray(pool), device=dev)
    idx = pool[torch.randperm(len(pool), generator=gen, device=dev)[:batch]]
    sample = SYN.assemble_batch(store, idx, train=True, generator=gen)
    r_img, mask, table_img = sample["r_img"], sample["mask"], sample["table_img"]
    T = r_img.shape[1]
    # a random valid frame, not the first or last, so the triplet stays in the rally
    u = torch.rand(batch, generator=gen, device=dev)
    n_valid = mask.sum(1)
    t_mid = torch.clamp((u * (n_valid - 2)).to(torch.int64) + 1, 1, T - 2)
    up, ev = (UPL_W, UPL_H), (EVAL_W, EVAL_H)
    table_px = rescale_px(table_img[..., :2], up, ev)
    ball_px_all = rescale_px(r_img, up, ev)
    ctx_px = rescale_px(project_context(sample["Mint"], sample["Mext"]), up, ev)
    images = []
    for b in range(batch):
        t = int(t_mid[b])
        ts = [t - 1, t, t + 1] if task == "ball" else [t]
        frames = render_frames(ball_px_all[b, ts], mask[b, ts], table_px[b], EVAL_H, EVAL_W,
                               ctx_px[b], generator=gen)
        if (RW, RH) != (EVAL_W, EVAL_H):
            f = torch.nn.functional.interpolate(frames.permute(0, 3, 1, 2).float(),
                                                size=(RH, RW), mode="bilinear",
                                                align_corners=False)
            frames = torch.clamp(torch.round(f), 0, 255).permute(0, 2, 3, 1)
        images.append(torch.cat(list(frames.float()), dim=-1))
    bidx = torch.arange(batch, device=dev)
    if task == "ball":
        return (torch.stack(images), ball_px_all[bidx, t_mid][:, None],
                torch.ones(batch, 1, device=dev))
    return torch.stack(images), table_px, table_img[..., 2]


def make_batch(images, coords, vis, n_pts: int, out_hw, sigma: float):
    """(normalised images, targets (B, P, OH, OW), coords in the output grid, vis): the
    pixel-centre map of 1920x1080 coordinates into the model's output grid (the inverse
    of the pipeline's decode) and Gaussian targets there."""
    from upliftingtabletennis_torch.data.image_transforms import normalize_image
    from upliftingtabletennis_torch.eval import metrics as M

    OH, OW = out_hw
    s = torch.tensor([OW / EVAL_W, OH / EVAL_H], device=coords.device)
    coords_m = (coords[:, :n_pts] + 0.5) * s - 0.5
    target = M.render_gaussian_heatmaps(coords_m, vis[:, :n_pts], OH, OW, sigma)
    return normalize_image(images.float()), target, coords_m, vis[:, :n_pts]


def soft_argmax_px(heat_bchw: torch.Tensor, beta: float) -> torch.Tensor:
    """Per-channel spatial-softmax expectation (DSNT), in output-grid pixels (B, C, 2)."""
    B, C, H, W = heat_bchw.shape
    p = torch.softmax((beta * heat_bchw).reshape(B, C, -1), dim=-1).reshape(B, C, H, W)
    ex = (p * torch.arange(W, dtype=torch.float32, device=p.device)).sum((-2, -1))
    ey = (p * torch.arange(H, dtype=torch.float32, device=p.device)[:, None]).sum((-2, -1))
    return torch.stack([ex, ey], -1)


def detector_loss(model, images, target, coords_m, vis, coord_weight: float = 5.0,
                  beta: float = 20.0):
    """(loss, mse, coord): the weighted heatmap MSE at the model's output grid plus
    coord_weight x the soft-argmax L1 on frame-normalised coordinates, in f32."""
    from upliftingtabletennis_torch.eval import metrics as M
    from upliftingtabletennis_torch.train.run_detection import heatmap

    logits = heatmap(model(images)).permute(0, 3, 1, 2).float()
    mse = M.weighted_mse_loss(logits, target)
    OH, OW = logits.shape[-2:]
    norm = torch.tensor([OW, OH], dtype=torch.float32, device=logits.device)
    l1 = torch.abs(soft_argmax_px(logits, beta) - coords_m) / norm
    m = (vis > 0).float()[..., None]
    coord = (l1 * m).sum() / torch.clamp_min(m.sum() * 2, 1.0)
    return mse + coord_weight * coord, mse, coord


def _state_with(model, params: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of the model's state dict (on the CPU) with `params` as its parameters."""
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for (name, _), p in zip(model.named_parameters(), params):
        state[name] = p.detach().cpu().clone()
    return state


def train_detectors(store, args, device="cuda") -> Dict[str, str]:
    """Train the ball (triplets) and table (single frames) detectors of args.tasks on
    frames rendered inside the loop; save each as `<out>/<task>_detector`. Returns the
    checkpoint paths."""
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.models.factory import get_detector
    from upliftingtabletennis_torch.ops.peak import extract_peaks
    from upliftingtabletennis_torch.pipeline.interface import init_weights
    from upliftingtabletennis_torch.train.run_detection import apply_update, heatmap, init_adam
    from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    dev = resolve_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    RW, RH = args.render_res
    B = args.batch_size
    store_d = SYN.store_to_device(store, dev)
    train_idx = SYN.split_indices(len(store), "train")
    val_idx = SYN.split_indices(len(store), "val")

    results = {}
    for task in args.tasks:
        model_name = args.ball_model if task == "ball" else args.table_model
        n_ch, n_pts = (9, 1) if task == "ball" else (3, 13)
        model, _ = get_detector(model_name, task, train=True, remat=True)
        eval_model, _ = get_detector(model_name, task, train=False)
        init_weights(model, args.seed + (0 if task == "ball" else 1))
        if args.init_from:  # warm start, with a fresh optimizer and schedule
            src = os.path.join(args.init_from, f"{task}_detector")
            state, _, src_info = load_checkpoint(src)
            model.load_state_dict(state)
            print(f"[{task}] warm-start from {src} (val_px_err {src_info.get('val_px_err')})",
                  flush=True)
        model.to(dev)
        eval_model.to(dev)
        with torch.no_grad():  # the output grid: HRNet's full resolution, SegFormer's 1/4
            OH, OW = heatmap(eval_model(torch.zeros(1, RH, RW, n_ch, device=dev,
                                                    dtype=dtype))).shape[1:3]
        accum = max(1, args.accum)
        n_updates = max(1, args.train_steps // accum)
        # warmup then cosine decay; tiny runs keep a positive decay span
        warmup = min(min(100, max(10, n_updates // 20)), max(1, n_updates // 2))
        decay = ema_decay_for(args.train_steps)
        params = list(model.parameters())
        opt_state = init_adam(params)
        ema = [torch.zeros_like(p) for p in params]  # see ema_finalize
        acc = [torch.zeros_like(p) for p in params]  # optax.MultiSteps' running mean
        mini = 0
        # the loss at the output grid, sigma scaled from 6 px at 1920x1080, at least 1.5
        sigma_model = max(6.0 * OW / EVAL_W, 1.5)
        gen = torch.Generator(device=dev).manual_seed(args.seed + (0 if task == "ball" else 1))

        def batch_from(g, pool):
            images, coords, vis = sample_rendered(store_d, pool, B, task, (RW, RH), g)
            return images, coords, vis

        def val_px(state, n_batches=6, seed0=7_000):
            """Mean px error of the peaks at 1920x1080 over fixed validation batches."""
            eval_model.load_state_dict(state)
            eval_model.train(False)
            s = c = 0.0
            with torch.no_grad():
                for i in range(n_batches):
                    g = torch.Generator(device=dev).manual_seed(seed0 + i)
                    images, coords, vis = batch_from(g, val_idx)
                    x = make_batch(images, coords, vis, n_pts, (OH, OW), sigma_model)[0]
                    heat = heatmap(eval_model(x.to(dtype))).permute(0, 3, 1, 2).float()
                    pk = extract_peaks(heat, EVAL_W, EVAL_H)
                    err = torch.linalg.norm(pk[..., :2] - coords[:, :n_pts], dim=-1)
                    m = (vis[:, :n_pts] > 0).float()
                    s += float((err * m).sum())
                    c += float(m.sum())
            return s / max(c, 1.0)

        best = {"px": float("inf"), "state": None, "step": -1}
        evals_since_best = 0
        t0 = time.perf_counter()
        steps_run = args.train_steps
        for it in range(args.train_steps):
            images, target, coords_m, vis = make_batch(*batch_from(gen, train_idx), n_pts,
                                                       (OH, OW), sigma_model)
            loss, mse, coord = detector_loss(model, images.to(dtype), target, coords_m, vis,
                                             args.coord_weight, args.softargmax_beta)
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
            if accum == 1:
                apply_update(params, grads, opt_state, ema,
                             warmup_cosine_lr(opt_state["count"], args.lr, warmup, n_updates),
                             decay)
            else:  # update every accum microbatches, on their mean gradient
                with torch.no_grad():
                    for a, g in zip(acc, grads):
                        a.add_((g - a) / (mini + 1))
                mini += 1
                if mini == accum:
                    apply_update(params, acc, opt_state, ema,
                                 warmup_cosine_lr(opt_state["count"], args.lr, warmup,
                                                  n_updates), decay)
                    acc = [torch.zeros_like(p) for p in params]
                    mini = 0
                else:  # the parameters stay; the EMA moves every microbatch
                    with torch.no_grad():
                        for e, n in zip(ema, ema_update(ema, params, decay)):
                            e.copy_(n)
            last = it == args.train_steps - 1
            if it % 50 == 0 or last:
                print(f"[{task}] step {it}: loss {float(loss):.4f} (mse {float(mse):.4f} "
                      f"coord {float(coord):.4f}) ({time.perf_counter() - t0:.0f}s)", flush=True)
            if args.eval_every and ((it + 1) % args.eval_every == 0 or last):
                raw = _state_with(model, params)
                px = val_px(raw)
                marker = ""
                if px < best["px"]:
                    best = {"px": px, "state": raw, "step": it}
                    evals_since_best = 0
                    marker = "  *best*"
                    # kept at once: a run cut later can --init_from <out>/best_snapshot
                    save_checkpoint(os.path.join(args.out, "best_snapshot", f"{task}_detector"),
                                    raw, f"closed_loop_{model_name}",
                                    {"task": task, "model": model_name,
                                     "render_res": list(args.render_res),
                                     "weights": f"best@{it}", "val_px_err": px,
                                     "steps_run": it + 1})
                else:
                    evals_since_best += 1
                print(f"[{task}] step {it}: VAL px {px:.1f}{marker}", flush=True)
                if args.patience and evals_since_best >= args.patience and not last:
                    print(f"[{task}] early stop at step {it} (no val improvement in "
                          f"{args.patience} evals; best {best['px']:.1f} px @ step "
                          f"{best['step']})", flush=True)
                    steps_run = it + 1
                    break

        # pick among the last parameters, the debiased EMA and the best snapshot by
        # the validation px error
        cands = {"raw": _state_with(model, params),
                 "ema": _state_with(model, ema_finalize(ema, steps_run, decay))}
        if best["state"] is not None:
            cands[f"best@{best['step']}"] = best["state"]
        px_err = {name: val_px(state, n_batches=4, seed0=8_000) for name, state in cands.items()}
        chosen = min(px_err, key=px_err.get)
        print(f"[{task}] val detection px err: "
              + " ".join(f"{k} {v:.1f}" for k, v in px_err.items())
              + f" -> saving {chosen}", flush=True)
        ckpt = os.path.join(args.out, f"{task}_detector")
        save_checkpoint(ckpt, cands[chosen], f"closed_loop_{model_name}",
                        {"task": task, "model": model_name, "render_res": list(args.render_res),
                         "weights": chosen, "val_px_err": px_err[chosen],
                         "steps_run": steps_run})
        results[task] = ckpt
    return results


# --- evaluation -----------------------------------------------------------------------
def calib_reproj_px(Mint_c, Mext_c, table_out) -> float:
    """Mean reprojection error (px at 1920x1080) of a calibrated camera over the visible
    detected keypoints; inf with none visible."""
    from upliftingtabletennis_torch.core import geometry as G

    vis = table_out[:, 2] > 0
    if not vis.any():
        return float("inf")
    proj = G.world2img(torch.as_tensor(G.TABLE_POINTS, dtype=torch.float32),
                       torch.as_tensor(np.asarray(Mext_c), dtype=torch.float32),
                       torch.as_tensor(np.asarray(Mint_c), dtype=torch.float32)).numpy()
    return float(np.mean(np.linalg.norm(proj[vis] - table_out[vis, :2], axis=-1)))


def score_rally(out: dict, truth: dict, calib) -> dict:
    """The per-rally scores of one `run_rally` output against the simulation.

    truth: ball (T, 2) and table (13, 2) at 1920x1080, r_world (T, 3), w_local (3,) the
    spin in the flight frame; calib: (Mint, Mext, n_inliers) of `calibrate_camera`.
    Returns the ball errors (px) at the filtered frames, the table errors of the visible
    keypoints, the 3D errors (m), the spin score and label, and the calibration's inliers
    and reprojection."""
    vi = np.asarray(out["valid_idx"]) + 1  # valid_idx indexes the interior frames 1..T-2
    res = {"vi": vi, "ball": None, "table": None, "table_kp": {}, "pos3d": None,
           "spin": None}
    if len(vi):
        res["ball"] = np.linalg.norm(out["ball"] - truth["ball"][vi], axis=-1)
    table = np.asarray(out["table"])
    vis_kp = table[:, 2] > 0
    res["n_kp_visible"] = int(np.sum(vis_kp))
    if vis_kp.any():
        res["table"] = np.linalg.norm(table[vis_kp, :2] - truth["table"][vis_kp], axis=-1)
        res["table_kp"] = {int(kp): float(np.linalg.norm(table[kp, :2] - truth["table"][kp]))
                           for kp in np.flatnonzero(vis_kp)}
    Mint_c, Mext_c, n_inl = calib
    res["n_inliers"] = int(n_inl)
    res["reproj"] = calib_reproj_px(Mint_c, Mext_c, table)
    if out["pos3d"] is not None and len(out["pos3d"]) == len(vi):
        res["pos3d"] = np.linalg.norm(out["pos3d"] - truth["r_world"][vi], axis=-1)
    if out["spin"] is not None:
        res["spin"] = (float(out["spin"][1]), 1.0 if truth["w_local"][1] > 0 else 2.0)
    return res


def render_held_out(store, idx: int, seed: int):
    """Held-out rally `idx` of a store on the device: its sample (a fresh camera from a
    generator fixed by the rally), its valid length T, and its frames rendered at
    1920x1080 (the whole padded rally, the padding ball-free, cut to T) with noise from a
    generator seeded with `seed`, on the device."""
    from upliftingtabletennis_torch.core import geometry as G
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.render_rally import (project_context, render_frames,
                                                               rescale_px)

    dev = store.blur_positions.device
    g = torch.Generator(device=dev).manual_seed(10_000 + int(idx))
    sample = SYN.assemble_batch(store, torch.tensor([int(idx)], device=dev), train=True,
                                generator=g)
    mask = sample["mask"][0]
    T = int(mask.sum())
    up, ev = (G.WIDTH, G.HEIGHT), (EVAL_W, EVAL_H)
    sample["ball_eval"] = rescale_px(sample["r_img"][0], up, ev)
    sample["table_eval"] = rescale_px(sample["table_img"][0, :, :2], up, ev)
    ctx_eval = rescale_px(project_context(sample["Mint"][0], sample["Mext"][0]), up, ev)
    frames = render_frames(sample["ball_eval"], mask, sample["table_eval"], EVAL_H, EVAL_W,
                           ctx_eval, generator=torch.Generator(device=dev).manual_seed(seed))
    return sample, T, frames[:T]


def evaluate_pipeline(store, ckpts, args, device="cuda", pipe=None) -> dict:
    """Render held-out rallies at 1920x1080, run the whole pipeline on each and score it
    against the simulation (and the physics-fit arm unless args.skip_physics_fit).
    Writes `ball_frame_diag.json` and `rally_diag.json` to args.out."""
    from upliftingtabletennis_torch.core import geometry as G
    from upliftingtabletennis_torch.core import fitting as FIT
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.train.uplifting_train import spin_classification_metrics

    if pipe is None:
        pipe = _pipeline_from(ckpts["ball"], ckpts["table"], args.uplifting_checkpoint,
                              tuple(args.render_res), device=device)
    dev = pipe.device
    store_d = SYN.store_to_device(store, dev)
    test_idx = SYN.split_indices(len(store), "test")[:args.n_eval]

    ball_px_errs, table_px_errs, pos3d_errs = [], [], []
    table_kp_errs = [[] for _ in range(13)]
    spin_scores, spin_labels = [], []
    pf_pos3d, pf_cls, pf_lbl, pf_reproj, pf_spread, pf_seed_agree = [], [], [], [], [], []
    ball_frame_diag, rally_diag = [], []
    calib_inliers, calib_reprojs = [], []
    n_valid_frames = n_evaluated = n_pf_calib_fail = 0
    for j, ti in enumerate(test_idx):
        sample, T, frames = render_held_out(store_d, ti, j)
        if T < 8:
            continue
        n_evaluated += 1
        frames = frames.cpu().numpy()
        r_world = sample["r_world"][0, :T].cpu()
        times = sample["times"][0, :T].cpu().numpy()
        truth = {"ball": sample["ball_eval"][:T].cpu().numpy(),
                 "table": sample["table_eval"].cpu().numpy(), "r_world": r_world.numpy(),
                 "w_local": G.transform_rotation_axes(sample["rotation"][0].cpu(),
                                                      r_world).numpy()}
        fps = 1.0 / max(float(times[1] - times[0]), 1e-6)
        out = pipe.run_rally(frames, fps=fps)
        calib = pipe.calibrate_camera(out["table"])
        sc = score_rally(out, truth, calib)
        vi = sc["vi"]
        if sc["ball"] is not None:
            ball_px_errs.append(sc["ball"])
            n_valid_frames += len(vi)
            hits = np.atleast_1d(sample["hits"][0].cpu().numpy())  # first bounce, -1 if none
            bounces = hits[hits >= 0]
            for fi, err in zip(vi.tolist(), sc["ball"].tolist()):
                t_f = float(times[fi]) if fi < len(times) else 0.0
                ball_frame_diag.append({
                    "rally": int(ti), "frame": int(fi), "err_px": float(err),
                    "edge_dist": int(min(fi, T - 1 - fi)),
                    "dt_bounce_s": (float(np.min(np.abs(bounces - t_f))) if bounces.size
                                    else None),
                    "gt_x": float(truth["ball"][fi, 0]), "gt_y": float(truth["ball"][fi, 1])})
        if sc["table"] is not None:
            table_px_errs.append(sc["table"])
            for kp, e in sc["table_kp"].items():
                table_kp_errs[kp].append(e)
        calib_inliers.append(sc["n_inliers"])
        calib_reprojs.append(sc["reproj"])
        if sc["pos3d"] is not None:
            pos3d_errs.append(sc["pos3d"])
        rally_diag.append({
            "rally": int(ti), "T": T, "n_frames": int(len(vi)),
            "n_kp_visible": sc["n_kp_visible"], "n_inliers": sc["n_inliers"],
            "calib_reproj_px": float(sc["reproj"]),
            "table_px_mean": float(np.mean(sc["table"])) if sc["table"] is not None else None,
            "pos3d_err_cm_median": (float(100 * np.median(sc["pos3d"]))
                                    if sc["pos3d"] is not None else None),
            # the calibration's input and output, so that a rally can be calibrated
            # again elsewhere: the fused keypoints (x, y, visibility) in the frame
            # `resolution` (W, H), their truth, and the camera this run fitted
            "resolution": [int(frames.shape[2]), int(frames.shape[1])],
            "table_kp": np.asarray(out["table"], np.float64).tolist(),
            "table_truth": truth["table"].astype(np.float64).tolist(),
            "calib_Mint": np.asarray(calib[0], np.float64).tolist(),
            "calib_Mext": np.asarray(calib[1], np.float64).tolist()})
        if sc["spin"] is not None:
            spin_scores.append(sc["spin"][0])
            spin_labels.append(sc["spin"][1])

        # the physics-fit arm: the same detections and calibrated camera, fitted by
        # differentiable physics in place of the uplifting network
        if not args.skip_physics_fit and len(vi) >= 8:
            Mint_c, Mext_c, n_inl = calib
            if n_inl < 6 or sc["reproj"] > args.physfit_max_calib_reproj_px:
                n_pf_calib_fail += 1
            else:
                k = min(len(vi), 50)  # padded to the 50-token protocol shape
                obs_p = np.zeros((50, 2), np.float32)
                t_p = np.zeros(50, np.float32)
                m_p = np.zeros(50, np.float32)
                obs_p[:k] = out["ball"][:k]
                t_p[:k] = np.asarray(out["times"])[:k]
                m_p[:k] = 1.0
                # the hybrid seed: the uplifting model's prediction on the same detections
                init_state = seed_r0 = None
                if (args.uplifting_checkpoint and out["pos3d"] is not None
                        and len(out["pos3d"]) >= 2 and out["spin"] is not None):
                    init_state = pipe.physics_seed((out["spin"], out["pos3d"]), t_p)
                    seed_r0 = np.asarray(out["pos3d"][0], np.float32)
                fit = FIT.fit_trajectory(
                    obs_p, t_p, m_p, Mint_c, Mext_c, n_frames=500,
                    n_starts=args.physfit_starts, adam_steps=args.physfit_adam_steps,
                    lm_steps=args.physfit_lm_steps, huber_px=20.0,
                    generator=torch.Generator(device=dev).manual_seed(j),
                    init_state=init_state, device=dev)
                d3f = np.linalg.norm(fit.r_world.cpu().numpy()[:k] - truth["r_world"][vi[:k]],
                                     axis=-1)
                pf_pos3d.append(d3f)
                pf_reproj.append(float(fit.reproj_px))
                pf_spread.append(float(fit.basin_spread_m))
                pf_seed_agree.append(
                    float(np.linalg.norm(fit.state0.r.cpu().numpy() - seed_r0))
                    if seed_r0 is not None else float("inf"))
                pf_cls.append(float(FIT.spin_class_from_fit(fit)))
                pf_lbl.append(1.0 if truth["w_local"][1] > 0 else 2.0)

    def stat(fn, errs, scale=1.0):
        return float(scale * fn(np.concatenate(errs))) if errs else None

    finite = [r for r in calib_reprojs if np.isfinite(r)]
    res = {
        "n_rallies": int(n_evaluated),
        "n_rallies_skipped_short": int(len(test_idx) - n_evaluated),
        "n_detected_frames": int(n_valid_frames),
        "ball_detection_px_mean": stat(np.mean, ball_px_errs),
        "ball_detection_px_median": stat(np.median, ball_px_errs),
        "table_detection_px_mean": stat(np.mean, table_px_errs),
        "table_detection_px_median": stat(np.median, table_px_errs),
        "table_px_per_keypoint": [float(np.mean(e)) if e else None for e in table_kp_errs],
        "calib_n_inliers_mean": float(np.mean(calib_inliers)) if calib_inliers else None,
        "calib_reproj_px_mean": float(np.mean(finite)) if finite else None,
        "calib_reproj_px_median": float(np.median(finite)) if finite else None,
        "pos3d_err_cm_mean": stat(np.mean, pos3d_errs, 100),
        "pos3d_err_cm_median": stat(np.median, pos3d_errs, 100),
    }
    # PCK at k px of 1920x1080: point to point for the ball (the synthetic truth has no
    # blur streak, so stricter than the reference's streak PCK); the table as the
    # reference defines it
    for name, errs in (("ball", ball_px_errs), ("table", table_px_errs)):
        if errs:
            e = np.concatenate(errs)
            for k in (2, 5, 10, 20):
                res[f"{name}_pck@{k}"] = float(np.mean(e <= k))
    if spin_scores:
        sm = spin_classification_metrics(np.asarray(spin_scores), np.asarray(spin_labels))
        res["spin_accuracy"] = sm["accuracy"]
        res["spin_macro_f1"] = sm["macro_f1"]
    # the physics-fit arm: counts always; error metrics only from physfit_min_rallies on
    res["physfit_n_rallies"] = int(len(pf_pos3d))
    res["physfit_n_calib_fail"] = int(n_pf_calib_fail)
    if len(pf_pos3d) >= args.physfit_min_rallies:
        res["physfit_pos3d_err_cm_mean"] = stat(np.mean, pf_pos3d, 100)
        res["physfit_pos3d_err_cm_median"] = stat(np.median, pf_pos3d, 100)
        # converged: a small reprojection residual, and the depth identifiable (the
        # near-tied basins agree in 3D, or the winner agrees with the network's seed)
        reproj_ok = np.asarray(pf_reproj) <= args.physfit_gate_px
        spread_ok = np.asarray(pf_spread) <= args.physfit_max_spread_m
        seed_ok = np.asarray(pf_seed_agree) <= args.physfit_seed_agree_m
        conv = reproj_ok & (spread_ok | seed_ok)
        res["physfit_gate_px"] = float(args.physfit_gate_px)
        res["physfit_max_spread_m"] = float(args.physfit_max_spread_m)
        res["physfit_basin_spread_m_median"] = float(np.median(pf_spread))
        res["physfit_n_seed_arbitrated"] = int(np.sum(reproj_ok & ~spread_ok & seed_ok))
        res["physfit_coverage"] = float(np.mean(conv))
        res["physfit_n_converged"] = int(conv.sum())
        e_conv = [d for d, c in zip(pf_pos3d, conv) if c]
        res["physfit_pos3d_err_cm_mean_converged"] = stat(np.mean, e_conv, 100)
        res["physfit_pos3d_err_cm_median_converged"] = stat(np.median, e_conv, 100)
        pred, gt = np.asarray(pf_cls), np.asarray(pf_lbl)
        res["physfit_spin_accuracy"] = float(np.mean(pred == gt))
        f1 = []
        for c in (1.0, 2.0):
            tp = np.sum((pred == c) & (gt == c))
            fp = np.sum((pred == c) & (gt != c))
            fn = np.sum((pred != c) & (gt == c))
            f1.append(2.0 * tp / max(2.0 * tp + fp + fn, 1e-9))
        res["physfit_spin_macro_f1"] = float(np.mean(f1))
    elif pf_pos3d:
        print(f"[closed_loop] physfit ran on only {len(pf_pos3d)} rallies "
              f"(< {args.physfit_min_rallies}): error metrics withheld", flush=True)
        for k in ("physfit_pos3d_err_cm_mean", "physfit_pos3d_err_cm_median",
                  "physfit_spin_accuracy", "physfit_spin_macro_f1"):
            res[k] = None
    if getattr(args, "out", None):
        if ball_frame_diag:
            with open(os.path.join(args.out, "ball_frame_diag.json"), "w") as f:
                json.dump(ball_frame_diag, f)
        if rally_diag:
            with open(os.path.join(args.out, "rally_diag.json"), "w") as f:
                json.dump(rally_diag, f, indent=1)
    return res


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--out", type=str, default="artifacts/closed_loop")
    p.add_argument("--train_steps", type=int, default=3000)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per update (effective batch = "
                        "accum * batch_size)")
    p.add_argument("--eval_every", type=int, default=250,
                   help="probe the val px error every N steps (0 = off); the best snapshot "
                        "is kept and may be saved")
    p.add_argument("--patience", type=int, default=8,
                   help="stop after N val probes without improvement (0 = never)")
    p.add_argument("--coord_weight", type=float, default=5.0,
                   help="weight of the soft-argmax coordinate loss (L1 on frame-normalised "
                        "coordinates) added to the heatmap MSE")
    p.add_argument("--softargmax_beta", type=float, default=20.0,
                   help="spatial-softmax temperature of the coordinate loss")
    p.add_argument("--n_eval", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ball_model", type=str, default="wasb",
                   help="ball detector architecture (models/factory.py)")
    p.add_argument("--table_model", type=str, default="hrnet",
                   help="table detector architecture (segformerpp_b0's global attention "
                        "resolves the corner identities the conv-only HRNet confuses)")
    p.add_argument("--render_res", type=int, nargs=2, default=(960, 544),
                   help="detector input resolution W H (training renders at 1920x1080 and "
                        "resizes to it)")
    p.add_argument("--uplifting_checkpoint", type=str, default=None,
                   help="a port uplifting checkpoint (utils/checkpoint.py)")
    p.add_argument("--skip_train", action="store_true",
                   help="reuse the checkpoints already in --out")
    p.add_argument("--init_from", type=str, default=None,
                   help="warm-start each trained task from <init_from>/<task>_detector "
                        "(a fresh optimizer and schedule)")
    p.add_argument("--tasks", type=str, default="ball,table",
                   help="comma-separated tasks to (re)train; the others reuse the "
                        "checkpoint in --out")
    p.add_argument("--skip_physics_fit", action="store_true",
                   help="skip the training-free physics-fit arm")
    p.add_argument("--physfit_starts", type=int, default=24)
    p.add_argument("--physfit_adam_steps", type=int, default=250)
    p.add_argument("--physfit_lm_steps", type=int, default=10)
    p.add_argument("--physfit_max_calib_reproj_px", type=float, default=10.0,
                   help="skip the physics-fit arm when the calibrated camera's mean "
                        "reprojection error exceeds this")
    p.add_argument("--physfit_min_rallies", type=int, default=8,
                   help="withhold the physfit error metrics below this count")
    p.add_argument("--physfit_gate_px", type=float, default=5.0,
                   help="convergence gate on the fit's reprojection residual")
    p.add_argument("--physfit_max_spread_m", type=float, default=0.3,
                   help="depth-identifiability gate: the largest 3D spread (m) of near-tied "
                        "basins for a fit to count as converged without seed agreement")
    p.add_argument("--physfit_seed_agree_m", type=float, default=0.5,
                   help="a fit whose winning r0 lies within this distance (m) of the "
                        "network's seed counts as converged")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)
    ckpts = {t: os.path.join(args.out, f"{t}_detector") for t in ("ball", "table")}
    args.tasks = ([] if args.skip_train
                  else [t.strip() for t in args.tasks.split(",") if t.strip()])
    # a task that is not retrained needs its checkpoint before any training starts
    missing = [t for t in ("ball", "table")
               if t not in args.tasks and not os.path.isfile(ckpts[t])]
    if missing:
        raise SystemExit(f"[closed_loop] no checkpoint in {args.out} for the task(s) not "
                         f"retrained {missing}; train them (--tasks {','.join(missing)}) or "
                         f"point --out at a directory that has them")
    if args.uplifting_checkpoint and not os.path.exists(args.uplifting_checkpoint):
        raise SystemExit(f"[closed_loop] --uplifting_checkpoint {args.uplifting_checkpoint} "
                         "does not exist")
    store = _load_store(args.data_dir, device=device)
    print(f"[data] {len(store)} trajectories", flush=True)
    if args.tasks:
        ckpts.update(train_detectors(store, args, device))
    res = evaluate_pipeline(store, ckpts, args, device)
    print(json.dumps(res, indent=2))
    with open(os.path.join(args.out, "closed_loop_results.json"), "w") as f:
        json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
