"""Evaluate differentiable-physics trajectory fitting on held-out synthetic trajectories
(3D and spin truth known), or on the TT3D protocol.

Port of `upliftingtabletennis_tpu/eval/run_physics_fit_eval.py`. The store protocol takes
the test split of the datagen corpus, resamples each trajectory to 50 fps and projects
it through its stored camera (`data/synthetic.py:assemble_batch(train=False)`, the
uplifting evaluation's conditions), optionally adds Gaussian detection noise and drops
detections, recovers (r0, v0, w0) with `core/fitting.py` from the 2D track alone and
scores the fit against the simulation:

* the 3D position error (cm) over the visible frames;
* the spin class (sign of the flight-frame w_y): accuracy and macro-F1;
* the error of the observable transverse spin (rad/s);
* the 2D reprojection error (px) against the clean track, and the fit's own residual
  against the track it saw, which gates convergence (`--gate_px`).

`--tt3d_dir` runs the TT3D view x noise protocol instead (`eval_tt3d_fit`), optionally
seeded by an uplifting checkpoint (`--init_checkpoint`, the hybrid mode).

The draws are explicit. Per batch of the store protocol: the detection noise (B, 50, 2)
standard normals, the drop uniforms (B, 50) and each track's starts (`draw_inits`); per
batch of TT3D, the starts. By default they come from a `torch.Generator` seeded with
`--seed` on the device; `draws=` (a list with one dict per batch, see `draw_batch`)
replaces them, so that a test can feed the JAX package's.

    python -m upliftingtabletennis_torch.eval.run_physics_fit_eval \\
        --data_dir <syntheticdata root> --n_traj 64 --noise_px 1.0 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["spin_metrics", "draw_batch", "eval_tt3d_fit", "eval_indices", "evaluate_store",
           "main"]

SEQUENCE_LEN = 50  # the protocol's track length (data/synthetic.py)


def spin_metrics(pred_cls, gt_cls):
    """(accuracy, macro-F1) over the two spin labels (1.0 top, 2.0 back)."""
    pred = np.asarray(pred_cls)
    gt = np.asarray(gt_cls)
    acc = float(np.mean(pred == gt))
    f1 = []
    for c in (1.0, 2.0):
        tp = np.sum((pred == c) & (gt == c))
        fp = np.sum((pred == c) & (gt != c))
        fn = np.sum((pred != c) & (gt == c))
        f1.append(2.0 * tp / max(2.0 * tp + fp + fn, 1e-9))
    return acc, float(np.mean(f1))


def draw_batch(B: int, n_starts: int, generator: torch.Generator, device,
               track: bool = True) -> dict:
    """One batch's draws from `generator` on `device`: "starts", B dicts of `draw_inits`;
    with `track`, also "noise" (B, 50, 2) standard normals and "drop_u" (B, 50) uniforms
    in [0, 1)."""
    from upliftingtabletennis_torch.core.fitting import draw_inits

    out = {}
    if track:
        out["noise"] = torch.randn((B, SEQUENCE_LEN, 2), generator=generator, device=device)
        out["drop_u"] = torch.rand((B, SEQUENCE_LEN), generator=generator, device=device)
    out["starts"] = [draw_inits(n_starts, generator, device) for _ in range(B)]
    return out


def _batches(draws: Optional[Sequence[dict]], B, n_starts, seed, dev, track) -> Iterator[dict]:
    """The given draws in order, or fresh ones from a generator seeded with `seed`."""
    if draws is not None:
        yield from draws
        return
    gen = torch.Generator(device=dev).manual_seed(seed)
    while True:
        yield draw_batch(B, n_starts, gen, dev, track)


def _summary(e, r, s, gate_px, max_spread, seeded):
    """The TT3D view's metrics from the per-track errors (m), residuals and spreads."""
    conv = (r <= gate_px) & ((s <= max_spread) | seeded)
    return {
        "err3d_cm_mean": float(100 * np.mean(e)),
        "err3d_cm_std": float(100 * np.std(e)),
        "err3d_cm_median": float(100 * np.median(e)),
        "n_traj": len(e),
        "gate_px": gate_px,
        "max_spread_m": max_spread,
        "reproj_px_median": float(np.median(r)),
        "basin_spread_m_median": float(np.median(s)),
        "coverage": float(np.mean(conv)),
        "n_converged": int(conv.sum()),
        "err3d_cm_mean_converged": float(100 * np.mean(e[conv])) if conv.any() else None,
        "err3d_cm_median_converged": float(100 * np.median(e[conv])) if conv.any() else None,
    }


def eval_tt3d_fit(args, device="cuda", draws: Optional[Sequence[dict]] = None):
    """The TT3D protocol (3D error cm per view x noise) with the physics fit in place of
    the uplifting network: the loader, cameras and per-rally masked mean of
    `eval/run_uplifting_eval.eval_tt3d`. `args` needs tt3d_dir, n_starts, adam_steps,
    lm_steps, batch, huber_px, seed and out; gate_px, max_spread_m, seed_select_rel and
    init_checkpoint are optional."""
    from upliftingtabletennis_torch.core import fitting as F
    from upliftingtabletennis_torch.core import geometry as G
    from upliftingtabletennis_torch.data.tt3d import load_tt3d

    dev = resolve_device(device)
    gate_px = float(getattr(args, "gate_px", 3.0))
    max_spread = float(getattr(args, "max_spread_m", 0.3))
    # one horizon for every view
    n_frames = 0
    loaded = {}
    for noise in (True, False):
        for view in ("back", "side", "oblique"):
            try:
                d = load_tt3d(args.tt3d_dir, view, noise)
            except FileNotFoundError:
                continue
            loaded[(view, noise)] = d
            n_frames = max(n_frames, int(np.ceil(float((d.times * d.mask).max()) * 500.0)) + 4)

    predict = None
    if getattr(args, "init_checkpoint", None):
        # the hybrid mode: the uplifting network's 3D track and spin seed every fit
        from upliftingtabletennis_torch.eval.run_uplifting_eval import load_uplifting

        model, transform_mode = load_uplifting(args.init_checkpoint, dev)

        @torch.no_grad()
        def predict(d, bidx):
            spin, pos = model(*(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                                for a in (d.r_img[bidx], d.table_img[bidx], d.mask[bidx],
                                          d.times[bidx])))
            if transform_mode == "local":
                spin = G.inverse_transform_rotation_axes(spin, pos)
            dt01 = torch.clamp_min(torch.from_numpy(
                np.asarray(d.times[bidx, 1] - d.times[bidx, 0], np.float32)).to(dev), 1e-3)
            v0 = (pos[:, 1] - pos[:, 0]) / dt01[:, None]
            return F.BallState(r=pos[:, 0], v=v0, w=spin)

    stream = _batches(draws, args.batch, args.n_starts, args.seed, dev, track=False)
    results = {}
    for (view, noise), d in loaded.items():
        w = 2.0 * float(d.Mint[0, 0, 2])
        h = 2.0 * float(d.Mint[0, 1, 2])
        obs = d.r_img * np.array([w, h], np.float32)  # back to pixels
        errs, reprojs, spreads = [], [], []
        N = len(d)
        for b0 in range(0, N, args.batch):
            bidx = np.arange(b0, min(b0 + args.batch, N))
            n_real = len(bidx)
            if n_real < args.batch:  # fixed shapes: pad by repeating
                bidx = np.concatenate([bidx, bidx[:args.batch - n_real]])[:args.batch]
            res = F.fit_trajectory_batch(
                obs[bidx], d.times[bidx], d.mask[bidx], d.Mint[bidx], d.Mext[bidx],
                n_frames=n_frames, n_starts=args.n_starts, adam_steps=args.adam_steps,
                lm_steps=args.lm_steps, huber_px=args.huber_px,
                init_state=predict(d, bidx) if predict else None,
                seed_select_rel=getattr(args, "seed_select_rel", 1.3),
                draws=next(stream)["starts"], device=dev)
            m = d.mask[bidx][:n_real]
            err = np.linalg.norm(res.r_world.cpu().numpy()[:n_real] - d.r_world[bidx][:n_real],
                                 axis=-1) * m
            errs.extend((err.sum(1) / np.maximum(m.sum(1), 1)).tolist())
            reprojs.extend(res.reproj_px.cpu().numpy()[:n_real].tolist())
            spreads.extend(res.basin_spread_m.cpu().numpy()[:n_real].tolist())
        name = view if noise else f"{view}_no_noise"
        # convergence, free of ground truth: the residual at the detection-noise floor,
        # and the near-tied basins agreeing in 3D (or, in the hybrid mode, the seed
        # having arbitrated)
        results[name] = _summary(np.asarray(errs), np.asarray(reprojs), np.asarray(spreads),
                                 gate_px, max_spread, predict is not None)
        r = results[name]
        print(f"[tt3d-fit] {name}: {r['err3d_cm_mean']:.1f} cm (median "
              f"{r['err3d_cm_median']:.1f}); converged@{gate_px:g}px {r['n_converged']}/"
              f"{r['n_traj']}: mean {r['err3d_cm_mean_converged'] or float('nan'):.1f} "
              f"median {r['err3d_cm_median_converged'] or float('nan'):.1f}", flush=True)

    print(json.dumps(results))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


def eval_indices(n_store: int, train_idx, val_idx, split: str, n_traj: int, seed: int):
    """The evaluated trajectories, sorted: the test split (everything outside the
    per-shard train and val splits) or val, n_traj of them drawn by numpy's generator
    seeded with `seed` when there are more."""
    if split == "test":
        used = np.zeros(n_store, bool)
        used[np.asarray(train_idx)] = True
        used[np.asarray(val_idx)] = True
        idx = np.nonzero(~used)[0]
    else:
        idx = np.asarray(val_idx)
    rng = np.random.default_rng(seed)
    if len(idx) > n_traj:
        idx = rng.choice(idx, size=n_traj, replace=False)
    return np.sort(idx)


def evaluate_store(store, idx, args, device="cuda", draws: Optional[Sequence[dict]] = None):
    """The store protocol on the trajectories idx of `store` (numpy or on the device), in
    batches of args.batch (the last padded by repeating). Returns the summary dict."""
    from upliftingtabletennis_torch.core import fitting as F
    from upliftingtabletennis_torch.core import geometry as G
    from upliftingtabletennis_torch.data import synthetic as SYN

    dev = resolve_device(device)
    store_d = SYN.store_to_device(store, dev)
    agg = {"err3d_cm": [], "reproj_px": [], "fit_reproj_px": [], "w_err": [],
           "pred_cls": [], "gt_cls": [], "loss": []}
    stream = _batches(draws, args.batch, args.n_starts, args.seed, dev, track=True)
    for b0 in range(0, len(idx), args.batch):
        bidx = idx[b0:b0 + args.batch]
        if len(bidx) < args.batch:  # fixed shapes: pad by repeating
            bidx = np.concatenate([bidx, bidx[:args.batch - len(bidx)]])[:args.batch]
        n_real = min(args.batch, len(idx) - b0)
        dr = next(stream)
        batch = SYN.assemble_batch(store_d, torch.as_tensor(bidx, device=dev), train=False)
        obs, mask = batch["r_img"], batch["mask"]
        if args.noise_px > 0:
            obs = obs + args.noise_px * torch.as_tensor(dr["noise"], device=dev)
        if args.drop > 0:
            keep = torch.as_tensor(dr["drop_u"], device=dev) >= args.drop
            mask = mask * keep.to(mask.dtype)
        res = F.fit_trajectory_batch(obs, batch["times"], mask, batch["Mint"], batch["Mext"],
                                     n_frames=500, n_starts=args.n_starts,
                                     adam_steps=args.adam_steps, lm_steps=args.lm_steps,
                                     huber_px=args.huber_px, draws=dr["starts"], device=dev)
        m = batch["mask"].cpu().numpy()[:n_real]  # scored on the clean mask
        gt3 = batch["r_world"][:n_real]
        err = np.linalg.norm(res.r_world.cpu().numpy()[:n_real] - gt3.cpu().numpy(),
                             axis=-1) * m
        agg["err3d_cm"].extend((100.0 * err.sum(1) / np.maximum(m.sum(1), 1)).tolist())
        proj = G.world2img(res.r_world, batch["Mext"][:, None],
                           batch["Mint"][:, None]).cpu().numpy()[:n_real]
        d2 = np.linalg.norm(proj - batch["r_img"].cpu().numpy()[:n_real], axis=-1) * m
        agg["reproj_px"].extend((d2.sum(1) / np.maximum(m.sum(1), 1)).tolist())
        # the residual against the (noisy, dropped) track the fit saw: no ground truth
        agg["fit_reproj_px"].extend(res.reproj_px.cpu().numpy()[:n_real].tolist())
        gt_local = G.transform_rotation_axes(batch["rotation"][:n_real], gt3).cpu().numpy()
        agg["pred_cls"].extend(F.spin_class_from_fit(res).cpu().numpy()[:n_real].tolist())
        agg["gt_cls"].extend(np.where(gt_local[:, 1] > 0, 1.0, 2.0).tolist())
        # the observable transverse spin: the flight-frame (y, z) components
        fit_local = G.transform_rotation_axes(res.state0.w, res.r_world).cpu().numpy()[:n_real]
        agg["w_err"].extend(np.linalg.norm(fit_local[:, 1:] - gt_local[:, 1:], axis=-1).tolist())
        agg["loss"].extend(res.loss.cpu().numpy()[:n_real].tolist())
        print(f"[fit] {min(b0 + args.batch, len(idx))}/{len(idx)}  err3d "
              f"{np.mean(agg['err3d_cm']):.1f} cm  reproj {np.mean(agg['reproj_px']):.2f} px",
              flush=True)

    acc, f1 = spin_metrics(agg["pred_cls"], agg["gt_cls"])
    e = np.asarray(agg["err3d_cm"])
    conv = np.asarray(agg["fit_reproj_px"]) <= args.gate_px
    acc_c, f1_c = (spin_metrics(np.asarray(agg["pred_cls"])[conv], np.asarray(agg["gt_cls"])[conv])
                   if conv.any() else (None, None))
    return {
        "n_traj": len(agg["err3d_cm"]),
        "noise_px": args.noise_px,
        "drop": args.drop,
        "err3d_cm_mean": float(np.mean(e)),
        "err3d_cm_median": float(np.median(e)),
        "reproj_px_mean": float(np.mean(agg["reproj_px"])),
        "spin_acc": acc,
        "spin_macro_f1": f1,
        "w_transverse_err_mean": float(np.mean(agg["w_err"])),
        "fit_loss_median": float(np.median(agg["loss"])),
        "gate_px": float(args.gate_px),
        "coverage": float(np.mean(conv)),
        "n_converged": int(conv.sum()),
        "err3d_cm_mean_converged": float(np.mean(e[conv])) if conv.any() else None,
        "err3d_cm_median_converged": float(np.median(e[conv])) if conv.any() else None,
        "spin_acc_converged": acc_c,
        "spin_macro_f1_converged": f1_c,
    }


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", type=str, default=None,
                   help="datagen corpus root (mode/direction npz shards); generated on the "
                        "device when omitted")
    p.add_argument("--tt3d_dir", type=str, default=None,
                   help="run the TT3D view x noise protocol instead of the datagen corpus")
    p.add_argument("--init_checkpoint", type=str, default=None,
                   help="a port uplifting checkpoint whose (spin, pos3d) prediction seeds "
                        "every fit (the hybrid mode; TT3D protocol only)")
    p.add_argument("--generate", type=int, default=128,
                   help="per-mode count when generating data")
    p.add_argument("--n_traj", type=int, default=64)
    p.add_argument("--split", choices=["val", "test"], default="test")
    p.add_argument("--noise_px", type=float, default=0.0,
                   help="Gaussian detection noise added to the 2D track")
    p.add_argument("--drop", type=float, default=0.0,
                   help="probability of dropping each detection")
    p.add_argument("--n_starts", type=int, default=32)
    p.add_argument("--adam_steps", type=int, default=250)
    p.add_argument("--lm_steps", type=int, default=12)
    p.add_argument("--batch", type=int, default=16,
                   help="tracks fitted together (batch * n_starts starts)")
    p.add_argument("--huber_px", type=float, default=None)
    p.add_argument("--seed_select_rel", type=float, default=1.3,
                   help="hybrid mode: loss tolerance of the seed-aware start selection")
    p.add_argument("--gate_px", type=float, default=3.0,
                   help="convergence gate on the fit's own reprojection residual")
    p.add_argument("--max_spread_m", type=float, default=0.3,
                   help="TT3D: unseeded fits whose near-tied basins spread more than this in "
                        "3D are not converged")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None, help="JSON output path")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.tt3d_dir:
        return eval_tt3d_fit(args, device)

    from upliftingtabletennis_torch.train.run_uplifting import build_store

    store, train_idx, val_idx = build_store(
        args, device, torch.Generator(device=device).manual_seed(args.seed))
    idx = eval_indices(len(store), train_idx, val_idx, args.split, args.n_traj, args.seed)
    summary = evaluate_store(store, idx, args, device)
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
