"""Uplifting-model trainer, CLI.

Port of `upliftingtabletennis_tpu/train/run_uplifting.py`:

    python -m upliftingtabletennis_torch.train.run_uplifting \\
        --data_dir <root with <mode>/<direction>.npz or trajectory_* directories> \\
        [--ttst_dir <root>/ttst] [--resume <save_dir>/<run>/latest] [--device cpu]

The same recipe on one card in f32: the corpus split 70/10/20 per (mode, direction)
shard; each step assembles a batch on the device (`data/synthetic.assemble_batch`: random
fps and camera), runs the six noise augmentations (`data/augment.train_augment`), then the
loss, clip, Adam and EMA (`train/uplifting_train.py`); each epoch validates the EMA
weights on the synthetic validation split (`--val_subset`, strided over the shards) and on
TTST's validation split if `--ttst_dir` is given, and keeps the four best-model
checkpoints (`save_decisions`: trajectory, spin, synthetic, and the combined model behind
the 0.007 normalised-reprojection gate). Without `--data_dir` it generates `--generate`
trajectories for each of three modes on the fly.

Differences from the JAX trainer by design: the draws come from a `torch.Generator`
seeded with --seed (the epoch permutation and every batch's fps, cameras and noise), not
from `jax.random`; checkpoints are the port's (`utils/checkpoint.py`: a state dict with a
`.json` beside it), the `model*` ones the EMA weights with the hyperparameters that
`load_model_from_checkpoint` and `hub.uplifting(checkpoint=...)` read, `latest` the full
state (parameters, EMA, both Adam moments, the step) with the epoch and the best metrics;
scalars go to stdout and to `<logdir>/<identifier>/metrics.jsonl` (TensorBoard and the
confusion / ROC figures wait for ROADMAP queue 1, item 7); one process on one card (the
JAX trainer's data parallelism over every device waits for ROADMAP queue 1, item 7; the
detector trainer's is `run_detection --dp`).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from upliftingtabletennis_torch._device import resolve_device

__all__ = ["THRESHOLD_TRAJECTORY", "INITIAL_BEST", "build_store", "save_decisions",
           "state_dict_of", "load_state", "ema_state_dict", "main"]

THRESHOLD_TRAJECTORY = 0.007  # the combined model's gate on the normalised reprojection
INITIAL_BEST = {"trajectory": 1e8, "spin": 0.0, "synthetic": 1e8, "spin_mixed": 0.0,
                "traj_mixed": 1e8}
GEN_MODES = ("intermediate", "first_good", "first_long")
TTST_BATCH = 64


def build_store(args, device, generator=None):
    """(store (numpy), train_idx, val_idx): the shards under args.data_dir (`<mode>/
    <direction>.npz`, or `<mode>/<direction>/trajectory_*`, or trajectory_* directly
    under it), or args.generate trajectories of each of three modes generated on
    `device`. The 70/10/20 split is taken per shard."""
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data import synthetic as SYN

    stores = []
    if args.data_dir and os.path.isdir(args.data_dir):
        for mode in DG.MODES:
            for direction in DG.DIRECTIONS:
                npz = os.path.join(args.data_dir, mode, f"{direction}.npz")
                d = os.path.join(args.data_dir, mode, direction)
                if os.path.isfile(npz):
                    stores.append(SYN.load_store_npz(npz))
                elif os.path.isdir(d):
                    stores.append(SYN.store_from_disk(d, pad_to=500))
        if not stores:  # the flat layout
            stores = [SYN.store_from_disk(args.data_dir, pad_to=500)]
    else:
        print(f"[data] no data_dir; generating {args.generate} trajectories per mode")
        for mode in GEN_MODES:
            res = DG.generate_dataset(args.generate, mode, "left_to_right", generator=generator,
                                      device=device)
            stores.append(SYN.store_from_datagen(res))

    train_idx, val_idx, off = [], [], 0
    for s in stores:
        n = len(s)
        train_idx.append(off + SYN.split_indices(n, "train"))
        val_idx.append(off + SYN.split_indices(n, "val"))
        off += n
    return SYN.concat_stores(stores), np.concatenate(train_idx), np.concatenate(val_idx)


def save_decisions(best: Dict[str, float], metric_traj: float, metric_spin: float,
                   metric_synthetic: float,
                   threshold: float = THRESHOLD_TRAJECTORY) -> Tuple[List[str], Dict[str, float]]:
    """The checkpoints one epoch's metrics call for, and the best metrics after it:
    `model_trajectory` on a strictly lower reprojection, `model_spin` on a macro F1 at least
    the best, `model_synthetic` on a strictly lower synthetic spin error, and `model` when the
    reprojection is within the gate and the F1 beats the combined best, or ties it with a
    strictly lower reprojection."""
    best = dict(best)
    names = []
    if metric_traj < best["trajectory"]:
        best["trajectory"] = metric_traj
        names.append("model_trajectory")
    if metric_spin >= best["spin"]:
        best["spin"] = metric_spin
        names.append("model_spin")
    if metric_synthetic < best["synthetic"]:
        best["synthetic"] = metric_synthetic
        names.append("model_synthetic")
    if metric_traj <= threshold and (
            metric_spin > best["spin_mixed"]
            or (metric_spin == best["spin_mixed"] and metric_traj < best["traj_mixed"])):
        best["spin_mixed"] = metric_spin
        best["traj_mixed"] = metric_traj
        names.append("model")
    return names, best


_GROUPS = ("params", "ema", "mu", "nu")


def state_dict_of(model, state) -> Dict[str, torch.Tensor]:
    """The full training state as one flat state dict: `<group>.<parameter name>` for the
    parameters, the EMA and both moments, and `step`."""
    names = [n for n, _ in model.named_parameters()]
    sd = {f"{g}.{n}": t for g in _GROUPS for n, t in zip(names, getattr(state, g))}
    sd["step"] = torch.tensor(state.step[0], dtype=torch.int64)
    return sd


def load_state(model, sd: Dict[str, torch.Tensor]):
    """A TrainState of `model` from `state_dict_of`'s dict: the parameters copied into the
    model, the other groups on its device."""
    from upliftingtabletennis_torch.train.uplifting_train import TrainState

    named = list(model.named_parameters())
    with torch.no_grad():
        for n, p in named:
            p.copy_(sd[f"params.{n}"])
    dev = named[0][1].device
    groups = {g: [sd[f"{g}.{n}"].to(dev).clone() for n, _ in named] for g in _GROUPS[1:]}
    return TrainState([p for _, p in named], groups["ema"], groups["mu"], groups["nu"],
                      [int(sd["step"])])


def ema_state_dict(model, state) -> Dict[str, torch.Tensor]:
    """The model's state dict with the EMA in place of the parameters."""
    ema = {n: e for (n, _), e in zip(model.named_parameters(), state.ema)}
    return {k: ema.get(k, v) for k, v in model.state_dict().items()}


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_epochs", type=int, default=800)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--model_name", type=str, default="connectstage")
    p.add_argument("--model_size", type=str, default="large")
    p.add_argument("--token_mode", type=str, default="dynamic")
    p.add_argument("--transform_mode", type=str, default="global")
    p.add_argument("--time_rotation", type=str, default="new")
    p.add_argument("--blur_strength", type=float, default=0.4)
    p.add_argument("--stop_prob", type=float, default=0.5)
    p.add_argument("--randdet_prob", type=float, default=0.0)
    p.add_argument("--randmiss_prob", type=float, default=0.05)
    p.add_argument("--tablemiss_prob", type=float, default=0.05)
    p.add_argument("--randomize_std", type=float, default=2.0)
    p.add_argument("--back_view_frac", type=float, default=0.0,
                   help="share of training cameras drawn from behind the table")
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--ttst_dir", type=str, default=None, help="TTST data for the real validation")
    p.add_argument("--generate", type=int, default=256, help="per-mode count when generating data")
    p.add_argument("--logdir", type=str, default="runs")
    p.add_argument("--save_dir", type=str, default="saved_models")
    p.add_argument("--resume", type=str, default=None,
                   help="resume the full training state from <save_dir>/<run>/latest")
    p.add_argument("--save_latest_every", type=int, default=10,
                   help="epochs between resumable 'latest' snapshots")
    p.add_argument("--val_subset", type=int, default=4096,
                   help="cap on synthetic-validation trajectories per epoch (strided over the "
                        "shards; 0 = all)")
    p.add_argument("--max_hours", type=float, default=0.0,
                   help="wall-clock budget; > 0 stops at the first epoch past it, saving "
                        "'latest'")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection (the JAX trainer's jax_debug_nans)")
    p.add_argument("--profile", action="store_true",
                   help="trace epoch 1 with torch.profiler into <logdir>/<identifier>/profile")
    p.add_argument("--exp_id", type=str, default=None,
                   help="experiment tag in the run identifier")
    p.add_argument("--debug", action="store_true",
                   help="logs and checkpoints to <dir>_tmp, and --debug_nans")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    """Train; returns {"identifier", "run_dir", "log_dir", "start_epoch", "history" (per
    epoch: the scalars and the checkpoints saved), "best", "state", "saved" (name -> (epoch,
    the EMA state dict written) of this run's last save of each checkpoint),
    "resume_state" (when resuming, a CPU copy of the state as loaded, else None)}."""
    args = _parser().parse_args(argv)
    if args.debug:
        args.debug_nans = True
        args.logdir = args.logdir.rstrip("/") + "_tmp"
        args.save_dir = args.save_dir.rstrip("/") + "_tmp"
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    device = resolve_device(args.device)

    from upliftingtabletennis_torch.core.geometry import HEIGHT, WIDTH
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.data.augment import AugmentConfig, eval_augment, train_augment
    from upliftingtabletennis_torch.data.ttst import load_ttst
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model, reference_init
    from upliftingtabletennis_torch.train.uplifting_train import (
        batch_from, eval_step, init_train_state, spin_classification_metrics, train_step,
        val2d_step)
    from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from upliftingtabletennis_torch.utils.visualization import count_missortings

    exp = f"_exp:{args.exp_id}" if args.exp_id else ""
    identifier = (
        f"lr:{args.lr:.2e}_bs:{args.batch_size:02d}_name:{args.model_name}"
        f"_mode:{args.token_mode}_size:{args.model_size}_tr:{args.time_rotation}"
        f"_trans:{args.transform_mode}{exp}_{time.strftime('%m%d%Y-%H%M%S')}")
    hparams = {
        "lr": args.lr, "batch_size": args.batch_size, "num_epochs": args.num_epochs,
        "seed": args.seed, "size": args.model_size, "name": args.model_name,
        "ema_decay": args.ema_decay, "tabletoken_mode": args.token_mode,
        "time_rotation": args.time_rotation, "randomize_std": args.randomize_std,
        "stop_prob": args.stop_prob, "blur_strength": args.blur_strength,
        "randdet_prob": args.randdet_prob, "randmiss_prob": args.randmiss_prob,
        "tablemiss_prob": args.tablemiss_prob, "transform_mode": args.transform_mode,
        "exp_id": args.exp_id,
    }

    gen_data = torch.Generator(device=device).manual_seed(args.seed)
    store, train_idx, val_idx = build_store(args, device, gen_data)
    print(f"[data] {len(store)} trajectories ({len(train_idx)} train / {len(val_idx)} val)")
    store_d = SYN.store_to_device(store, device)
    ttst = None
    if args.ttst_dir and os.path.isdir(args.ttst_dir):
        ttst = load_ttst(args.ttst_dir, "val")
        print(f"[data] TTST val: {len(ttst)} trajectories")

    model = get_uplifting_model(args.model_name, args.model_size, args.token_mode,
                                args.time_rotation)
    reference_init(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    eval_model = copy.deepcopy(model).eval()  # holds the EMA weights for validation
    aug_cfg = AugmentConfig(blur_strength=args.blur_strength, randomize_std=args.randomize_std,
                            stop_prob=args.stop_prob, randdet_prob=args.randdet_prob,
                            randmiss_prob=args.randmiss_prob,
                            tablemiss_prob=args.tablemiss_prob)
    state = init_train_state(model)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    tm = args.transform_mode

    def make_batch(idx, train):
        sample = SYN.assemble_batch(store_d, idx, train=train,
                                    back_frac=args.back_view_frac if train else 0.0,
                                    generator=gen)
        sample = train_augment(sample, aug_cfg, generator=gen) if train else eval_augment(sample)
        return batch_from(sample), sample

    best = dict(INITIAL_BEST)
    steps_per_epoch = max(len(train_idx) // args.batch_size, 1)
    val_sel = val_idx
    if args.val_subset and len(val_idx) > args.val_subset:
        val_sel = val_idx[:: max(len(val_idx) // args.val_subset, 1)][: args.val_subset]
    diag = (WIDTH ** 2 + HEIGHT ** 2) ** 0.5
    wh = np.asarray([WIDTH, HEIGHT], np.float32)

    def ema_model():
        with torch.no_grad():
            torch._foreach_copy_(list(eval_model.parameters()), state.ema)
        return eval_model

    def run_val(epoch):
        """Synthetic validation of the EMA weights: one host sync at the end."""
        mdl, tot, count = ema_model(), None, 0
        for s in range(0, len(val_sel), args.batch_size):
            batch, sample = make_batch(val_sel[s:s + args.batch_size], False)
            with torch.no_grad():
                out = mdl(batch.ball_img, batch.table_img, batch.mask, batch.times)
            m = eval_step(mdl, batch, tm, outputs=out)
            m2 = val2d_step(mdl, sample["r_img"], sample["table_img"], sample["mask"],
                            sample["times"], sample["Mint"], sample["Mext"], tm, outputs=out)
            count += m.pop("count")
            m["metric_2d"] = m2["metric_2d"]
            tot = m if tot is None else {k: tot[k] + m[k] for k in tot}
        host = {k: v.cpu().numpy() for k, v in tot.items()}
        metric = float(host["metric"]) / count
        metric_pos = float(host["metric_position"]) / count
        metric_2d = float(host["metric_2d"]) / count
        scalars = {"val/metric": metric, "val/metric position": metric_pos,
                   "val/metric 2D": metric_2d, "val/metric 2D normed": metric_2d / diag}
        if epoch % 10 == 0:  # the per-axis sign counts behind the confusion figures
            for key in ("tp", "tn", "fp", "fn"):
                for ax_i, ax in enumerate("xyz"):
                    scalars[f"val/sign {key} {ax}"] = int(host[key][ax_i])
        return metric, metric_2d / diag, scalars

    def run_val_real(epoch):
        if ttst is None:
            return None, None, {}
        mdl, scores, labels, tot2d, cnt = ema_model(), [], [], [], 0
        for s in range(0, len(ttst), TTST_BATCH):
            sl = slice(s, s + TTST_BATCH)
            tab = ttst.table_img[sl].copy()
            tab[..., :2] /= wh
            args_t = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
                ttst.r_img[sl] / wh, tab, ttst.mask[sl], ttst.times[sl], ttst.Mint[sl],
                ttst.Mext[sl])]
            m2 = val2d_step(mdl, *args_t, tm)
            tot2d.append(m2["metric_2d"])
            cnt += m2["count"]
            scores.append(m2["spin_score"])
            labels.append(ttst.spin_class[sl])
        norm_2d = float(torch.stack(tot2d).sum()) / cnt / diag
        sc, lab = torch.cat(scores).cpu().numpy(), np.concatenate(labels)
        spin = spin_classification_metrics(sc, lab)
        scalars = {"val real/metric 2D normed": norm_2d, "val real/macro f1": spin["macro_f1"],
                   "val real/accuracy": spin["accuracy"], "val real/roc auc": spin["roc_auc"]}
        annotated = (lab == 1) | (lab == 2)
        if epoch % 10 == 0 and annotated.sum() >= 2 and len(np.unique(lab[annotated])) > 1:
            n_miss, thr = count_missortings((lab[annotated] == 1).astype(int), sc[annotated])
            scalars["val real/missortings"] = n_miss
            scalars["val real/optimal threshold"] = thr
        return norm_2d, spin["macro_f1"], scalars

    start_epoch, resume_state = 0, None
    if args.resume:
        sd, identifier, info = load_checkpoint(args.resume)
        state = load_state(model, sd)
        resume_state = {k: v.detach().cpu().clone() for k, v in state_dict_of(model, state).items()}
        start_epoch = int(info.get("epoch", -1)) + 1
        best.update(info.get("best", {}))
        print(f"[resume] {args.resume} -> epoch {start_epoch}")

    run_dir = os.path.join(args.save_dir, identifier)
    log_dir = os.path.join(args.logdir, identifier)
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "hparams.json"), "w") as f:
        json.dump(hparams, f, indent=2)

    def log(record):
        with open(os.path.join(log_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")

    saved = {}

    def save(name, epoch):
        sd = {k: v.detach().cpu() for k, v in ema_state_dict(model, state).items()}
        save_checkpoint(os.path.join(run_dir, name), sd, identifier, {"epoch": epoch, **hparams})
        saved[name] = (epoch, sd)

    def save_latest(epoch):
        save_checkpoint(os.path.join(run_dir, "latest"), state_dict_of(model, state), identifier,
                        {"epoch": epoch, "best": best, **hparams})

    print(f"[train] {steps_per_epoch} steps/epoch on {device}")
    history = []
    it = start_epoch * steps_per_epoch
    train_idx_d = torch.as_tensor(train_idx, device=device)
    t_budget0 = time.perf_counter()
    for epoch in range(start_epoch, args.num_epochs):
        if args.max_hours and (time.perf_counter() - t_budget0) > args.max_hours * 3600:
            print(f"[train] wall-clock budget {args.max_hours}h reached at epoch {epoch}")
            save_latest(epoch - 1)
            break
        prof = None
        if args.profile and epoch == 1:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if device.type == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            t_prof = time.perf_counter()
        perm = torch.randperm(len(train_idx), generator=gen, device=device)
        t0 = time.perf_counter()
        metrics = None
        for s in range(steps_per_epoch):
            idx = train_idx_d[perm[s * args.batch_size:(s + 1) * args.batch_size]]
            if len(idx) < args.batch_size:
                continue
            batch, _ = make_batch(idx, True)
            metrics = train_step(model, state, batch, args.lr, args.ema_decay, tm)
            if it % 10 == 0:
                log({"step": it, "train/loss": float(metrics["loss"]),
                     "train/loss rotation": float(metrics["loss_rot"]),
                     "train/loss position": float(metrics["loss_pos"])})
            it += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0

        metric, norm2d_syn, scalars = run_val(epoch)
        norm2d_real, f1, real_scalars = run_val_real(epoch)
        scalars.update(real_scalars)
        metric_traj = norm2d_real if norm2d_real is not None else norm2d_syn
        metric_spin = f1 if f1 is not None else 0.0
        loss = float(metrics["loss"]) if metrics is not None else float("nan")
        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall_ms = 1e3 * (time.perf_counter() - t_prof)
            prof.__exit__(None, None, None)
            prof_dir = os.path.join(log_dir, "profile")
            os.makedirs(prof_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
            busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            scalars.update({"profile/wall ms": wall_ms, "profile/device busy ms": busy_ms,
                            "profile/idle share": 1 - busy_ms / wall_ms})
        print(f"epoch {epoch}: loss {loss:.3f} val_metric {metric:.3f} reproj {metric_traj:.5f} "
              f"f1 {metric_spin:.3f} ({dt:.1f}s) {json.dumps(scalars)}", flush=True)

        names, best = save_decisions(best, metric_traj, metric_spin, metric)
        for name in names:
            save(name, epoch)
        if (epoch + 1) % args.save_latest_every == 0 or epoch == args.num_epochs - 1:
            save_latest(epoch)
        record = {"epoch": epoch, "train/loss": loss, "train/seconds": dt, **scalars,
                  "metric_traj": metric_traj, "metric_spin": metric_spin, "saved": names}
        log(record)
        history.append(record)

    return {"identifier": identifier, "run_dir": run_dir, "log_dir": log_dir,
            "start_epoch": start_epoch, "history": history, "best": best, "state": state,
            "saved": saved, "resume_state": resume_state}


if __name__ == "__main__":
    main()
