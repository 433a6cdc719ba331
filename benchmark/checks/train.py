"""`correct` of a training cell: the checked steps the training object ran before its
window, replayed by the plain float32 reference (`reference/train.py`,
`reference/segformer.py`) from the same weights, batches and augmentation draws.

Numbers compared, each against the limit of the cell's `check` section:

* `loss_rel`: the relative gap between the program's first loss and the reference's (the
  later steps' gaps are reported, not compared: Adam's first update moves every weight by
  about the learning rate, with the sign of its gradient, so weights whose gradients lie
  within rounding of zero move either way and the later losses of two sound precisions
  part by up to their own size);
* `bn_gap`: the BatchNorms' running statistics after the first step, which the forward
  moves by the batch's mean and variance: by buffer, the root mean square over the
  channels of the gap to the reference's, in units of the first batch's share of its
  standard deviation (means) or of its variance (variances); the worst buffer;
* `half_batch`: whether those statistics are the whole batch's or those of half of it. The
  reference also takes each image's mean and mean square of every channel (each channel
  over the batch's standard deviation, or its variance); the program's batch statistics
  are read back from its running statistics by the flax rule. The number is the root mean
  square gap of the program's to the whole batch's mix of the images, over the least such
  gap to a mix of any half of the images: a sound step reads well under 1, a step that
  takes its mean over half of the batch well over 1, whichever half it keeps;
* `delta_gap`: the gap between the norms of the program's and the reference's change of a
  leaf over the checked steps, over the larger of the reference's norm of that leaf and of
  the median leaf, by the worst leaf;
* `ema_gap`: the same for the change of each parameter's EMA.

Reported beside them, not compared (`reported`; PERF.md gives the readings): the first
gradient as Adam holds it after one step (its first moment), by leaf, the norm of the
difference between the program's leaf and the reference's over the larger of the
reference's norm of that leaf and of the median leaf (`grad_gap`, its `grad_quantile`
quantile over the leaves, with other quantiles and the gap of the norms beside it): on
some seeds sound runs read half of what the fp8 control does, so no limit lies three times
apart from both; the least-squares weights of the images in the program's batch statistics
(all 1 in a sound step, 2 and 0 where half of the batch is left out); the later losses.

Leaves whose reference gradient is below `zero_grad_share` of the median leaf's are left
out of every gap, by that rule; and, within the others, the elements whose reference
gradient is below `zero_grad_share` of the median leaf's root mean square are left out of
the changes (the key half of an attention's `kv.bias`: softmax ignores a key's bias, so its
gradient is round-off, and Adam moves it by about the learning rate, with round-off's sign).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.reference import ingest
from benchmark.reference import train as ref_train
from benchmark.reference.numerics import Products
from benchmark.reference.segformer import SegFormer


COMPARED = ("loss_rel", "bn_gap", "half_batch", "delta_gap", "ema_gap")


def builder(config):
    m = config["model"]
    cfg = config["segformer"][m["size"]]
    return lambda: SegFormer(cfg, m["in_frames"], m["out_channels"])


def replay(cell, state, feed, gen_states, device, precision="f32"):
    """The reference's checked steps, under the keys the program's record has: `losses`;
    by leaf name Adam's first moment after one step (`first_mu`), the parameters' change
    (`change`) and the EMA's change (`ema_change`); by buffer name the BatchNorms' running
    statistics after one step (`first_bn`). Beside them, what the check measures those
    statistics by: `bn_scale`, by buffer the first batch's share of its standard deviation
    (means) or of its variance (variances); `bn_images`, by BatchNorm its running mean and
    variance before the step, each image's mean and mean square (B, C), the batch's
    variance."""
    config = cell.config
    model = weights.materialise(builder(config), state, device).train()
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    p0 = [p.detach().clone() for p in params]
    ema = [p.detach().clone() for p in params]
    opt_state = {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
    P = Products(precision)
    MW, MH = config["model"]["input_wh"]
    EW, EH = config["eval_wh"]
    losses, first, first_bn, bn_scale, bn_images = [], {}, {}, {}, {}
    for k, gs in enumerate(gen_states):
        images, coords, vis = feed(k)
        g = torch.Generator()
        g.set_state(gs)
        B = images.shape[0]
        u_aff = torch.rand(8, B, generator=g).to(device)
        u_jit = torch.rand(5, B, generator=g).to(device)
        H, W = images.shape[1:3]
        A, stages = ref_train.affines(u_aff, (H, W), (MW, MH), config["augment"])
        x = ref_train.jitter(u_jit, ref_train.warp(images.float(), A, (MW, MH)),
                             config["augment"])
        xy = ref_train.apply(A, coords.float())
        v = ref_train.visibility(stages, coords.float(), vis.float())
        xy_eval = torch.stack([(xy[..., 0] + 0.5) * EW / MW - 0.5,
                               (xy[..., 1] + 0.5) * EH / MH - 0.5], -1)
        n_out = config["model"]["out_channels"]
        target = ref_train.targets(xy_eval[:, :n_out], v[:, :n_out], EH, EW, config["sigma"])
        logits = model(ingest.normalize(x), P)
        if k == 0:
            m = ref_train.BN_MOMENTUM
            for name, mod in model.named_modules():
                if isinstance(mod, torch.nn.BatchNorm2d) and hasattr(mod, "batch_stats"):
                    mean, var = mod.batch_stats
                    first_bn[f"{name}.running_mean"] = m * mod.running_mean + (1 - m) * mean
                    first_bn[f"{name}.running_var"] = m * mod.running_var + (1 - m) * var
                    bn_scale[f"{name}.running_mean"] = (1 - m) * var.sqrt()
                    bn_scale[f"{name}.running_var"] = (1 - m) * var
                    bn_images[name] = (mod.running_mean.clone(), mod.running_var.clone(),
                                       *mod.image_stats, var)
        logits = F.interpolate(logits, size=(EH, EW), mode="bilinear", align_corners=False)
        loss = ref_train.weighted_mse(logits, target)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        ref_train.update(params, [gr.detach() for gr in grads], opt_state, ema,
                         config["optimizer"])
        losses.append(float(loss.detach()))
        if k == 0:
            first = {n: mu.clone() for n, mu in zip(names, opt_state["mu"])}
    change = {n: p.detach() - q for n, p, q in zip(names, params, p0)}
    ema_change = {n: e - q for n, e, q in zip(names, ema, p0)}
    del model, params, p0, ema, opt_state
    return {"losses": losses, "first_mu": first, "change": change, "ema_change": ema_change,
            "first_bn": first_bn, "bn_scale": bn_scale, "bn_images": bn_images}


def half_batch(first_bn, bn_images) -> Tuple[float, List[float]]:
    """Whether the batch statistics a step's forward took (read back from the running
    statistics it left, by the flax rule) are the whole batch's or those of a half of it:
    per BatchNorm, the root mean square gap of the program's means and mean squares (each
    channel over the batch's standard deviation, or its variance) to the mean of all the
    images', over the least such gap to the mean of any half of the images'; the largest
    over the BatchNorms, and the least-squares weights of the images (over their mean) in
    that BatchNorm's statistics."""
    m = ref_train.BN_MOMENTUM
    worst_ratio, worst_w = 0.0, []
    for name, (rm0, rv0, means, squares, var) in bn_images.items():
        rm, rv = first_bn.get(f"{name}.running_mean"), first_bn.get(f"{name}.running_var")
        if rm is None or rv is None:
            return float("inf"), []
        mu = (rm.double() - m * rm0.double()) / (1 - m)
        sq = (rv.double() - m * rv0.double()) / (1 - m) + mu * mu
        sd = var.double().sqrt().clamp_min(1e-12)
        a = torch.cat([means.double() / sd, squares.double() / sd ** 2], 1)  # (B, 2C)
        y = torch.cat([mu / sd, sq / sd ** 2])
        B = a.shape[0]

        def gap(rows):
            return float((y - a[list(rows)].mean(0)).pow(2).mean().sqrt())
        halves = min(gap(h) for h in itertools.combinations(range(B), B // 2))
        ratio = gap(range(B)) / halves if halves > 0 else float("inf")
        if not np.isfinite(ratio):
            return float("inf"), []
        if ratio >= worst_ratio:
            w = torch.linalg.lstsq(a @ a.T, a @ y).solution
            worst_ratio, worst_w = ratio, (w / w.mean()).tolist()
    return worst_ratio, worst_w


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep) -> Dict[str, float]:
    med = float(np.median([want[n] for n in keep]))
    return {n: abs(got.get(n, float("nan")) - want[n]) / max(want[n], med) for n in keep}


def worst(gaps: Dict[str, float]):
    if not gaps:
        return float("inf"), ""
    name = max(gaps, key=lambda n: gaps[n] if np.isfinite(gaps[n]) else float("inf"))
    return gaps[name], name


def norms(tensors: Dict[str, torch.Tensor], masks=None) -> Dict[str, float]:
    if masks is None:
        return {n: float(t.float().norm()) for n, t in tensors.items()}
    return {n: float(t.float()[masks[n]].norm()) for n, t in tensors.items() if n in masks}


def readings(cell, recorded, ref) -> Dict[str, Any]:
    """The numbers compared (`COMPARED`) and those reported beside them, from the program's
    record and the reference's replay (each under the keys `replay` returns)."""
    losses, first_mu, change, ema_change = (
        ref[k] for k in ("losses", "first_mu", "change", "ema_change"))
    share = cell.check["zero_grad_share"]
    first = norms(first_mu)
    grad_med = float(np.median(list(first.values())))
    keep = [n for n, v in first.items() if v >= share * grad_med]
    rms_med = float(np.median([first[n] / first_mu[n].numel() ** 0.5 for n in first]))
    masks = {n: first_mu[n].abs() >= share * rms_med for n in keep}
    masks = {n: m for n, m in masks.items() if bool(m.any())}
    rel = [abs(a - b) / abs(b) for a, b in zip(recorded["losses"], losses)]
    first_med = float(np.median([first[n] for n in keep]))
    diff = [float((recorded["first_mu"][n].float() - first_mu[n].float()).norm())
            / max(first[n], first_med) for n in keep]
    g = leaf_gaps(norms(recorded["first_mu"]), first, keep)
    d = leaf_gaps(norms(recorded["change"], masks), norms(change, masks), list(masks))
    (gap_d, at_d) = worst(d)
    gap_e, _ = worst(leaf_gaps(norms(recorded["ema_change"], masks), norms(ema_change, masks),
                               list(masks)))
    bn = {n: float(((recorded["first_bn"][n].float() - ref["first_bn"][n]) / ref["bn_scale"][n])
                   .pow(2).mean().sqrt()) if n in recorded["first_bn"] else float("inf")
          for n in ref["first_bn"]}
    gap_bn, at_bn = worst(bn) if bn else (float("inf"), "")
    half, w = half_batch(recorded["first_bn"], ref["bn_images"])

    def q(values, at):
        return float(np.quantile(values, at)) if len(values) else float("inf")
    out = {"loss_rel": rel[0], "bn_gap": gap_bn, "half_batch": half, "delta_gap": gap_d,
           "ema_gap": gap_e, "bn_buffer": at_bn, "image_weights": w, "delta_leaf": at_d,
           "later_loss_rel": max(rel[1:], default=0.0),
           "grad_gap": q(diff, cell.check["grad_quantile"]),
           "grad_quantiles": [q(diff, at) for at in (0.5, 0.75, 0.99)],
           "norm_gap": q(list(g.values()), cell.check["grad_quantile"]),
           "leaves": len(keep), "left_out": len(first) - len(keep),
           "elements_left_out": int(sum(int((~m).sum()) for m in masks.values()))}
    if not all(np.isfinite(out[k]) for k in COMPARED):
        for k in COMPARED:
            out[k] = float("inf")
    return out


def checks_of(cell, r) -> Tuple[List[Dict[str, Any]], bool, Dict[str, Any]]:
    """The checks (name, value, limit, and what is read beside each) of one set of
    readings, whether all hold, and the numbers reported, not compared."""
    lim = cell.check["limits"]
    beside = {"bn_gap": {"buffer": r["bn_buffer"]},
              "half_batch": {"image_weights": r["image_weights"]},
              "delta_gap": {"leaf": r["delta_leaf"]}}
    checks = [{"name": k, "value": r[k], "limit": lim[k], **beside.get(k, {})}
              for k in COMPARED]
    reported = {k: r[k] for k in ("later_loss_rel", "grad_gap", "grad_quantiles", "norm_gap",
                                  "leaves", "left_out", "elements_left_out")}
    return checks, all(c["value"] <= c["limit"] for c in checks), reported


def judge(cell, seed, state, feed, recorded, device):
    """(checks, correct, reported) of one run."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = replay(cell, state, feed, recorded["gen_states"], device)
    return checks_of(cell, readings(cell, recorded, ref))
