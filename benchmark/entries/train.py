"""The training cells: `train/run_detection.py` `train_step` driven back to back on batches
fed from a frame pool on the device.

Set-up builds one training object (the model with the benchmark's weights, its parameter
list, Adam's state, the EMA and the augmentation's generator), drives it through its first
`checked_steps` steps by the window's own feed and call, on rows that all differ, and
records what the check compares (each step's loss, Adam's first moment and the
BatchNorms' running statistics after one step, each parameter's and its EMA's change after
the last checked step). The window then runs the same object on. images/s is all images of
all steps in the window over its time, which ends in a synchronise. After the window the peak memory is read, the object is
freed, and `checks/train.py` replays the checked steps with the plain reference.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import trace as tracing
from benchmark import weights
from benchmark.checks import train as train_check
from benchmark.entries.rally import device_info
from benchmark.harness import Outcome
from benchmark.traffic import frames


class Feed:
    """Batches of triplets (prev, cur, next) from the device pool, the blob's centre as the
    label of every row: step k's rows are `rows[k]`."""

    def __init__(self, seed, pool, track, batch, n_steps, distinct, device):
        n = len(pool)
        rng = np.random.default_rng([seed, 4])
        first = rng.choice(np.arange(1, n - 1), size=distinct * batch, replace=False)
        rest = rng.integers(1, n - 1, size=(n_steps - distinct) * batch)
        self.rows = np.concatenate([first, rest]).reshape(n_steps, batch)
        self.pool = pool
        idx = torch.as_tensor(self.rows, device=device)
        self.idx = torch.stack([idx - 1, idx, idx + 1], -1)  # (steps, B, 3)
        xy = torch.as_tensor(track[self.rows], dtype=torch.float32, device=device)
        self.coords = xy[:, :, None, :].expand(-1, -1, 3, -1).contiguous()  # (steps, B, 3, 2)
        self.vis = torch.ones(self.coords.shape[:3], device=device)

    def __len__(self):
        return len(self.rows)

    def __call__(self, k):
        """(images (B, H, W, 9) f32 in [0, 255], coords (B, 3, 2), visibility (B, 3))."""
        x = self.pool[self.idx[k]]  # (B, 3, H, W, 3) uint8
        B, _, H, W, _ = x.shape
        return (x.permute(0, 2, 3, 1, 4).reshape(B, H, W, 9).float(), self.coords[k],
                self.vis[k])


class Trainer:
    """The one training object: model, parameters, Adam, EMA, generator."""

    def __init__(self, config, state, seed, device):
        from upliftingtabletennis_torch.data.image_transforms import ImageAugmentConfig
        from upliftingtabletennis_torch.models.factory import get_detector
        from upliftingtabletennis_torch.train import run_detection as RD

        m = config["model"]
        self.model, self.model_wh = get_detector(m["name"], m["task"], in_frames=m["in_frames"],
                                                 train=True)
        self.model.load_state_dict(state)
        self.model.to(device)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = list(self.model.parameters())
        self.ema = [p.detach().clone() for p in self.params]
        self.opt = RD.init_adam(self.params)
        self.gen = torch.Generator().manual_seed(seed)
        self.aug = ImageAugmentConfig(**config["augment"])
        self.config = config
        self.dtype = getattr(torch, config["dtype"]) if device.type == "cuda" else torch.float32
        self.step_fn = RD.train_step

    def step(self, batch):
        o, c = self.config["optimizer"], self.config
        return self.step_fn(self.model, self.params, self.opt, self.ema, self.gen, *batch,
                            tuple(self.model_wh), tuple(c["eval_wh"]), self.aug, c["sigma"],
                            o["lr"], o["ema_decay"], self.dtype)


def make_state(config, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return weights.make_state(weights.meta_module(train_check.builder(config)), gen,
                              getattr(torch, config["param_dtype"]), device)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    config, traffic, chk = cell.config, cell.traffic, cell.check
    device = torch.device(device)
    n_pool = int(traffic["pool_frames"])
    pool_np = frames.frame_pool(seed, n_pool, config["frame_wh"], traffic["frames"], "rgb",
                                device)
    pool = torch.from_numpy(pool_np).to(device)
    del pool_np
    track = frames.ball_track(np.random.default_rng([seed, 1]), n_pool, *config["frame_wh"],
                              traffic["frames"])
    state = make_state(config, seed, device)
    k_checked = int(chk["checked_steps"])
    feed = Feed(seed, pool, track, int(config["batch"]), 4096, k_checked, device)
    tr_obj = Trainer(config, state, seed, device)
    # the checked steps: the window's own feed and call, recorded for the check
    p0 = [p.detach().clone() for p in tr_obj.params]
    gen_states: List[torch.Tensor] = []
    losses: List[float] = []
    first_mu: Dict[str, torch.Tensor] = {}
    first_bn: Dict[str, torch.Tensor] = {}
    for k in range(k_checked):
        gen_states.append(tr_obj.gen.get_state())
        losses.append(float(tr_obj.step(feed(k))))
        if k == 0:
            first_mu = {n: mu.clone() for n, mu in zip(tr_obj.names, tr_obj.opt["mu"])}
            first_bn = {n: b.detach().float().clone() for n, b in tr_obj.model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}
    recorded = {"losses": losses, "gen_states": gen_states, "first_mu": first_mu,
                "first_bn": first_bn,
                "change": {n: p.detach() - q for n, p, q in zip(tr_obj.names, tr_obj.params, p0)},
                "ema_change": {n: e - q for n, e, q in zip(tr_obj.names, tr_obj.ema, p0)}}
    del p0
    if device.type == "cuda":
        torch.cuda.synchronize()
    limit = min(seconds, float(traffic["trace_seconds"])) if trace else seconds
    steps = 0
    k = k_checked
    with tracing.traced(trace, device.type) as held:
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        while True:
            loss = tr_obj.step(feed(k % len(feed)))
            k += 1
            steps += 1
            if time.perf_counter() - t0 >= limit:
                float(loss)  # the window ends when its last step has
                if device.type == "cuda":
                    torch.cuda.synchronize()
                break
        t1 = time.perf_counter()
    dev = device_info(device)
    del tr_obj, loss
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct, reported = train_check.judge(cell, seed, state, feed, recorded, device)
    images = steps * int(config["batch"])
    layer_ctx = breakdown = None
    if trace:
        tr = held.trace
        dev.update(busy_s=tr.busy_s if tr else 0.0, window_s=tr.window_s if tr else t1 - t0)
        layer_ctx = {"trace": tr, "config": config, "steps": steps,
                     "images": images, "batch": int(config["batch"])}
        if tr is not None:
            breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    return Outcome(attempted=steps, failed=0,
                   end_to_end={"setup_s": setup_s, "train_images_per_s": images / (t1 - t0)},
                   device=dev, checks=checks, correct=correct, layer_ctx=layer_ctx,
                   breakdown=breakdown, notes={"steps": steps, "window_s": t1 - t0,
                                               "losses": losses, "reported": reported})
