"""`correct` of a rally cell: what the window's rallies produced, judged by the plain
reference (`benchmark/reference/`) on the same frames and weights.

Numbers compared, each against the limit of the cell's `check` section:

* `peak_gap`: for a sample of frames drawn from the seed (`draw_samples`: a frame of each
  rally's first piece and one of its last, the rest spread over every rally of the window),
  the reference runs the ingest (I420 -> RGB, the host downscale where the cell asks for
  it, each detector's resize and normalisation) and the four detectors in float32, and
  reads, for every heatmap channel, how far the reference's value in the cells that could
  hold the port's peak lies below the reference's maximum, over the maximum's height above
  the map's median. The widest such gap over the sample. Like the gap of a served token's
  logit below the best, it reads 0 where the port found the reference's peak and stays
  small where two cells nearly tie.
* `vis_mismatch`: channels whose visibility (maximum above the detector's threshold)
  differs from the reference's where the reference's maximum lies clear of the threshold.
* `filter_mismatch`: rallies whose filtered ball track, fused table keypoints or decision
  to run the uplifting model differ from the reference filters run on the port's own peaks
  (the filters are exact host code: the limit is 0).
* `uplift_err`: where the uplifting model ran, the largest relative error of its 3D
  positions and of its spin against the float32 reference on the same inputs; the spin in
  the world frame (the pipeline's flight-frame spin turned back by its own positions, so
  the frame's conditioning, which random weights make poor, is left out).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import filters as ref_filters
from benchmark.reference import ingest, peaks
from benchmark.reference.hrnet import Wrapped
from benchmark.reference.numerics import Products
from benchmark.reference.segformer import SegFormer
from benchmark.reference.uplifting import Uplifting, from_flight_frame

BLOCK = 4  # frames per reference forward


def builders(config) -> Dict[str, Any]:
    """role -> a function that builds the reference module of that role."""
    out = {}
    for role, det in config["detectors"].items():
        if det["arch"] == "segformer":
            cfg = config["segformer"][det["size"]]
            out[role] = (lambda c=cfg, d=det: SegFormer(c, d["in_frames"], d["out_channels"]))
        else:
            out[role] = (lambda c=config["hrnet"], d=det:
                         Wrapped(c, d["in_frames"], d["out_channels"]))
    out["uplifting"] = lambda: Uplifting(config["uplifting"])
    return out


def upload_target(config) -> Tuple[int, int]:
    """The largest detector input, (W, H): upload_res "model"."""
    return (max(d["input_wh"][0] for d in config["detectors"].values()),
            max(d["input_wh"][1] for d in config["detectors"].values()))


def ingest_frames(pool_frames: np.ndarray, config, traffic, device) -> torch.Tensor:
    """Raw frames of the pool -> the RGB uint8 frames (B, h, w, 3) the pipeline's detectors
    take, by the cell's pixel format and upload resolution."""
    x = torch.from_numpy(np.ascontiguousarray(pool_frames)).to(device)
    i420 = traffic["pixel_format"] == "i420"
    W, H = config["frame_wh"]
    target = None
    if traffic["upload_res"] == "model":
        tw, th = upload_target(config)
        if W > tw and H > th:
            target = (tw, th)
    elif traffic["upload_res"] is not None:
        target = tuple(traffic["upload_res"])
    if target is not None:
        tw, th = target
        if i420:
            return ingest.i420_to_rgb(ingest.downscale_i420(x, th, tw), th, tw)
        return ingest.resize_u8(x, th, tw)
    return ingest.i420_to_rgb(x, H, W) if i420 else x


def detector_input(rgb: torch.Tensor, det) -> torch.Tensor:
    MW, MH = det["input_wh"]
    x = rgb.float() if tuple(rgb.shape[1:3]) == (MH, MW) else ingest.resize(rgb, MH, MW)
    return ingest.normalize(x)


def heatmaps(model, det, rgb, P: Products) -> torch.Tensor:
    with torch.no_grad():
        heat = model(detector_input(rgb, det), P)
    if det["channel"] is not None:
        heat = heat[:, det["channel"]:det["channel"] + 1]
    return heat


def gaps(heat: torch.Tensor, got: torch.Tensor, det, peak_wh, vis_margin: float):
    """heat (B, C, h, w) of the reference; got (B, C, 3) peaks to judge. -> (gap per
    channel (B, C), visibility mismatches)."""
    B, C, h, w = heat.shape
    flat = heat.reshape(B, C, -1)
    mx = flat.max(-1).values
    med = flat.median(-1).values
    x_lo, x_hi, y_lo, y_hi = peaks.grid_window(got[..., :2], peak_wh[0], peak_wh[1], h, w)
    out = torch.zeros(B, C, dtype=torch.float64)
    for b in range(B):
        for c in range(C):
            best = heat[b, c, y_lo[b, c]:y_hi[b, c] + 1, x_lo[b, c]:x_hi[b, c] + 1].max()
            span = float(mx[b, c] - med[b, c])
            out[b, c] = float(mx[b, c] - best) / span if span > 0 else 0.0
    vis_bad = 0
    thr = det["threshold"]
    if thr is not None:
        want = mx > thr
        clear = (mx - thr).abs() > vis_margin * (mx - med)
        vis_bad = int(((got[..., 2] > 0.5) != want)[clear].sum())
    return out, vis_bad


def draw_samples(seed, done, n, stride, chunk):
    """[(rally index, ball frame, table row)] drawn from the seed: of every rally a frame of
    its first piece with its first table row, and a frame of its last piece (padded where
    the rally's length is not a multiple of `chunk`) with its last table row; the rest of
    the `n` spread over all the rallies' frames, each with a table row of its own."""
    rng = np.random.default_rng([seed, 3])
    ok = [i for i, r in enumerate(done) if r.peaks is not None]
    if not ok:
        return []
    out = []
    for i in ok:
        T = done[i].length
        rows = len(range(0, T, stride))
        last = (T - 1) // chunk * chunk
        out.append((i, int(rng.integers(min(chunk, T))), 0))
        out.append((i, int(rng.integers(last, T)), rows - 1))
    lengths = np.array([done[i].length for i in ok], np.float64)
    for _ in range(max(n - len(out), 0)):
        i = ok[int(rng.choice(len(ok), p=lengths / lengths.sum()))]
        T = done[i].length
        out.append((i, int(rng.integers(T)), int(rng.integers(len(range(0, T, stride))))))
    return out


def peak_readings(cell, seed, done, pool, states, device, control: Optional[str] = None):
    """The sample's widest gap and visibility mismatches of the port's peaks; with
    `control` a precision, of that precision's reference put in the port's place instead."""
    config, traffic, chk = cell.config, cell.traffic, cell.check
    stride = int(traffic["table_stride"])
    build = builders(config)
    samples = draw_samples(seed, done, int(chk["sample_frames"]), stride, int(config["chunk"]))
    peak_wh = config["peak_wh"]
    worst = {role: 0.0 for role in config["detectors"]}
    vis_bad = 0
    P, Pc = Products("f32"), Products(control) if control else None
    for role, det in config["detectors"].items():
        model = weights.materialise(build[role], states[role], device)
        table = role.startswith("table")
        for s in range(0, len(samples), BLOCK):
            part = samples[s:s + BLOCK]
            rgb, got = [], []
            for i, t, j in part:
                r = done[i]
                if table:
                    f = j * stride
                    rgb.append(ingest_frames(pool[r.offset + f:r.offset + f + 1], config,
                                             traffic, device))
                    if not control:
                        got.append(r.peaks[2 if role == "table_main" else 3][j])
                else:
                    idx = [max(t - 1, 0), t, min(t + 1, r.length - 1)]
                    fr = ingest_frames(pool[[r.offset + k for k in idx]], config, traffic, device)
                    rgb.append(torch.cat(list(fr), dim=-1)[None])
                    if not control:
                        got.append(r.peaks[0 if role == "ball_main" else 1][t][None])
            rgb = torch.cat(rgb)
            heat = heatmaps(model, det, rgb, P)
            if control:
                ctl = heatmaps(model, det, rgb, Pc)
                thr = det["threshold"] if det["threshold"] is not None else -np.inf
                got_t = peaks.extract(ctl, peak_wh[0], peak_wh[1], thr)
            else:
                got_t = torch.as_tensor(np.stack(got), dtype=torch.float32, device=device)
            g, v = gaps(heat, got_t, det, peak_wh, float(chk["vis_margin"]))
            worst[role] = max(worst[role], float(g.max()))
            vis_bad += v
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return worst, vis_bad, len(samples)


def filter_readings(cell, done):
    """Rallies whose filter outputs differ from the reference filters on the port's peaks."""
    config, traffic = cell.config, cell.traffic
    f = config["filters"]
    fps = float(traffic["fps"])
    W, H = config["peak_wh"]
    bad, ran, inputs = 0, 0, []
    for r in done:
        if r.peaks is None:
            continue
        bm, ba, tm, ta = r.peaks
        T = r.length
        n_t = len(range(0, T, int(traffic["table_stride"])))
        ok = bm.shape == (T, 3) and ba.shape == (T, 3) and tm.shape == (n_t, 13, 3) \
            and ta.shape == (n_t, 13, 3)
        if ok:
            ball, idx, times = ref_filters.ball(bm[1:T - 1], ba[1:T - 1], fps,
                                                f["ball_agreement_px"])
            table = ref_filters.table(tm, ta, f["table_agreement_px"], f["dbscan_min_samples"])
            o = r.out
            ok = (np.array_equal(idx, o["valid_idx"]) and np.array_equal(ball, o["ball"])
                  and np.array_equal(times, o["times"]) and np.array_equal(table, o["table"])
                  and (len(ball) >= 2) == (o["spin"] is not None))
            if ok and o["spin"] is not None:
                ran += 1
                inputs.append((ref_filters.uplifting_inputs(
                    ball, table, times, W, H, config["uplifting"]["seq_len"]), o))
        bad += not ok
    return bad, ran, inputs


def uplift_readings(cell, inputs, states, device, precision="f32"):
    """Largest relative error of the port's uplifting outputs (or, with `precision` lower
    than f32, of the reference in that precision) against the float32 reference."""
    model = weights.materialise(builders(cell.config)["uplifting"], states["uplifting"], device)
    worst = 0.0
    for (b, t, tt, m), o in inputs:
        args = [torch.as_tensor(a, device=device) for a in (b, t, m, tt)]
        with torch.no_grad():
            rot, pos = model(*args, Products("f32"))
            n = int(m.sum())
            spin = rot[0].double().cpu().numpy()
            pos = pos[0, :n].double().cpu().numpy()
            if precision != "f32":
                r2, p2 = model(*args, Products(precision))
                got_spin = r2[0].double().cpu().numpy()
                got_pos = p2[0, :n].double().cpu().numpy()
            else:
                got_pos = np.asarray(o["pos3d"], np.float64)
                got_spin = from_flight_frame(torch.as_tensor(o["spin"], dtype=torch.float64),
                                             torch.as_tensor(got_pos)).numpy()
        if got_pos.shape != pos.shape:
            return float("inf")
        worst = max(worst, float(np.abs(got_pos - pos).max() / max(np.abs(pos).max(), 1e-12)),
                    float(np.linalg.norm(got_spin - spin) / max(np.linalg.norm(spin), 1e-12)))
    return worst


def checks_of(cell, readings: Dict[str, Any]) -> Tuple[List[Dict[str, Any]], bool]:
    """The checks (name, value, limit, and what is reported beside) of the readings present,
    and whether all hold: `peak`: (worst gap by role, visibility mismatches, frames);
    `filters`: (mismatched rallies, rallies uplifted, rallies); `uplift_err`."""
    lim = cell.check["limits"]
    checks = []
    if "peak" in readings:
        worst, vis_bad, n = readings["peak"]
        checks += [{"name": "peak_gap", "value": max(worst.values()) if n else float("inf"),
                    "limit": lim["peak_gap"], "frames": n,
                    **{f"gap_{k}": v for k, v in worst.items()}},
                   {"name": "vis_mismatch", "value": vis_bad, "limit": lim["vis_mismatch"]}]
    ran = None
    if "filters" in readings:
        bad, ran, rallies = readings["filters"]
        checks.append({"name": "filter_mismatch", "value": bad, "limit": lim["filter_mismatch"],
                       "rallies": rallies})
    if "uplift_err" in readings:
        checks.append({"name": "uplift_err", "value": readings["uplift_err"],
                       "limit": lim["uplift_err"],
                       **({} if ran is None else {"rallies_uplifted": ran})})
    return checks, all(c["value"] <= c["limit"] for c in checks)


def judge(cell, seed, done, pool, states, device) -> Tuple[List[Dict[str, Any]], bool]:
    """The checks of one run (name, value, limit) and whether all hold."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    peak = peak_readings(cell, seed, done, pool, states, device)
    bad, ran, inputs = filter_readings(cell, done)
    up = uplift_readings(cell, inputs, states, device) if inputs else 0.0
    return checks_of(cell, {"peak": peak, "filters": (bad, ran, len(done)), "uplift_err": up})
