"""The rally cells: `TableTennisPipeline.run_rally` driven back to back by one caller
(closed loop) over rallies cut from a frame pool made at set-up.

Set-up: the frame pool and the weights from the seed (on the device), the pipeline built
with those weights, every shape of the cell's traffic warmed by two short rallies and one
uplifting call. Window: groups of rallies of the schedule until `--seconds` have passed,
the last group run to its end; frames/s is all their frames over all that time. The peaks
each rally's detectors produced are recorded as the pipeline hands them to its filters.
After the window the peak memory is read, the pipeline is freed, and `checks/rally.py`
judges what the window produced against the plain reference.
"""
from __future__ import annotations

import gc
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark import trace as tracing
from benchmark import weights
from benchmark.checks import rally as rally_check
from benchmark.harness import Outcome
from benchmark.traffic import frames, rallies

SCHEDULE_LEN = 256  # groups of rallies drawn; a window cycles through them if it runs out


@dataclass
class Rally:
    offset: int
    length: int
    seconds: float
    peaks: Optional[tuple] = None
    out: Optional[Dict[str, Any]] = None


def device_info(device: torch.device) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def rally_kwargs(traffic: Dict[str, Any]) -> Dict[str, Any]:
    return {"table_stride": int(traffic["table_stride"]),
            "pixel_format": traffic["pixel_format"], "upload_res": traffic["upload_res"]}


def build_pipeline(config, states, device):
    from upliftingtabletennis_torch.pipeline.interface import TableTennisPipeline

    return TableTennisPipeline(checkpoints=states, chunk=int(config["chunk"]), device=device)


def make_states(config, seed, device):
    """The weights of the five models, from the seed, in their served types."""
    gen = torch.Generator(device=device).manual_seed(seed)
    served = {"segformer": getattr(torch, config["dtype"]), "hrnet": torch.float32}
    states = {}
    for role, build in rally_check.builders(config).items():
        dtype = torch.float32 if role == "uplifting" else \
            served[config["detectors"][role]["arch"]]
        states[role] = weights.make_state(weights.meta_module(build), gen, dtype, device)
    return states


def warm(pipe, pool, traffic, fps, device):
    """Every shape of the cell: a short rally twice (pieces with and without table frames,
    first, inner and last pieces), and the uplifting model once."""
    kw = rally_kwargs(traffic)
    n = int(traffic["warmup_frames"])
    for _ in range(2):
        pipe.run_rally(pool[:n], fps, **kw)
    from upliftingtabletennis_torch.pipeline.filters import SEQUENCE_LEN as L

    ball = np.zeros((1, L, 2), np.float32)
    ball[0, :, 0] = np.linspace(0.2, 0.8, L)
    ball[0, :, 1] = 0.5
    table = np.concatenate([np.random.default_rng(0).uniform(0.2, 0.8, (1, 13, 2)),
                            np.ones((1, 13, 1))], -1).astype(np.float32)
    times = (np.arange(L, dtype=np.float32) / fps)[None]
    pipe.uplifting_model.predict_without_normalization(ball, table, np.ones((1, L), np.float32),
                                                       times)
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Outcome:
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)
    fps = float(traffic["fps"])
    pool = frames.frame_pool(seed, int(traffic["pool_frames"]), config["frame_wh"],
                             traffic["frames"], traffic["pixel_format"], device)
    states = make_states(config, seed, device)
    pipe = build_pipeline(config, states, device)
    record: List[tuple] = []
    run_peaks = pipe._rally_peaks

    def recording(*a, **k):
        out = run_peaks(*a, **k)
        record.append(out)
        return out

    pipe._rally_peaks = recording
    warm(pipe, pool, traffic, fps, device)
    record.clear()
    sched = rallies.schedule(seed, traffic["rally_groups"], len(pool), SCHEDULE_LEN)
    kw = rally_kwargs(traffic)
    limit = min(seconds, float(traffic["trace_seconds"])) if trace else seconds
    done: List[Rally] = []
    failed = 0
    with tracing.traced(trace, device.type) as held:
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        for i in range(10 ** 9):
            for off, T in sched[i % len(sched)]:
                r0 = time.perf_counter()
                try:
                    out = pipe.run_rally(pool[off:off + T], fps, **kw)
                except Exception as e:  # a rally that fails counts, and fails the check
                    traceback.print_exc()
                    failed += 1
                    done.append(Rally(off, T, time.perf_counter() - r0, None, {"error": repr(e)}))
                else:
                    done.append(Rally(off, T, time.perf_counter() - r0, record[-1], out))
                record.clear()
            if time.perf_counter() - t0 >= limit:
                break
        t1 = time.perf_counter()
    frames_done = sum(r.length for r in done)
    dev = device_info(device)
    del pipe, recording
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = rally_check.judge(cell, seed, done, pool, states, device)
    correct = correct and failed == 0
    layer_ctx = breakdown = None
    if trace:
        tr = held.trace
        dev.update(busy_s=tr.busy_s if tr else 0.0, window_s=tr.window_s if tr else t1 - t0)
        layer_ctx = rally_layer_ctx(config, traffic, done, tr)
        if tr is not None:
            breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    return Outcome(attempted=len(done), failed=failed,
                   end_to_end={"setup_s": setup_s, "frames_per_s": frames_done / (t1 - t0)},
                   device=dev, checks=checks, correct=correct, layer_ctx=layer_ctx,
                   breakdown=breakdown,
                   notes={"rallies": len(done), "frames": frames_done,
                          "window_s": t1 - t0,
                          "rally_s": [[r.length, r.seconds] for r in done],
                          "uplifting_ran": sum(1 for r in done
                                               if r.out and r.out.get("spin") is not None)})


def rally_layer_ctx(config, traffic, done, tr):
    """What the per-layer readers of a rally cell read: the trace and the work of the traced
    rallies (frames, pieces, pieces with table frames, table frames)."""
    chunk, stride = int(config["chunk"]), int(traffic["table_stride"])
    pieces = table_pieces = table_frames = 0
    for r in done:
        pieces += -(-r.length // chunk)
        centres = np.arange(0, r.length, stride)
        table_frames += len(centres)
        table_pieces += len(set((centres // chunk).tolist()))
    return {"trace": tr, "config": config, "chunk": chunk,
            "frames": sum(r.length for r in done), "pieces": pieces,
            "table_pieces": table_pieces, "table_frames": table_frames}
