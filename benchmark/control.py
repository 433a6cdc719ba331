"""Readings that set a cell's correctness limits, in one process on the card:

* the program's: one run of the cell per seed, at the cell's own load, with a short window
  (`--seconds`), printing the numbers its check compares;
* the control's: the plain reference in the precision next below the configuration's put
  in the program's place (fp8 products for the bf16 detectors, bf16 for the f32 uplifting
  model), on the same frames, weights and sample, at the cell's size, judged by the cell's
  own checks and limits (`correct` false is what the control has to give).

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--program] [--seconds 4]
        [--fault <name>] [--no-control] [--witness]

One JSON line per reading on standard output. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402


def control_readings(cell, seed, device, n_rallies=8):
    """The control's checks for one seed, judged as a run's are by the cell's limits: its
    peak gaps and visibility mismatches (fp8 detectors), its uplifting error (bf16). The
    filters are exact host code and have no control."""
    import numpy as np
    import torch

    from benchmark.checks import rally as rc
    from benchmark.entries import rally
    from benchmark.reference import filters as ref_filters
    from benchmark.traffic import frames, rallies

    cfg, traffic = cell.config, cell.traffic
    pool = frames.frame_pool(seed, int(traffic["pool_frames"]), cfg["frame_wh"],
                             traffic["frames"], traffic["pixel_format"], device)
    states = rally.make_states(cfg, seed, device)
    sched = rallies.schedule(seed, traffic["rally_groups"], len(pool), n_rallies)
    done = [rally.Rally(o, T, 0.0, peaks=(), out=None) for g in sched for o, T in g]
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    peak = rc.peak_readings(cell, seed, done, pool, states, device, control="fp8")
    # the uplifting model on the pool's own ball flight (every step kept) and a table
    rng = np.random.default_rng([seed, 5])
    W, H = cfg["peak_wh"]
    T = cfg["uplifting"]["seq_len"]
    track = frames.ball_track(np.random.default_rng([seed, 1]), T, W, H, traffic["frames"])
    table = np.concatenate([rng.uniform(0, 1, (13, 1)) * W, rng.uniform(0, 1, (13, 1)) * H,
                            np.ones((13, 1))], 1)
    times = np.arange(T) / float(traffic["fps"])
    inputs = [(ref_filters.uplifting_inputs(track, table, times, W, H, T), None)]
    up = rc.uplift_readings(cell, inputs, states, device, precision="bf16")
    checks, correct = rc.checks_of(cell, {"peak": peak, "uplift_err": up})
    return {"seed": seed, "who": "control", "correct": correct, "checks": checks}


def train_control_readings(cell, seed, device, precisions=("fp8",)):
    """The control's readings of a training cell: the reference's checked steps in fp8
    products, judged as the program's are against the float32 reference (with "bf16" in
    `precisions`, the reference in bfloat16 as a witness of the program's precision)."""
    import numpy as np
    import torch

    from benchmark.checks import train as tc
    from benchmark.entries import train
    from benchmark.traffic import frames

    cfg, traffic = cell.config, cell.traffic
    n = int(traffic["pool_frames"])
    pool = torch.from_numpy(frames.frame_pool(seed, n, cfg["frame_wh"], traffic["frames"], "rgb",
                                              device)).to(device)
    track = frames.ball_track(np.random.default_rng([seed, 1]), n, *cfg["frame_wh"],
                              traffic["frames"])
    state = train.make_state(cfg, seed, device)
    k = int(cell.check["checked_steps"])
    feed = train.Feed(seed, pool, track, int(cfg["batch"]), k, k, device)
    gen, gen_states = torch.Generator().manual_seed(seed), []
    for _ in range(k):  # the draws of each step: the affine's, then the jitter's
        gen_states.append(gen.get_state())
        torch.rand(8, int(cfg["batch"]), generator=gen)
        torch.rand(5, int(cfg["batch"]), generator=gen)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = tc.replay(cell, state, feed, gen_states, device)
    out = {}
    for precision in precisions:
        r = tc.readings(cell, tc.replay(cell, state, feed, gen_states, device,
                                        precision=precision), ref)
        checks, correct, reported = tc.checks_of(cell, r)
        out[precision] = {"correct": correct, "checks": checks, "reported": reported}
    return {"seed": seed, "who": "control", **out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true", help="also the program's readings")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None,
                   help="run the program with this fault of faults.py planted (with --program)")
    p.add_argument("--no-control", action="store_true", help="the program's readings only")
    p.add_argument("--witness", action="store_true",
                   help="training cells: the reference in bfloat16 beside the fp8 control")
    args = p.parse_args(argv)
    import torch

    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        if args.program:
            t = time.time()
            fault = contextlib.nullcontext()
            if args.fault:
                fault = {**faults.RALLY, **faults.TRAIN}[args.fault]()
            with fault:
                res = harness.run_cell(cell, seed, args.seconds, False, args.device, t)
            print(harness.line({"seed": seed, "who": args.fault or "program",
                                "correct": res["correct"], "checks": res["checks"],
                                "metrics": res["metrics"], "notes": res.get("notes")}),
                  flush=True)
        if args.no_control:
            continue
        if cell.workload["entry"] == "train":
            r = train_control_readings(cell, seed, device,
                                       ("fp8", "bf16") if args.witness else ("fp8",))
        else:
            r = control_readings(cell, seed, device)
        print(harness.line(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
