"""S1 (ops/csrc/physics.cu) beside another version of the same source, on one card.

Builds both with the port's nvcc flags (the other under its own library name, in the
ignored build directory), then prints and writes to --out:

- ptxas' registers, spills and stack of each kernel, and the SASS facts of each kernel's
  step loop (`chip_smoke.s1_sass_facts`; the SASS goes to --sass_dir);
- each version against the plain version (core/physics.py) on the card: trajectories
  that differ in any bit, at the main path's shapes;
- ms per call (median of CUDA events around single calls) and back to back, in turns
  (other, this, this, other), at 8,192 x 500 and 1 x 500 frames forward and 32, 512 and 1
  starts x 502 frames tangent, with SM cycles per step at the boost clock;
- with --fit, one warm `fit_physics` call at its defaults (the topspin track of phase
  `fit`) under torch.profiler on each version, in turns: wall ms, device busy ms, the
  idle share and S1's own device ms (chip_smoke.profile_calls), and the median wall time
  of 3 warm calls without the profiler.

    python3 tools/s1_compare.py --other PATH/physics.cu [--time this,other] [--fit]

--time names the versions to time (both by default).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402

FORWARD_SHAPES = ((8192, 500), (1, 500))
TANGENT_SHAPES = ((32, 502), (512, 502), (1, 502))


def build_other(_build, source: Path):
    """(library path, ptxas report) of another physics.cu, built beside the port's."""
    import hashlib

    digest = hashlib.sha256(source.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"physics_other-{digest.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr


def bind(path):
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uttk_physics_forward.argtypes = [P, P, P, I, I, I, I, P, P, P, P, P]
    lib.uttk_physics_forward.restype = I
    lib.uttk_physics_tangent.argtypes = [P, P, P, I, I, I, I, F, F, P, P, P, P]
    lib.uttk_physics_tangent.restype = I
    lib.uttk_error_string.argtypes = [I]
    lib.uttk_error_string.restype = ctypes.c_char_p
    return lib


def forward(torch, lib, s0, frames):
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import _build
    from upliftingtabletennis_torch.ops import physics as S1

    r0, v0, w0 = (x.contiguous() for x in s0)
    n = r0.shape[0]
    out = torch.empty(3, frames, n, 3, dtype=torch.float32, device=r0.device)
    status = _build.call_on_device(r0, lambda stream: lib.uttk_physics_forward(
        r0.data_ptr(), v0.data_ptr(), w0.data_ptr(), n, frames, 2, 1, S1._consts(P.DT),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream))
    _build.check(lib, status, "S1 forward")
    return out


def tangent(torch, lib, s0, frames, v_scale, w_scale):
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.ops import _build
    from upliftingtabletennis_torch.ops import physics as S1

    r0, v0, w0 = (x.contiguous() for x in s0)
    n = r0.shape[0]
    r = torch.empty(frames, n, 3, dtype=torch.float32, device=r0.device)
    jac = torch.empty(frames, n, 3, 9, dtype=torch.float32, device=r0.device)
    status = _build.call_on_device(r0, lambda stream: lib.uttk_physics_tangent(
        r0.data_ptr(), v0.data_ptr(), w0.data_ptr(), n, frames, 2, 1, float(v_scale),
        float(w_scale), S1._consts(P.DT), r.data_ptr(), jac.data_ptr(), stream))
    _build.check(lib, status, "S1 tangent")
    return r, jac


def fit_profiles(torch, libs, order):
    """One warm fit_physics call per version (S1's wrappers bound to its library) under
    torch.profiler, and the median wall time of warm calls without it."""
    import statistics
    import types

    from upliftingtabletennis_torch.ops import physics as S1
    from upliftingtabletennis_torch.pipeline.interface import TableTennisPipeline

    pipe = TableTennisPipeline.__new__(TableTennisPipeline)
    pipe.ball_detector = types.SimpleNamespace(device=torch.device("cuda"))
    obs, times, _, Mint, Mext = CS.fit_track(torch, CS.FIT_STATES["topspin"])
    out = {}
    for k in order:
        with CS.patched(S1, _lib=lambda k=k: libs[k]):
            pipe.fit_physics(obs, times, Mint, Mext)  # warm
            prof = CS.profile_calls(torch, lambda: pipe.fit_physics(obs, times, Mint, Mext),
                                    f"one warm fit_physics call ({k})")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                pipe.fit_physics(obs, times, Mint, Mext)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t))
        s1_ms = sum(r["ms"] for r in prof["top"] if "_kernel" in r["kernel"]
                    and ("tangent" in r["kernel"] or "forward" in r["kernel"]))
        entry = {key: prof[key] for key in ("wall_ms", "device_busy_ms", "idle_share",
                                            "launches")}
        entry.update(s1_device_ms=s1_ms, wall_ms_unprofiled=statistics.median(walls))
        out.setdefault(k, []).append(entry)
        print("fit", k, json.dumps(entry), flush=True)
    return out


def differing(torch, got, want):
    """Trajectories (dim 1) with any bit different (NaN equal to NaN)."""
    bad = None
    for g, w in zip(got, want):
        d = ((g != w) & ~(g.isnan() & w.isnan())).reshape(g.shape[0], g.shape[1], -1)
        d = d.any(-1).any(0)
        bad = d if bad is None else bad | d
    return int(bad.sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="the other physics.cu")
    ap.add_argument("--time", default="this,other", help="versions to time")
    ap.add_argument("--out", default="chiprun_out/s1_compare.json")
    ap.add_argument("--sass_dir", default="chiprun_out/s1_sass")
    ap.add_argument("--fit", action="store_true", help="also profile fit_physics on each")
    opts = ap.parse_args()
    timed = set(opts.time.split(",")) - {""}

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("s1_compare: CUDA is not available", file=sys.stderr)
        return 1
    from upliftingtabletennis_torch.core import fitting as FIT
    from upliftingtabletennis_torch.core import physics as P
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.ops import _build
    from upliftingtabletennis_torch.ops import physics as S1

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    res = {"card": card, "versions": {}}
    paths, reports = {}, {}
    paths["other"], reports["other"] = build_other(_build, Path(opts.other))
    try:
        reports["this"] = _build.build(["physics.cu"]).get("physics.cu", "")
        paths["this"] = _build._lib_path("physics.cu")
    except RuntimeError as e:  # the other version is still measured
        print(f"this version failed to build:\n{e}", flush=True)
        res["build_error"] = str(e)
        timed.discard("this")
    libs = {k: bind(p) for k, p in paths.items()}
    os.makedirs(opts.sass_dir, exist_ok=True)
    for k, p in paths.items():
        sass = CS.s1_sass(_build, p)
        Path(opts.sass_dir, f"{k}.sass").write_text(sass)
        res["versions"][k] = {"ptxas": CS.s1_ptxas(reports[k]), "sass": CS.s1_sass_facts(sass)}
        print(k, "ptxas", json.dumps(res["versions"][k]["ptxas"]), flush=True)
        print(k, "sass", json.dumps(res["versions"][k]["sass"]), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_states = {n: DG.sample_initial_conditions(n, "intermediate", "left_to_right", gen, "cuda")
                  for n, _ in FORWARD_SHAPES}
    dev = torch.device("cuda")
    with CS.patched(S1, simulate=P.simulate):  # the track from the plain version
        obs, times, _, Mint, Mext = CS.fit_track(torch, CS.FIT_STATES["topspin"],
                                                 CS.FIT_OBS_LONG)
    o, t_, m, Ki, Ke = (torch.as_tensor(a, device=dev) for a in
                        (obs, times, np.ones(len(obs), np.float32), Mint, Mext))
    tan_states = {}
    for n, _ in TANGENT_SHAPES:
        st = FIT.default_inits(o, t_, m, Ki, Ke, max(n, 32), torch.Generator(device=dev)
                               .manual_seed(n))
        tan_states[n] = P.BallState(*(x[:n].contiguous() for x in st))
    scales = (FIT.V_SCALE, FIT.W_SCALE)

    # each version against the plain version
    checks = {}
    for n, frames in FORWARD_SHAPES:
        want = P.simulate(fwd_states[n], frames)
        checks[f"forward_{n}x{frames}"] = {
            k: differing(torch, forward(torch, lib, fwd_states[n], frames), want)
            for k, lib in libs.items()}
    for n, frames in TANGENT_SHAPES:
        want = P.simulate_tangent(tan_states[n], frames, 2, P.DT, *scales)
        checks[f"tangent_{n}x{frames}"] = {
            k: differing(torch, tangent(torch, lib, tan_states[n], frames, *scales), want)
            for k, lib in libs.items()}
    res["bitwise_differing"] = checks
    print("bitwise_differing", json.dumps(checks), flush=True)

    # times, in turns
    order = [k for k in ("other", "this", "this", "other") if k in timed]
    times_ = {}
    cases = ([(f"forward_{n}x{f}", 1 + (f - 1) * 2,
               lambda lib, n=n, f=f: forward(torch, lib, fwd_states[n], f))
              for n, f in FORWARD_SHAPES]
             + [(f"tangent_{n}x{f}", 1 + (f - 1) * 2,
                 lambda lib, n=n, f=f: tangent(torch, lib, tan_states[n], f, *scales))
                for n, f in TANGENT_SHAPES])
    for name, steps, fn in cases:
        runs = {}
        for k in order:
            ms = CS.time_ms(torch, lambda: fn(libs[k]), iters=CS.S1_TIMED_CALLS)
            pipe = CS.pipelined_ms(torch, lambda: fn(libs[k]), reps=CS.S1_TIMED_CALLS)
            runs.setdefault(k, []).append({"ms": ms, "ms_pipelined": pipe,
                                           "cycles_per_step": ms * 1e-3 * CS.SM_CLOCK_HZ / steps})
        times_[name] = runs
        print("time", name, json.dumps(runs), flush=True)
    res["times"] = times_

    if opts.fit:
        res["fit"] = fit_profiles(torch, libs, order)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    Path(opts.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
