"""Run one benchmark cell of the PyTorch/CUDA port once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`: its configuration
(`benchmark/configs/<config>.json`), its traffic mix (`benchmark/traffic/mixes/<traffic>.json`),
the entry that drives the window (`benchmark/entries/<entry>.py`) and the limits of its
correctness check. The metrics a cell reports are the ones `BENCHMARK.json` lists for it:
its end-to-end metrics with `--trace 0`, its per-layer metrics (one reader each,
`benchmark/metrics/<metric>.py`) with `--trace 1`.

The last line of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device` (and with `--trace 1` `breakdown`), and last `checks`, each number the
correctness check compared beside its limit. The checks are also the last lines of
standard error. Without a CUDA device, with fewer devices than the cell asks for, or when
a module of JAX or of the JAX package is loaded once the window has closed, the run exits
with a non-zero code and prints no result.
"""
from __future__ import annotations

import time

T_START = time.time()  # set-up is timed from here, before any other import

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"  # every kernel cache of a run, at fixed paths inside the checkout

# Libraries that load JAX by themselves are kept from it, and every compiler cache lies
# in the checkout; set before torch is imported.
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv_compute")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        cell = harness.load_cell(args.workload)
    except FileNotFoundError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} devices, "
              f"torch.cuda.device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.banned_modules()
    if found:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
