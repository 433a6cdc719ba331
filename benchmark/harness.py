"""The general part of the benchmark: finding a cell's files by name, running its entry,
choosing the metrics `BENCHMARK.json` lists for it, and the result line.

Nothing here knows a configuration, a traffic mix or a metric: each lives in files of its
own that this module finds by the name `BENCHMARK.json` and the cell's file give.

* `workloads/<cell>.json`: {"config", "traffic", "entry", "chips", "check": {...}}
* `configs/<config>.json`: the model configuration as it is run
* `traffic/mixes/<traffic>.json`: the traffic parameters the entry's generator reads
* `entries/<entry>.py`: `run(cell, seed, seconds, trace, device, t_start) -> Outcome`
* `metrics/<metric>.py`: `read(ctx) -> float | None`, one per per-layer metric
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names a run may not hold once its window has closed.
BANNED = ("jax", "jaxlib", "flax", "upliftingtabletennis_tpu")


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    @property
    def check(self) -> Dict[str, Any]:
        return self.workload.get("check", {})


@dataclass
class Outcome:
    """What an entry hands back: the end-to-end values it measured (by metric name), the
    reading context of the per-layer readers (traced runs), and its correctness check."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    device: Dict[str, Any]
    checks: List[Dict[str, Any]]
    correct: bool
    layer_ctx: Any = None
    breakdown: Optional[Dict[str, Any]] = None
    notes: Dict[str, Any] = field(default_factory=dict)


def _json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_cell(name: str, bench: Path = BENCH) -> Cell:
    """The cell's workload file and the configuration and traffic files it names."""
    workload = _json(bench / "workloads" / f"{name}.json")
    config = _json(bench / "configs" / f"{workload['config']}.json")
    traffic = _json(bench / "traffic" / "mixes" / f"{workload['traffic']}.json")
    return Cell(name, workload, config, traffic)


def benchmark_spec(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def _lists(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: Dict[str, Any], cell: str):
    """(end-to-end metrics, per-layer metrics) that `BENCHMARK.json` asks of this cell: an
    end-to-end metric where it lists the cell (or names no cells), a per-layer metric where
    it lists the cell, or names none and the cell reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"] if _lists(m, cell)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if ("workloads" in m and cell in m["workloads"])
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def reader(name: str, bench: Path = BENCH):
    """The module `metrics/<name>.py` (metric names hold dots, so it is loaded by path)."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(ROOT)}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             spec: Optional[Dict[str, Any]] = None, bench: Path = BENCH) -> Dict[str, Any]:
    """Run the cell once; the result object (without printing it)."""
    spec = spec if spec is not None else benchmark_spec(bench.parent)
    e2e, layer = cell_metrics(spec, cell.name)
    out: Outcome = entry(cell.workload["entry"]).run(cell, seed, seconds, trace, device, t_start)
    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in e2e:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    else:
        for m in layer:
            value = reader(m["name"], bench).read(out.layer_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(out.correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    if out.notes:
        result["notes"] = out.notes
    result["checks"] = out.checks
    return result


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(BANNED))


def check_line(c: Dict[str, Any]) -> str:
    return " ".join(f"{k}={c[k]}" for k in c)


def _plain(x):
    """numpy scalars (and arrays) as the JSON numbers they hold."""
    if hasattr(x, "tolist"):
        return x.tolist()
    raise TypeError(f"{type(x).__name__} is not JSON serializable")


def line(result: Dict[str, Any]) -> str:
    return json.dumps(result, default=_plain)


def emit(result: Dict[str, Any]) -> None:
    """The checks as the last lines of standard error, the result as the last line of
    standard output."""
    text = line(result)
    for c in result["checks"]:
        print(f"check {check_line(c)}", file=sys.stderr)
    sys.stderr.flush()
    print(text, flush=True)
