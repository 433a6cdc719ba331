"""A configuration, a traffic mix, a cell and a per-layer metric added as new files only, in
a copy of the benchmark: the harness finds each by name and runs the cell, and no file that
was there changes."""
import hashlib
import json
import shutil

from benchmark import harness
from tests_helpers import BENCH, ROOT

from conftest import TINY_FRAME, TINY_INPUT

READER = '''"""Frames of the traced rallies."""
LAYER = "pipeline (pipeline/interface.py run_rally)"
UNIT = "frames"
MOVES = "frames_per_s"
SOURCE = "program_counter"


def read(ctx):
    return float(ctx["frames"]) if ctx and ctx["frames"] else None
'''


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tmp_path, tiny_port):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", ".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)

    cfg = json.loads((bench / "configs" / "tt_ensemble_b2.json").read_text())
    cfg.update(name="tiny_ensemble", frame_wh=list(TINY_FRAME))
    for det in cfg["detectors"].values():
        det["input_wh"] = list(TINY_INPUT)
    (bench / "configs" / "tiny_ensemble.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "mixes" / "rallies_i420_full.json").read_text())
    mix.update(rally_groups=[[9, 12]], pool_frames=16, warmup_frames=10, trace_seconds=0.5)
    (bench / "traffic" / "mixes" / "tiny_rallies.json").write_text(json.dumps(mix))
    cell = json.loads((bench / "workloads" / "ensemble_i420_full.json").read_text())
    cell.update(name="tiny_cell", config="tiny_ensemble", traffic="tiny_rallies")
    cell["check"]["sample_frames"] = 4
    (bench / "workloads" / "tiny_cell.json").write_text(json.dumps(cell))
    (bench / "metrics" / "frames_traced.rally.py").write_text(READER)

    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_ensemble", "source": "test", "reduced": [],
                            "file": "benchmark/configs/tiny_ensemble.json", "why": "test"})
    spec["workloads"].append({"name": "tiny_cell", "config": "tiny_ensemble",
                              "traffic": "tiny_rallies", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "ensemble_i420_full" in m["workloads"]:
            m["workloads"].append("tiny_cell")
    spec["per_layer"].append({"name": "frames_traced.rally", "unit": "frames", "better": "higher",
                              "source": "program_counter",
                              "layer": "pipeline (pipeline/interface.py run_rally)",
                              "moves": "frames_per_s", "workloads": ["tiny_cell"]})

    loaded = harness.load_cell("tiny_cell", bench)
    res = harness.run_cell(loaded, 2 ** 31 + 99, 0.5, True, "cpu", 0.0, spec=spec, bench=bench)
    assert res["correct"], res["checks"]
    assert res["metrics"]["frames_traced.rally"]["value"] >= 9
    res = harness.run_cell(loaded, 2 ** 31 + 99, 0.5, False, "cpu", 0.0, spec=spec, bench=bench)
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
