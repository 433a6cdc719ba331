"""BENCHMARK.json and the files it names agree, and the import guard compares top-level
names whole."""
import subprocess
import sys

from benchmark import harness
from tests_helpers import BENCH, ROOT


def test_every_cell_and_metric_has_its_files():
    spec = harness.benchmark_spec()
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.workload["config"] == w["config"] and cell.workload["traffic"] == w["traffic"]
        assert cell.chips == w["chips"]
        harness.entry(cell.workload["entry"])
        e2e, layer = harness.cell_metrics(spec, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for m in spec["per_layer"]:
        mod = harness.reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (m["layer"], m["unit"],
                                                                 m["moves"], m["source"])


def test_guard_compares_top_level_names_whole():
    assert harness.banned_modules({"jax.numpy": 1, "torch": 1}) == ["jax"]
    assert harness.banned_modules({"upliftingtabletennis_tpu.models": 1}) == \
        ["upliftingtabletennis_tpu"]
    assert harness.banned_modules({"upliftingtabletennis_torch.pipeline": 1, "jaxtyping": 1,
                                   "flaxish": 1}) == []


def test_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness; "
            "import benchmark.entries.rally, benchmark.checks.rally; "
            "import upliftingtabletennis_torch.pipeline.interface; "
            "bad = harness.banned_modules(); assert not bad, bad; "
            "sys.modules['jax'] = sys; assert harness.banned_modules() == ['jax']; print('ok')"
            % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_run_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "ensemble_i420_full", "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    if res.returncode == 0:  # a card is there: the run is the card test's business
        return
    assert res.stdout.strip() == "" and "CUDA" in res.stderr
