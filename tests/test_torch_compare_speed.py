"""The port's `eval/compare_speed.py` against the JAX package's.

* `BALL_MODELS` / `TABLE_MODELS` equal JAX's factory lists.
* The parameter count `measure` reports, for every model of both lists at its native
  resolution, equals the JAX model's (its `params` collection, shapes from
  `jax.eval_shape`, so nothing is computed): exactly.
* `measure(..., device="cpu")` runs at a tiny resolution and reports a finite time; the
  CLI prints one line per model. A CPU time, not a device time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from upliftingtabletennis_tpu.models import factory as JF
from upliftingtabletennis_torch.eval import compare_speed as CS
from upliftingtabletennis_torch.models import factory as F


def test_model_lists_match_jax():
    assert F.BALL_MODELS == JF.BALL_MODELS and F.TABLE_MODELS == JF.TABLE_MODELS


def _jax_param_count(name, task):
    model, (W, H) = JF.get_detector(name, task, train=False)
    C = 9 if task == "ball" else 3
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, H, W, C), jnp.float32))
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("task,name", [("ball", n) for n in JF.BALL_MODELS]
                         + [("table", n) for n in JF.TABLE_MODELS])
def test_parameter_counts_match_jax(task, name):
    model, _ = F.get_detector(name, task)
    assert sum(p.numel() for p in model.parameters()) == _jax_param_count(name, task)


@pytest.mark.parametrize("task,name", [("ball", "wasb"), ("table", "segformerpp_b0")])
def test_measure_runs_on_the_cpu(task, name):
    m = CS.measure(task, name, batch=2, iters=1, resolution=(64, 32), device="cpu")
    assert m["resolution"] == (64, 32) and m["device"] == "cpu" and m["dtype"] == "float32"
    assert np.isfinite(m["sec_per_batch"]) and m["sec_per_batch"] > 0
    assert m["fps"] == pytest.approx(2 / m["sec_per_batch"])
    assert m["params_M"] * 1e6 == pytest.approx(_jax_param_count(name, task))


def test_cli_on_the_cpu(capsys):
    out = CS.main(["--task", "table", "--models", "hrnet", "segformerpp_b0", "--batch", "1",
                   "--iters", "1", "--resolution", "64", "32", "--device", "cpu"])
    assert [m["model"] for m in out] == ["hrnet", "segformerpp_b0"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all("ms/batch" in ln and "cpu, float32)" in ln for ln in lines)
