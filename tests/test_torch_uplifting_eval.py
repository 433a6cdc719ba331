"""The port's uplifting evaluation (eval/robustness.py, data/ttst.py, data/tt3d.py, the
synthetic TTST and TT3D writers, eval/run_uplifting_eval.py) against the JAX package, and
the trainer's CLI (train/run_uplifting.py) on the CPU with its --resume round trip.

Both packages' writers get the same simulated flights (each package's `generate_dataset`
replaced by seeded analytic flights: simulating real candidates costs seconds per batch
on the CPU, and datagen has its own tests), and each package's reader reads both
layouts. The robustness transforms are numpy with the same seeded draws: equal. The
TTST files are equal but for the reprojection (within 1e-2 px) and the simulation
camera (Mext within 2e-5: the port builds it in f64, JAX in f32); the TT3D files are
byte-equal, and the readers agree within 1e-9 (pandas and numpy parse the CSV's floats).
`eval_ttst` and `eval_tt3d` on the same weights ('connectstage' small, carried across by
`flax_to_torch`) agree within 1e-4 relative, the spin metrics equal.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from uplift_data import analytic_datagen
from upliftingtabletennis_tpu.data import datagen as JDG
from upliftingtabletennis_tpu.data import tt3d as JTT3D
from upliftingtabletennis_tpu.data import ttst as JTTST
from upliftingtabletennis_tpu.data.make_synthetic_tt3d import write_synthetic_tt3d as jax_tt3d
from upliftingtabletennis_tpu.data.make_synthetic_ttst import write_synthetic_ttst as jax_ttst
from upliftingtabletennis_tpu.eval import robustness as JR
from upliftingtabletennis_tpu.eval import run_uplifting_eval as JEV
from upliftingtabletennis_tpu.models.uplifting import get_uplifting_model as jax_get_model
from upliftingtabletennis_torch import hub
from upliftingtabletennis_torch.data import datagen as DG
from upliftingtabletennis_torch.data import tt3d as TT3D
from upliftingtabletennis_torch.data import ttst as TTST
from upliftingtabletennis_torch.data.make_synthetic_tt3d import write_synthetic_tt3d
from upliftingtabletennis_torch.data.make_synthetic_ttst import write_synthetic_ttst
from upliftingtabletennis_torch.eval import robustness as R
from upliftingtabletennis_torch.eval import run_uplifting_eval as EV
from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.train import run_uplifting
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)
PX_ATOL, MEXT_ATOL, CSV_RTOL, EVAL_RTOL = 1e-2, 2e-5, 1e-9, 1e-4
MODE_SEED = {"intermediate": 11, "first_good": 12, "first_long": 13}


def _flights(n, mode):
    """Flights of one length: the JAX writers project them op by op, one compile per
    length."""
    return analytic_datagen(max(n, 4), seed=MODE_SEED[mode], n_valid=400)


@pytest.fixture
def same_flights(monkeypatch):
    """Both packages' generate_dataset give the same analytic flights per mode."""
    monkeypatch.setattr(JDG, "generate_dataset", lambda key, n, mode, direction, **kw:
                        _flights(n, mode))
    monkeypatch.setattr(DG, "generate_dataset", lambda n, mode, direction, **kw:
                        _flights(n, mode))


def _robustness_data(B=6, T=50):
    rng = np.random.default_rng(0)
    mask = np.zeros((B, T), np.float32)
    for b in range(B):
        mask[b, : rng.integers(8, T + 1)] = 1.0
    return {"r_img": rng.random((B, T, 2)).astype(np.float32) * mask[..., None],
            "table_img": np.concatenate([rng.random((B, 13, 2)), np.ones((B, 13, 1))],
                                        -1).astype(np.float32),
            "mask": mask, "times": (np.arange(T, dtype=np.float32) / 50 * mask)}


@pytest.mark.parametrize("name", [n for n, _ in R.STANDARD_SUITE] + ["DropBall", "DropTable"])
def test_robustness_transforms_match_jax(name):
    if name in ("DropBall", "DropTable"):
        got_fn, want_fn = getattr(R, name)(0.3, seed=1), getattr(JR, name)(0.3, seed=1)
    else:
        got_fn, want_fn = dict(R.STANDARD_SUITE)[name](), dict(JR.STANDARD_SUITE)[name]()
    for _ in range(2):  # the second call continues each transform's draws
        data = _robustness_data()
        got, want = got_fn(dict(data)), want_fn(dict(data))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)


def test_ttst_writers_and_readers_agree(tmp_path, same_flights):
    n_port = write_synthetic_ttst(str(tmp_path / "port"), 9, device="cpu")
    n_jax = jax_ttst(str(tmp_path / "jax"), 9)
    assert n_port == n_jax == 9
    for i in range(9):
        d = f"ttst/trajectory_{i:04d}"
        for name in ("times", "hits", "spin_class", "Mint"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / d / f"{name}.npy"),
                                          np.load(tmp_path / "jax" / d / f"{name}.npy"), name)
        np.testing.assert_allclose(np.load(tmp_path / "port" / d / "Mext.npy"),
                                   np.load(tmp_path / "jax" / d / "Mext.npy"), atol=MEXT_ATOL)
        np.testing.assert_allclose(np.load(tmp_path / "port" / d / "r_img.npy"),
                                   np.load(tmp_path / "jax" / d / "r_img.npy"), atol=PX_ATOL)
    for layout in ("port", "jax"):
        for mode in ("val", "test", "all"):
            got = TTST.load_ttst(str(tmp_path / layout / "ttst"), mode)
            want = JTTST.load_ttst(str(tmp_path / layout / "ttst"), mode)
            assert len(got) == len(want) == {"val": 2, "test": 7, "all": 9}[mode]
            for f in TTST.TTSTBatch._fields:
                np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                           atol=PX_ATOL if f == "table_img" else 0, err_msg=f)


def test_tt3d_writers_and_readers_agree(tmp_path, same_flights):
    pytest.importorskip("yaml")
    assert write_synthetic_tt3d(str(tmp_path / "port"), 6, device="cpu") == 6
    assert jax_tt3d(str(tmp_path / "jax"), 6) == 6
    base = os.path.join("tt3d", "data", "evaluation")
    files = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "jax")
                   for r, _, fs in os.walk(tmp_path / "jax" / base) for f in fs)
    assert len(files) == 3 + 3 * 2 * 6
    for f in files:
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f
    for view in ("back", "side", "oblique"):
        for noise in (True, False):
            got = TT3D.load_tt3d(str(tmp_path / "port"), view, noise)
            want = JTT3D.load_tt3d(str(tmp_path / "port"), view, noise)
            for f in TT3D.TT3DBatch._fields:
                np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=CSV_RTOL,
                                           atol=1e-9, err_msg=f)
    with pytest.raises(FileNotFoundError):
        TT3D.load_tt3d(str(tmp_path / "nowhere"), "back")


@pytest.fixture(scope="module")
def small_model():
    """(JAX model, its params, the port model with the same weights)."""
    jmodel = jax_get_model("connectstage", "small", "dynamic")
    x = np.zeros((1, 50, 2), np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), x, np.zeros((1, 13, 3), np.float32),
                                  np.ones((1, 50), np.float32), np.zeros((1, 50), np.float32))
    model = get_uplifting_model("connectstage", "small", "dynamic")
    model.load_state_dict(flax_to_torch({"params": jax.device_get(params["params"])}))
    return jmodel, params["params"], model.eval()


def test_eval_ttst_and_tt3d_match_jax(tmp_path, same_flights, small_model):
    jmodel, params, model = small_model
    write_synthetic_ttst(str(tmp_path), 12, device="cpu")
    write_synthetic_tt3d(str(tmp_path), 4, device="cpu")
    ttst = TTST.load_ttst(str(tmp_path / "ttst"), "all")
    # the transforms themselves are held above; JAX compiles its forward at every call
    got = EV.eval_ttst(model, "global", ttst, R.Identity())
    want = JEV.eval_ttst(jmodel, params, "global", ttst, JR.Identity())
    for k in ("mean_2d_px", "std_2d_px", "mean_2d_normed"):
        assert abs(got[k] - want[k]) <= EVAL_RTOL * abs(want[k]), k
    assert got["spin_accuracy"] == want["spin_accuracy"]
    assert got["spin_macro_f1"] == want["spin_macro_f1"]
    got = EV.eval_tt3d(model, "global", str(tmp_path))
    want = JEV.eval_tt3d(jmodel, params, "global", str(tmp_path))
    assert set(got) == set(want) and len(got) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL)


def test_load_uplifting_reads_port_checkpoints_and_refuses_reference_pt(tmp_path, small_model):
    model = small_model[2]
    info = {"name": "connectstage", "size": "small", "tabletoken_mode": "dynamic",
            "time_rotation": "new", "transform_mode": "local"}
    save_checkpoint(str(tmp_path / "model"), model.state_dict(), "run", info)
    loaded, tm = EV.load_uplifting(str(tmp_path / "model"), "cpu")
    assert tm == "local"
    for a, b in zip(loaded.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    # a .pt without its .json is read as a reference checkpoint
    # (tests/test_torch_port_torch.py): a bare state dict is not one
    torch.save(model.state_dict(), tmp_path / "reference.pt")
    with pytest.raises(KeyError, match="model_state_dict"):
        EV.load_uplifting(str(tmp_path / "reference.pt"), "cpu")


def test_cli_resume_round_trip_then_eval(tmp_path, monkeypatch, capsys):
    """run_uplifting --device cpu, small, --generate 8: one epoch, then --resume from latest
    for a second (as tests/test_train_resume.py for JAX); the checkpoints load through
    hub.uplifting and run_uplifting_eval scores them on a TTST layout."""
    calls = []

    def generate(n, mode, direction, generator, device):
        calls.append((n, mode, direction, str(device)))
        return _flights(n, mode)

    monkeypatch.setattr(DG, "generate_dataset", generate)
    write_synthetic_ttst(str(tmp_path), 9, device="cpu")
    calls.clear()
    save = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--model_name", "connectstage", "--model_size", "small",
              "--generate", "8", "--batch_size", "8",
              "--save_dir", save, "--logdir", str(tmp_path / "runs"), "--save_latest_every", "1",
              "--seed", "3", "--ttst_dir", str(tmp_path / "ttst")]
    first = run_uplifting.main(common + ["--num_epochs", "1"])
    assert calls == [(8, m, "left_to_right", "cpu") for m in run_uplifting.GEN_MODES]
    latest = os.path.join(first["run_dir"], "latest")
    assert load_checkpoint(latest)[2]["epoch"] == 0
    saved0 = first["history"][0]["saved"]
    assert {"model_trajectory", "model_spin", "model_synthetic"} <= set(saved0)

    second = run_uplifting.main(common + ["--num_epochs", "2", "--resume", latest])
    assert second["identifier"] == first["identifier"] and second["start_epoch"] == 1
    # the resumed state is the first run's final state, bit for bit
    final = run_uplifting.state_dict_of(
        get_uplifting_model("connectstage", "small", "dynamic"), first["state"])
    assert set(final) == set(second["resume_state"])
    for k, v in final.items():
        assert torch.equal(v.cpu(), second["resume_state"][k]), k
    info = load_checkpoint(latest)[2]
    assert info["epoch"] == 1 and info["best"] == second["best"]
    assert info["best"]["trajectory"] < 1e8
    lines = [json.loads(x) for x in open(os.path.join(second["log_dir"], "metrics.jsonl"))]
    assert [x["epoch"] for x in lines if "epoch" in x] == [0, 1]
    assert "val real/macro f1" in lines[-1] and "train/loss" in lines[0]

    # every checkpoint the metrics called for exists, with the EMA weights
    for name in {n for rec in first["history"] + second["history"] for n in rec["saved"]}:
        assert os.path.isfile(os.path.join(first["run_dir"], name)), name
    ckpt = os.path.join(first["run_dir"], "model_synthetic")
    up = hub.uplifting(checkpoint=ckpt, device="cpu")
    state, _, info = load_checkpoint(ckpt)
    assert info["size"] == "small" and info["transform_mode"] == "global"
    ball, table, mask, times = (torch.rand(2, 50, 2), torch.rand(2, 13, 3).round(),
                                torch.ones(2, 50), torch.arange(50.0).repeat(2, 1) / 50)
    ref = get_uplifting_model("connectstage", "small", "dynamic")
    ref.load_state_dict(state)
    with torch.no_grad():
        for a, b in zip(up.model(ball, table, mask, times), ref(ball, table, mask, times)):
            assert torch.equal(a, b)

    out = EV.main(["--checkpoint", os.path.join(first["run_dir"], "model_synthetic"),
                   "--ttst_dir", str(tmp_path / "ttst"), "--device", "cpu"])
    assert list(out["ttst"]) == ["Identity", "HalfFPS", "Drop", "Combine"]
    for m in out["ttst"].values():
        assert all(np.isfinite(v) for v in m.values())
    assert "[TTST/Combine]" in capsys.readouterr().out


def test_cli_debug_turns_on_anomaly_detection_and_tmp_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(DG, "generate_dataset", lambda n, mode, direction, **kw:
                        _flights(n, mode))
    try:
        out = run_uplifting.main(["--device", "cpu", "--model_size", "small", "--generate", "8",
                                  "--num_epochs", "0", "--debug",
                                  "--save_dir", str(tmp_path / "ck"),
                                  "--logdir", str(tmp_path / "runs")])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert out["log_dir"].startswith(str(tmp_path / "runs_tmp"))
    assert out["run_dir"].startswith(str(tmp_path / "ck_tmp"))
    assert out["history"] == [] and out["start_epoch"] == 0
