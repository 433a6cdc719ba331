"""The port's `eval/run_physics_fit_eval.py` against the JAX package's.

At the JAX test's size (tests/test_eval_protocols.py: 2 starts, 2 Adam steps, 1 LM step,
batches of 4), with JAX's draws fed to the port (`draws=`: per batch, the starts of
`default_inits` from the batch key's split, and for the store protocol the detection
noise and the drop uniforms):

* `spin_metrics` equal on seeded labels;
* `eval_tt3d_fit` on a synthetic TT3D layout (4 analytic flights, the back view with and
  without noise), plain and in the hybrid mode seeded by the committed back-view uplifting
  model (JAX's Orbax checkpoint, the port's conversion of it);
* the store protocol (`main` of the JAX module, `eval_indices` + `evaluate_store` of the
  port) on an npz store of 24 analytic flights, with 1 px noise and 10% drops;
* the port's CLI with its own draws on the TT3D layout.

Both fits run in float32 (the JAX batch fit casts to it). Tolerance: the 3D errors, the
residuals and the losses within 1e-3 relative (the same f32 arithmetic through 2 Adam and
1 LM step; tests/test_torch_fitting.py holds the fit's steps themselves in float64), the
counts, the coverage and the spin labels exactly.
"""
import argparse
import glob
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.eval import run_physics_fit_eval as JPF
from upliftingtabletennis_torch.data import datagen as DG
from upliftingtabletennis_torch.data import synthetic as SYN
from upliftingtabletennis_torch.data.make_synthetic_tt3d import write_synthetic_tt3d
from upliftingtabletennis_torch.eval import run_physics_fit_eval as PF
from uplift_data import analytic_datagen

torch.set_num_threads(2)
RTOL = 1e-3
EXACT = ("n_traj", "n_converged", "coverage", "spin_acc", "spin_macro_f1", "gate_px",
         "max_spread_m", "noise_px", "drop", "spin_acc_converged", "spin_macro_f1_converged")
KW = dict(n_starts=2, adam_steps=2, lm_steps=1, batch=4, huber_px=None, seed=0, out=None)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _starts(kf, B, S):
    """The draws of the JAX fit_trajectory_batch(key=kf) for B tracks of S starts."""
    out = []
    for k in jax.random.split(kf, B):
        k_z, k_v, k_w, k_m = jax.random.split(k, 4)
        out.append({"z_t": jax.random.uniform(k_z, (S,), minval=0.85, maxval=1.9),
                    "v_mult": jax.random.uniform(k_m, (S, 1), minval=0.7, maxval=1.3),
                    "v_noise": jax.random.normal(k_v, (S, 3)),
                    "w_noise": jax.random.normal(k_w, (S, 3))})
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in out]


def _compare(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _compare(g, w)
        elif w is None or k in EXACT:
            assert g == w, k
        else:
            assert g == pytest.approx(w, rel=RTOL, abs=1e-6), k


def test_spin_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred, gt = rng.choice([1.0, 2.0], 40), rng.choice([1.0, 2.0], 40)
    assert PF.spin_metrics(pred, gt) == JPF.spin_metrics(pred, gt)
    assert PF.spin_metrics(gt, gt) == JPF.spin_metrics(gt, gt) == (1.0, 1.0)


@pytest.fixture(scope="module")
def tt3d(tmp_path_factory):
    """4 analytic flights of 0.3 s (15 frames at 50 fps, so a 150-frame horizon: the
    plain CPU integrator costs about 4 ms per step) seen from the back view, with and
    without noise."""
    root = str(tmp_path_factory.mktemp("tt3d"))
    mp = pytest.MonkeyPatch()
    mp.setattr(DG, "generate_dataset", lambda n, mode, direction, **kw:
               analytic_datagen(max(n, 4), seed=11, n_valid=150))
    try:
        assert write_synthetic_tt3d(root, 4, modes=("intermediate",), device="cpu") == 4
    finally:
        mp.undo()
    base = os.path.join(root, "tt3d", "data", "evaluation")
    for view in ("side", "oblique"):
        for d in (view, f"{view}_no_noise"):
            shutil.rmtree(os.path.join(base, d))
        os.remove(os.path.join(base, f"{view}.yaml"))
    return root


@pytest.mark.parametrize("hybrid", [False, True], ids=["fit", "hybrid"])
def test_eval_tt3d_fit_matches_jax(tt3d, hybrid):
    args = argparse.Namespace(tt3d_dir=tt3d, **KW)
    jargs = argparse.Namespace(tt3d_dir=tt3d, **KW)
    if hybrid:
        (jax_ckpt,) = [os.path.join(d, "model") for d in glob.glob(
            os.path.join(REPO, "artifacts", "uplifting_backview", "ckpt", "*"))]
        jargs.init_checkpoint = jax_ckpt
        args.init_checkpoint = os.path.join(REPO, "upliftingtabletennis_torch", "weights",
                                            "closed_loop", "uplifting")
    want = JPF.eval_tt3d_fit(jargs)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(len(want)):  # one batch per view
        key, kf = jax.random.split(key)
        draws.append({"starts": _starts(kf, 4, 2)})
    got = PF.eval_tt3d_fit(args, device="cpu", draws=draws)
    assert list(got) == list(want) == ["back", "back_no_noise"]
    _compare(got, want)


def test_store_protocol_matches_jax(tmp_path):
    store = SYN.store_from_datagen(analytic_datagen(24, seed=3))
    SYN.save_store_npz(str(tmp_path / "intermediate" / "left_to_right.npz"), store)
    argv = ["--data_dir", str(tmp_path), "--n_traj", "4", "--batch", "4", "--n_starts", "2",
            "--adam_steps", "2", "--lm_steps", "1", "--noise_px", "1.0", "--drop", "0.1"]
    want = JPF.main(argv)
    args = PF._parser().parse_args(argv + ["--device", "cpu"])
    from upliftingtabletennis_torch.train.run_uplifting import build_store

    st, train_idx, val_idx = build_store(args, "cpu")
    idx = PF.eval_indices(len(st), train_idx, val_idx, "test", 4, 0)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(0, len(idx), 4):
        key, _kb, kn, kd, kf = jax.random.split(key, 5)
        draws.append({"noise": torch.from_numpy(np.asarray(jax.random.normal(kn, (4, 50, 2)))),
                      "drop_u": torch.from_numpy(np.asarray(jax.random.uniform(kd, (4, 50)))),
                      "starts": _starts(kf, 4, 2)})
    got = PF.evaluate_store(st, idx, args, "cpu", draws=draws)
    assert got["n_traj"] == 4
    _compare(got, want)


def test_cli_with_default_draws(tt3d, tmp_path, capsys):
    out = PF.main(["--tt3d_dir", tt3d, "--batch", "4", "--n_starts", "2", "--adam_steps", "1",
                   "--lm_steps", "0", "--device", "cpu", "--out", str(tmp_path / "o.json")])
    assert list(out) == ["back", "back_no_noise"] and out["back"]["n_traj"] == 4
    assert np.isfinite(out["back"]["err3d_cm_mean"]) and os.path.isfile(tmp_path / "o.json")
    assert "[tt3d-fit] back:" in capsys.readouterr().out
