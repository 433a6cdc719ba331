"""The port's smaller modules of the last slice against the JAX package.

* `utils/visualization.py`: `roc_curve_points`, `roc_auc` and `count_missortings` equal
  JAX's (ties, one class, perfect separation); the numpy figures have the JAX figures'
  shapes (matplotlib there) and their content (the confusion cells shaded by count, the
  ROC curve's corner for a perfect classifier, the heatmap's peak in red, the truth as a
  lime cross);
* `utils/pose_viz.py`: the skeletons and the palettes equal JAX's (`_palette` samples
  matplotlib), the points equal JAX's cv2 drawing pixel for pixel and the limbs within
  1% of the drawn pixels (LIMB_SHARE), `pad_image` equal;
* `utils/smoothing.py`: `OneEuroFilter` equal to JAX's, `one_euro_trajectory` within 1e-6
  (TOL) of JAX's `lax.scan` form;
* `paths.py`: the environment variables and the defaults under the working directory;
* `tools/extract_model_from_latest.py`: a `latest` snapshot's EMA weights written as a
  `model` checkpoint that `hub.uplifting` loads;
* the uplifting trainer's TensorBoard run: the confusion figures and, with TTST, the ROC
  figure and the missortings.
"""
import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from upliftingtabletennis_tpu.utils import pose_viz as JPV
from upliftingtabletennis_tpu.utils import smoothing as JS
from upliftingtabletennis_tpu.utils import visualization as JV
from upliftingtabletennis_torch.utils import pose_viz as PV
from upliftingtabletennis_torch.utils import smoothing as S
from upliftingtabletennis_torch.utils import visualization as V

TOL = 1e-6
LIMB_SHARE = 0.01


def _scores(seed, n=60, ties=True):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    scores = rng.normal(labels * 0.8, 1.0, n)
    if ties:
        scores = np.round(scores, 1)
    return labels, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roc_and_missortings_equal_jax(seed):
    labels, scores = _scores(seed, ties=seed != 2)
    for got, want in zip(V.roc_curve_points(labels, scores), JV.roc_curve_points(labels, scores)):
        np.testing.assert_array_equal(got, want)
    assert V.roc_auc(labels, scores) == JV.roc_auc(labels, scores)
    assert V.count_missortings(labels, scores) == JV.count_missortings(labels, scores)
    one = np.ones(5, int)
    assert V.roc_auc(one, scores[:5]) == JV.roc_auc(one, scores[:5])
    sep = np.array([0, 0, 1, 1])
    assert V.count_missortings(sep, [-2.0, -1.0, 1.0, 2.0]) == (0, 1.0)


def test_figures_have_the_jax_shapes_and_their_content():
    labels, scores = _scores(0)
    cm = V.confusion_matrix_image(40, 5, 10, 0, title="omega_x sign")
    assert cm.shape == JV.confusion_matrix_image(40, 5, 10, 0).shape
    # the cells: tp (largest) darkest, fn (zero) lightest
    tp, fn = cm[40 + 10, 50 + 10], cm[40 + 10, 130 + 10]
    assert tp.sum() < cm[120 + 10, 50 + 10].sum() < fn.sum() and tuple(fn) == (247, 251, 255)
    roc = V.roc_curve_image(labels, scores)
    assert roc.shape == JV.roc_curve_image(labels, scores).shape
    perfect = V.roc_curve_image([0, 0, 1, 1], [0.1, 0.2, 0.8, 0.9], show_thresholds=True)
    blue = (perfect[..., 0] == 0) & (perfect[..., 1] == 0) & (perfect[..., 2] == 255)
    assert blue[20, 50:480].mean() > 0.9  # tpr 1 along the top
    heat = np.zeros((2, 18, 32))
    heat[1, 9, 8] = 5.0
    img = np.full((90, 160, 3), 128, np.uint8)
    gt = np.array([[40.0, 45.0, 1.0], [0.0, 0.0, 0.0]])
    ov = V.heatmap_overlay_image(img, heat, gt_coords=gt, pred_coords=gt[:1])
    assert ov.shape == JV.heatmap_overlay_image(img, heat, gt_coords=gt).shape
    assert ov[225, 200, 0] > ov[225, 200, 1] + 50  # the peak at (8, 9) of 32x18, tinted red
    assert ov[10, 600].tolist() == [185, 185, 185]  # 0.55 grey + 0.45 of the ramp's white


def test_pose_palettes_skeletons_and_drawing_match_jax():
    assert PV.joints_dict() == JPV.joints_dict()
    for name, samples in (("tab20", 16), ("tab10", 10), ("Set1", 9), ("Set2", 8)):
        assert PV._palette(name, samples) == JPV._palette(name, samples)
    rng = np.random.default_rng(0)
    drawn = differ = 0
    for k in range(8):
        H, W = int(rng.integers(100, 300)), int(rng.integers(100, 400))
        pts = np.stack([rng.uniform(0, H, 17), rng.uniform(0, W, 17), rng.uniform(0, 1, 17)], 1)
        sk = JPV.joints_dict()["coco"]["skeleton"]
        np.testing.assert_array_equal(PV.draw_points(np.zeros((H, W, 3), np.uint8), pts),
                                      JPV.draw_points(np.zeros((H, W, 3), np.uint8), pts))
        got = PV.draw_points_and_skeleton(np.zeros((H, W, 3), np.uint8), pts, sk, person_index=k)
        want = JPV.draw_points_and_skeleton(np.zeros((H, W, 3), np.uint8), pts, sk,
                                            person_index=k)
        drawn += int(want.any(-1).sum())
        differ += int((got != want).any(-1).sum())
    assert differ <= LIMB_SHARE * drawn, (differ, drawn)
    img = rng.integers(0, 255, (30, 50, 3), dtype=np.uint8)
    for ratio in (16 / 9, 1.0, 0.5):
        got, want = PV.pad_image(img, ratio), JPV.pad_image(img, ratio)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    with pytest.raises(KeyError, match="palette"):
        PV.draw_points(img, np.array([[1.0, 1.0, 1.0]]), color_palette="viridis")


def test_smoothing_matches_jax():
    rng = np.random.default_rng(0)
    T = 40
    times = np.cumsum(rng.uniform(0.015, 0.025, T)).astype(np.float32)
    xs = (np.cumsum(rng.normal(0, 3, (T, 17, 2)), 0) + 500).astype(np.float32)
    got = S.one_euro_trajectory(torch.from_numpy(times), torch.from_numpy(xs))
    want = np.asarray(JS.one_euro_trajectory(times, xs))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    f, jf = S.OneEuroFilter(0.0, xs[0]), JS.OneEuroFilter(0.0, xs[0])
    for t, x in zip(times[1:], xs[1:]):
        np.testing.assert_array_equal(f(float(t), x), jf(float(t), x))


def test_paths_follow_the_environment(monkeypatch, tmp_path):
    import upliftingtabletennis_torch.paths as P

    monkeypatch.chdir(tmp_path)
    for var in ("UTT_DATA_PATH", "UTT_LOGS_PATH", "UTT_WEIGHTS_PATH"):
        monkeypatch.delenv(var, raising=False)
    P = importlib.reload(P)
    assert (P.data_path, P.logs_path, P.weights_path) == tuple(
        str(tmp_path / d) for d in ("data", "runs", "weights"))
    monkeypatch.setenv("UTT_WEIGHTS_PATH", "/w")
    assert importlib.reload(P).weights_path == "/w"
    monkeypatch.undo()
    importlib.reload(P)


def test_extract_model_from_latest_round_trips(tmp_path):
    from upliftingtabletennis_torch import hub
    from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
    from upliftingtabletennis_torch.tools import extract_model_from_latest as E
    from upliftingtabletennis_torch.train.run_uplifting import state_dict_of
    from upliftingtabletennis_torch.train.uplifting_train import init_train_state
    from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    model = get_uplifting_model("connectstage", "small", "dynamic", "new")
    state = init_train_state(model)
    with torch.no_grad():
        for e in state.ema:
            e.add_(0.25)
    state.step[0] = 7
    info = {"epoch": 3, "best": {"spin": 0.5}, "name": "connectstage", "size": "small",
            "tabletoken_mode": "dynamic", "time_rotation": "new", "transform_mode": "local"}
    save_checkpoint(str(tmp_path / "latest"), state_dict_of(model, state), "run", info)
    E.main(["--latest", str(tmp_path / "latest"), "--out", str(tmp_path / "model_backview")])
    _, ident, out_info = load_checkpoint(str(tmp_path / "model_backview"))
    assert ident == "run" and out_info["from_latest"] and "best" not in out_info
    up = hub.uplifting(checkpoint=str(tmp_path / "model_backview"), device="cpu")
    assert up.transform_mode == "local"
    for (n, p), e in zip(up.model.named_parameters(), state.ema):
        assert torch.equal(p, e), n


def test_uplifting_trainer_draws_its_figures_to_tensorboard(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from upliftingtabletennis_torch.data import extract_ttst as XT
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.train import run_uplifting
    from uplift_data import analytic_datagen

    SYN.save_store_npz(str(tmp_path / "data" / "intermediate" / "left_to_right.npz"),
                       SYN.store_from_datagen(analytic_datagen(30, seed=4)))
    Mint = np.array([[2000.0, 0, 1280], [0, 2000.0, 720], [0, 0, 1]])
    Mext = np.array([[0, -1, 0, 0], [-0.2, 0, -0.98, 1.6], [0.98, 0, -0.2, 9.0], [0, 0, 0, 1.0]])
    chip_smoke.raw_ttst(str(tmp_path), Mint, Mext)
    r_imgs, times, _, _, bounces, _, _ = XT.transform_annotations(str(tmp_path), ("01",),
                                                                  device="cpu")
    for i in range(12):  # both classes in the val split (its first third)
        d = tmp_path / "ttst" / f"trajectory_{i:04d}"
        d.mkdir(parents=True)
        for name, v in (("r_img", r_imgs[i % 2]), ("times", times[i % 2]), ("Mint", Mint),
                        ("Mext", Mext), ("hits", bounces[i % 2]), ("spin_class", 1 + i % 2)):
            np.save(d / f"{name}.npy", v)
    res = run_uplifting.main(["--data_dir", str(tmp_path / "data"), "--ttst_dir",
                              str(tmp_path / "ttst"), "--model_size", "small", "--batch_size",
                              "8", "--num_epochs", "1", "--device", "cpu", "--save_dir",
                              str(tmp_path / "ckpt"), "--logdir", str(tmp_path / "runs")])
    acc = EventAccumulator(res["log_dir"]).Reload()
    images = acc.Tags()["images"]
    assert {"val/confusion x", "val/confusion y", "val/confusion z", "val real/roc"} <= set(images)
    assert {"val real/missortings", "train/loss", "val/metric"} <= set(acc.Tags()["scalars"])
