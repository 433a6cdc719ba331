"""BlurBall pretraining in the port against the JAX package: the readers and the trainer.

* the ball and table indices on a synthetic BlurBall tree (train videos 1 and 2, holdout
  videos 3 and 6; sequences without a CSV, frames without an annotation, invisible
  frames, a video without a calibration), for train / val / test and with and without
  invisible samples: equal to JAX's element by element (paths, centre, streak, visibility,
  keypoints), so the holdout, the RandomState(0) shuffle and the halving are JAX's;
* the batches (PNGs decoded by `data/png.py` against cv2): frames equal, coordinates
  and keypoints within 1e-6 (TOL); `blur_streak_endpoints` and `blurball_table_keypoints`
  within 1e-6;
* the CLI with `--device cpu`: `--data blurball` for the ball (2 steps and a validation)
  and the table (1 step, its validation made to win so that it saves), the ball's best
  checkpoint at `pretraining_blurball/<model>/model.pt`, untouched by the table's save,
  and `--data tthq --pretraining` loading it, every tensor (`[init] ... loaded n/n`); a
  checkpoint of the other task refused; the TensorBoard run with the validation overlay
  (`overlay_image`, 800x450).
"""
import glob

import numpy as np
import pytest
import torch

import chip_smoke
from upliftingtabletennis_tpu.data import detection as JD
from upliftingtabletennis_torch.data import detection as D
from upliftingtabletennis_torch.data.png import write_png
from upliftingtabletennis_torch.train import run_detection as T

TOL = 1e-6
H, W = 24, 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bb")
    bb = root / "blurball"
    ann = bb / "all_csv_annotations"
    calib = bb / "all_calib_files"
    ann.mkdir(parents=True)
    calib.mkdir()
    rng = np.random.default_rng(0)
    # (video, sequence, frames, annotated, invisible, csv)
    layout = [(1, 0, range(0, 9), None, {3}, True), (1, 1, range(4, 12), {4, 5, 6, 8, 9, 10, 11},
              set(), True), (1, 2, range(0, 5), None, set(), False),
              (2, 0, range(0, 12), None, {0, 7}, True), (3, 0, range(0, 14), None, {5}, True),
              (6, 3, range(2, 12), None, set(), True), (6, 7, range(0, 6), None, {2}, True)]
    for vid, seq, frames, annotated, invisible, has_csv in layout:
        d = bb / f"{vid:02d}" / "frames" / f"{seq:03d}"
        d.mkdir(parents=True)
        rows = ["Frame,X,Y,l,theta,Visibility"]
        for f in frames:
            write_png(str(d / f"{f:05d}.png"), rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
            if annotated is None or f in annotated:
                rows.append(f"{f},{rng.uniform(0, W):.2f},{rng.uniform(0, H):.2f},"
                            f"{rng.uniform(0, 9):.3f},{rng.uniform(-180, 180):.2f},"
                            f"{0 if f in invisible else int(rng.integers(1, 4))}")
        if has_csv:
            (ann / f"{vid:02d}_csv_{seq:03d}.csv").write_text("\n".join(rows))
    for vid in (1, 3, 6):  # video 2 has no calibration: no table samples
        (calib / f"{vid:02d}_table_pose.yaml").write_text(
            f"rvec: [{1.1 + 0.1 * vid}, 0.05, -0.02]\ntvec: [0.1, 0.5, {4 + vid / 2}]\nf: 40.0\n")
    return str(root)


def _same_ball(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.paths == w.paths and g.visibility == w.visibility
        assert abs(g.coords[0] - w.coords[0]) <= TOL and abs(g.coords[1] - w.coords[1]) <= TOL
        assert abs(g.blur_len - w.blur_len) <= TOL
        assert abs(g.blur_theta_deg - w.blur_theta_deg) <= TOL


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("use_invisible", [True, False], ids=["invisible", "visible_only"])
def test_ball_index_matches_jax(tree, mode, use_invisible):
    _same_ball(D.load_blurball_index(tree, mode, use_invisible),
               JD.load_blurball_index(tree, mode, use_invisible))


@pytest.mark.parametrize("in_frames", [3, 1])
def test_ball_batch_matches_jax(tree, in_frames):
    samples = D.load_blurball_index(tree, "train")[:5]
    got = D.load_blurball_ball_batch(tree, samples, in_frames)
    want = JD.load_blurball_ball_batch(tree, JD.load_blurball_index(tree, "train")[:5],
                                       in_frames)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])
    with pytest.raises(ValueError, match="in_frames"):
        D.load_blurball_ball_batch(tree, samples, 2)


def test_blur_streak_endpoints_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        args = ((rng.uniform(-50, 2000), rng.uniform(-50, 1100)), rng.uniform(0, 60),
                rng.uniform(-180, 180), (rng.integers(600, 3000), rng.integers(400, 2000)))
        np.testing.assert_allclose(D.blur_streak_endpoints(*args),
                                   JD.blur_streak_endpoints(*args), atol=TOL, rtol=0)


def test_table_keypoints_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(10):
        cam = {"rvec": list(rng.uniform([0.8, -0.3, -0.3], [1.6, 0.3, 0.3])),
               "tvec": list(rng.uniform([-0.5, 0.0, 3.0], [0.5, 1.0, 9.0])),
               "f": float(rng.uniform(800, 3000))}
        wh = (int(rng.integers(1280, 3841)), int(rng.integers(720, 2161)))
        np.testing.assert_allclose(D.blurball_table_keypoints(cam, wh),
                                   JD.blurball_table_keypoints(cam, wh), atol=TOL, rtol=0)
    assert np.array_equal(D._rodrigues(np.zeros(3)), np.eye(3))


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_table_index_and_batch_match_jax(tree, mode):
    got, want = D.load_blurball_table_index(tree, mode), JD.load_blurball_table_index(tree, mode)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.path == w.path
        np.testing.assert_allclose(g.keypoints, w.keypoints, atol=TOL, rtol=0)
    imgs, kps, vis = D.load_blurball_table_batch(tree, got[:3])
    jimgs, jkps, jvis = JD.load_blurball_table_batch(tree, want[:3])
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_allclose(kps, jkps, atol=TOL, rtol=0)
    np.testing.assert_array_equal(vis, jvis)


def _argv(root, tmp_path, *flags):
    return ["--model", "segformerpp_b0", "--data_root", root, "--batch_size", "4",
            "--val_iterations", "2", "--resolution", "64", "64", "--eval_resolution", "128", "96",
            "--save_dir", str(tmp_path / "ckpt"), "--logdir", str(tmp_path / "runs"),
            "--device", "cpu", *flags]


def test_cli_pretrains_on_blurball_then_hands_off(tmp_path, capsys, monkeypatch):
    bb, tthq = str(tmp_path / "bb"), str(tmp_path / "tthq")
    chip_smoke.tiny_blurball(bb, hw=(96, 128))
    chip_smoke.tiny_tthq(tthq, hw=(96, 128))
    T.main(_argv(bb, tmp_path, "--task", "ball", "--data", "blurball", "--max_steps", "2"))
    pre = tmp_path / "ckpt" / "pretraining_blurball" / "segformerpp_b0" / "model.pt"
    ball_state = torch.load(pre, weights_only=True)
    validate = T.validate  # a table model that learns: its validation beats -1, so it saves
    monkeypatch.setattr(T, "validate", lambda *a, **k: {**validate(*a, **k), "pck5": 1.0})
    T.main(_argv(bb, tmp_path, "--task", "table", "--data", "blurball", "--max_steps", "1"))
    monkeypatch.undo()
    assert glob.glob(str(tmp_path / "ckpt" / "ball_segformerpp_b0_*" / "model.pt"))
    assert glob.glob(str(tmp_path / "ckpt" / "table_segformerpp_b0_*" / "model.pt"))
    kept = torch.load(pre, weights_only=True)  # the table's save left the ball's copy alone
    assert kept.keys() == ball_state.keys() and all(torch.equal(kept[k], v)
                                                    for k, v in ball_state.items())
    out = capsys.readouterr().out
    assert "[data] blurball: 8 train / 4 val samples" in out
    assert "[data] blurball: 10 train / 1 val samples" in out
    T.main(_argv(tthq, tmp_path, "--task", "ball", "--pretraining", "--max_steps", "1",
                 "--batch_size", "2"))
    n = len(T.get_detector("segformerpp_b0", "ball")[0].state_dict())
    assert f"[init] warm-started from {pre}: loaded {n}/{n} tensors" in capsys.readouterr().out
    runs = glob.glob(str(tmp_path / "runs" / "ball_segformerpp_b0_*" / "events.out.tfevents*"))
    assert runs  # TensorBoard imports here: the run has its events file


def test_warm_start_refuses_a_checkpoint_that_does_not_fit(tmp_path):
    table, _ = T.get_detector("segformerpp_b0", "table", kernels=False)
    ckpt = str(tmp_path / "table.pt")
    T.save_checkpoint(ckpt, table.state_dict(), "table", {})
    tthq = str(tmp_path / "tthq")
    chip_smoke.tiny_tthq(tthq, hw=(96, 128))
    with pytest.raises(ValueError, match=r"does not fit ball/segformerpp_b0: loaded \d+/\d+"):
        T.main(_argv(tthq, tmp_path, "--task", "ball", "--init_checkpoint", ckpt,
                     "--max_steps", "1", "--batch_size", "2"))
    assert not (tmp_path / "ckpt").exists()


def test_overlay_image_shows_the_heatmap_and_the_truth():
    model, _ = T.get_detector("segformerpp_b0", "ball", kernels=False)
    T.init_weights(model, 0)
    model.eval()
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.uniform(0, 255, (2, 90, 160, 9)).astype(np.float32))
    coords = torch.tensor([[[80.0, 45.0]] * 3] * 2)
    img = T.overlay_image(model, images, coords, torch.ones(2, 3), (64, 64))
    assert img.shape == (450, 800, 3) and img.dtype == np.uint8
    lime = (img[..., 0] == 0) & (img[..., 1] == 255) & (img[..., 2] == 0)
    ys, xs = np.nonzero(lime)
    assert lime.sum() > 10 and abs(xs.mean() - 400) < 8 and abs(ys.mean() - 225) < 8
