"""The dataset readers and extractors of the port against the JAX package, on the same files.

* `data/video.py`: a tiny mp4 written with cv2 (as tests/test_video.py writes one): RGB
  and I420 frames, `video_info` and the chunks equal JAX's;
* `data/rally_dataset.py`: tests/test_rally_and_qa.py's TTHQ tree (one rally kept of
  five): the rallies, their frames and `dataset_statistics` equal JAX's;
* `data/extract_tthq.py`: the event state machine, the keypoint tables and the CSVs
  written equal JAX's, from a DataFrame and from `read_csv_columns`; `regress_cameras`
  in float64 from JAX's draws of PRNGKey(frame) against JAX's calibration in float64
  (focal within 0.1 px, extrinsics within 1e-3: CAM_TOL), and in f32 with its own draws
  judged by outcome (every point within 2 px of the truth, at least 6 inliers);
* `data/extract_ttst.py`: a two-event raw layout (`chip_smoke.raw_ttst`): the trajectories,
  timestamps, bounces, spin classes and frames equal JAX's; each event's median keypoints
  equal what JAX hands its calibration, whose float64 result from JAX's draws of
  PRNGKey(event) the port's matches (CAM_TOL); f32 judged by outcome; the dataset
  written and the CLI;
* `data/annotation_qa.py`: tests/test_rally_and_qa.py's swap case: the flagged pairs equal
  JAX's, the fix restores the annotation, `camera_statistics` within 1e-4 of JAX's, and
  the numpy render marks the swapped pair in red and writes its PNG.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from upliftingtabletennis_tpu.core import calibration as JC
from upliftingtabletennis_tpu.core.geometry import TABLE_POINTS
from upliftingtabletennis_tpu.data import annotation_qa as JQA
from upliftingtabletennis_tpu.data import extract_tthq as JX
from upliftingtabletennis_tpu.data import extract_ttst as JT
from upliftingtabletennis_tpu.data import rally_dataset as JR
from upliftingtabletennis_tpu.data import video as JV
from upliftingtabletennis_torch.core import calibration as C
from upliftingtabletennis_torch.core.geometry import get_Mext
from upliftingtabletennis_torch.data import annotation_qa as QA
from upliftingtabletennis_torch.data import extract_tthq as X
from upliftingtabletennis_torch.data import extract_ttst as XT
from upliftingtabletennis_torch.data import rally_dataset as R
from upliftingtabletennis_torch.data import video as V

torch.set_num_threads(2)
CAM_TOL = (0.1, 1e-3)  # focal / principal point px, extrinsics
PX_TOL = 2.0
W, H = 640, 360


def _camera():
    """tests/test_extract_ttst.py's camera: 8 m down the x axis, 2 m up, f 900 px."""
    c = torch.tensor([-8.0, 0.0, 2.0], dtype=torch.float64)
    Mext = get_Mext(c, -c / c.norm(), torch.tensor([0.0, -1.0, 0.0], dtype=torch.float64))
    return np.array([[900.0, 0, W / 2], [0, 900.0, H / 2], [0, 0, 1]]), Mext.numpy()


def jax_draws(seed):
    """The draws JAX's RANSAC calibration makes from PRNGKey(seed) in float64."""
    with jax.enable_x64():
        key = jax.random.PRNGKey(seed)
        u = np.array(jax.vmap(lambda k: jax.random.uniform(k, (13,)))(
            jax.random.split(key, C.RANSAC_ITERS)))
        normal = np.stack([np.asarray(jax.vmap(lambda k: jax.random.normal(k, (8,), jnp.float64))(
            jax.random.split(jax.random.fold_in(key, 1000 + rd), C.POLISH_RESTARTS)))
            for rd in range(C.POLISH_ROUNDS)])
    return torch.from_numpy(u), torch.from_numpy(normal)


def jax_calibrate64(pts, vis, res, seed):
    with jax.enable_x64():
        out = JC.calibrate_camera(jnp.asarray(pts, jnp.float64), jnp.asarray(vis, jnp.float64),
                                  tuple(res), jax.random.PRNGKey(seed), True)
        return tuple(np.asarray(a) for a in out)


def _assert_camera(got, want):
    np.testing.assert_allclose(got[0], want[0], atol=CAM_TOL[0], rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=CAM_TOL[1], rtol=0)
    assert int(got[2]) == int(want[2])


# --- video -------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_video(tmp_path_factory):
    import cv2

    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (96, 64))
    if not wr.isOpened():
        pytest.skip("no mp4 codec in this cv2 build")
    for t in range(10):
        f = np.full((64, 96, 3), 30 + 10 * t, np.uint8)
        f[10:20, 10 + 5 * t:20 + 5 * t] = 220
        wr.write(f)
    wr.release()
    return path


@pytest.mark.parametrize("fmt", ["rgb", "i420"])
def test_video_matches_jax(tiny_video, fmt):
    np.testing.assert_array_equal(V.read_video(tiny_video, 2, 7, fmt),
                                  JV.read_video(tiny_video, 2, 7, fmt))
    assert V.video_info(tiny_video) == JV.video_info(tiny_video)
    for a, b in zip(V.iter_video_chunks(tiny_video, 4, fmt),
                    JV.iter_video_chunks(tiny_video, 4, fmt)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        V.read_video(tiny_video + ".missing")


# --- rally dataset -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tthq(tmp_path_factory):
    """tests/test_rally_and_qa.py's tree, written by the port (frames by data/png.py),
    plus a ttst/ and a syntheticdata/ layout for the statistics."""
    from upliftingtabletennis_torch.data.png import write_png

    root = tmp_path_factory.mktemp("tthq")
    vdir = root / "tthq" / "01"
    vdir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for f in range(30):
        write_png(str(vdir / f"01_{f:06d}.png"), rng.integers(0, 255, (32, 48, 3), dtype=np.uint8))
    trajectories = [(1, 2, 8, 5, 1, "intermediate", True, 50.0),
                    (1, 10, 14, 12, 2, "last", True, 50.0),
                    (1, 16, 20, 18, 0, "intermediate", False, 50.0),
                    (1, 22, 26, 24, 1, "intermediate", True, 50.0),
                    (1, 40, 45, 42, 1, "intermediate", True, 50.0),
                    (2, 2, 8, 5, 1, "intermediate", True, 50.0)]
    X.write_tables(str(root / "tthq"), trajectories, {1: {24: (10.0, 20.0, 2)}}, {1: {}})
    for i in range(3):
        (root / "ttst" / f"trajectory_{i:04d}").mkdir(parents=True)
    (root / "syntheticdata" / "intermediate" / "left_to_right" / "trajectory_0000").mkdir(
        parents=True)
    return str(root)


def test_rallies_frames_and_statistics_match_jax(tthq):
    got, want = R.load_tthq_rallies(tthq), JR.load_tthq_rallies(tthq)
    assert got == want and len(got) == 1 and got[0].frames[0] == (3, 2, 4)
    for a, b in zip(R.load_rally_frames(tthq, got[0]), JR.load_rally_frames(tthq, want[0])):
        np.testing.assert_array_equal(a, b)
    stats = R.dataset_statistics(tthq)
    assert stats == JR.dataset_statistics(tthq)
    assert stats["tthq_test_rallies"] == 1 and stats["ttst_trajectories"] == 3


# --- TTHQ extraction -------------------------------------------------------------------------
EVENTS = [(10, "Begin"), (12, "Frontspin"), (20, "Bounce"), (30, "Hit"), (35, "Backspin"),
          (40, "Bounce"), (41, "Bounce"), (50, "Hit"), (55, "Netz"), (60, "Bounce"),
          (70, "End"), (80, "Hit"), (81, "Hit"), (90, "Bounce"), (100, "Hit"), (110, "End")]


def test_trajectories_match_jax(tmp_path):
    df = pd.DataFrame({"frame": [r[0] for r in EVENTS], "event": [r[1] for r in EVENTS]})
    want = JX.load_trajectories(df, "vid", 50.0)
    assert X.load_trajectories(df, "vid", 50.0) == want
    (tmp_path / "ev.csv").write_text("frame;event\n" + "\n".join(f"{f};{e}" for f, e in EVENTS))
    cols = XT.read_csv_columns(str(tmp_path / "ev.csv"))
    assert cols["frame"].dtype == np.int64
    assert X.load_trajectories(cols, "vid", 50.0) == want


def _keypoints_frame(Mint, Mext, frames=(1, 2, 3)):
    px = chip_smoke.project_np(Mint, Mext, np.asarray(TABLE_POINTS, np.float64))
    rng = np.random.default_rng(1)
    cols = {"frame": list(frames), "ball center_x": [100.0, 110.0, 120.0][:len(frames)],
            "ball center_y": [200.0, 210.0, 220.0][:len(frames)],
            "ball center_flag": [2, 0, 1][:len(frames)]}
    for k in range(1, 14):
        noise = rng.normal(0, 0.5, (len(frames), 2))
        cols[f"{k:02d}_x"] = list(px[k - 1, 0] + noise[:, 0])
        cols[f"{k:02d}_y"] = list(px[k - 1, 1] + noise[:, 1])
        cols[f"{k:02d}_flag"] = [2, 2, 0 if k == 5 else 2][:len(frames)]
    return pd.DataFrame(cols), px


def test_keypoint_tables_and_csvs_match_jax(tmp_path):
    df, _ = _keypoints_frame(*_camera())
    df.to_csv(tmp_path / "kp.csv", sep=";", index=False)
    cols = XT.read_csv_columns(str(tmp_path / "kp.csv"))
    for src in (df, cols):
        balls, tables = X.load_ball_keypoints(src, "vid"), X.load_table_keypoints(src)
        assert balls == JX.load_ball_keypoints(df, "vid")
        assert tables == JX.load_table_keypoints(df) and set(tables) == {1, 2}
    traj = JX.load_trajectories(pd.DataFrame({"frame": [r[0] for r in EVENTS],
                                              "event": [r[1] for r in EVENTS]}), "vid", 50.0)
    cams = {"vid": {1: (np.eye(3), np.eye(4), 9)}}
    X.write_tables(str(tmp_path / "port"), traj, {"vid": balls}, {"vid": tables}, cams)
    JX.write_tables(str(tmp_path / "jax"), traj, {"vid": balls}, {"vid": tables}, cams)
    for name in ("trajectories", "ball_detection", "table_detection", "camera_matrices"):
        assert ((tmp_path / "port" / f"{name}.csv").read_text()
                == (tmp_path / "jax" / f"{name}.csv").read_text())


def test_regress_cameras_match_jax_in_float64():
    Mint, Mext = _camera()
    df, _ = _keypoints_frame(Mint, Mext, frames=(4, 9))
    tables = X.load_table_keypoints(df)
    got = X.regress_cameras(tables, (W, H), device="cpu", dtype=torch.float64,
                            draws={f: jax_draws(int(f)) for f in tables})
    assert sorted(got) == [4, 9]
    for frame, pts in tables.items():
        arr = np.asarray(pts, np.float64)
        want = jax_calibrate64(arr[:, :2].astype(np.float32), (arr[:, 2] == 2), (W, H),
                               int(frame))
        _assert_camera(got[frame], want)


def test_regress_cameras_in_f32_by_outcome():
    Mint, Mext = _camera()
    df, px = _keypoints_frame(Mint, Mext)
    got = X.regress_cameras(X.load_table_keypoints(df), (W, H), device="cpu")
    assert sorted(got) == [1, 2]  # frame 3 misses a point
    for Mi, Me, n in got.values():
        proj = chip_smoke.project_np(Mi, Me, np.asarray(TABLE_POINTS, np.float64))
        assert np.linalg.norm(proj - px, axis=1).max() < PX_TOL and n >= 6


# --- TTST extraction -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("ttst_raw")
    Mint, Mext = _camera()
    px = chip_smoke.raw_ttst(str(root), Mint, Mext)
    return str(root), px


def test_transform_annotations_match_jax(raw, monkeypatch):
    root, px = raw
    handed = []

    def record(pts, vis, res, key, use_ransac):  # what JAX hands its calibration
        handed.append((np.asarray(pts), np.asarray(vis)))
        return np.eye(3), np.eye(4), 13

    monkeypatch.setattr(JC, "calibrate_camera", record)
    want = JT.transform_annotations(root, ("01",), (W, H))
    monkeypatch.undo()
    got = XT.transform_annotations(root, ("01",), (W, H), device="cpu", dtype=torch.float64,
                                   draws=[jax_draws(i) for i in range(len(handed))])
    assert got[5] == want[5] == [1, 2] and got[6] == want[6]
    for a, b in zip(got[0] + got[1] + got[4], want[0] + want[1] + want[4]):
        np.testing.assert_array_equal(a, b)
    events, _ = XT.parse_events(XT.read_csv_columns(os.path.join(root, "01_events.csv"), header=1))
    keypoints = XT.read_csv_columns(os.path.join(root, "01_keypoints.csv"), header=1)
    for i, ((begin, _, end), (pts, vis)) in enumerate(zip(events, handed)):
        mine = XT.event_keypoints(XT.parse_table_keypoints(keypoints, begin, end))
        np.testing.assert_array_equal(mine[0], pts)
        np.testing.assert_array_equal(mine[1], vis)
        _assert_camera((got[2][i], got[3][i], 13), jax_calibrate64(pts, vis, (W, H), i))


def test_transform_annotations_f32_by_outcome_and_dataset(raw, tmp_path):
    root, px = raw
    _, _, Mints, Mexts, *_ = XT.transform_annotations(root, ("01",), (W, H), device="cpu")
    for Mi, Me in zip(Mints, Mexts):
        proj = chip_smoke.project_np(Mi, Me, np.asarray(TABLE_POINTS, np.float64))
        assert np.linalg.norm(proj - px, axis=1).max() < PX_TOL
    n = XT.main(["--data_path", root, "--save_path", str(tmp_path / "ttst"), "--videos", "01",
                 "--resolution", str(W), str(H), "--no_frames", "--device", "cpu"])
    assert n == 2
    files = set(os.listdir(tmp_path / "ttst" / "trajectory_0001"))
    assert {"r_img.npy", "times.npy", "Mint.npy", "Mext.npy", "hits.npy",
            "spin_class.npy"} <= files
    assert int(np.load(tmp_path / "ttst" / "trajectory_0001" / "spin_class.npy")) == 2
    with pytest.raises(ValueError, match="need >= 6"):
        XT.regress_event_camera({1: [(10.0, 10.0)], 2: [(20.0, 20.0)]}, (W, H), device="cpu")


def test_read_csv_columns_types_as_pandas(tmp_path):
    (tmp_path / "t.csv").write_text("skip\na;b;c;d\n1;2.5;x;\n3;;y;4\n\n")
    cols = XT.read_csv_columns(str(tmp_path / "t.csv"), header=1)
    want = pd.read_csv(tmp_path / "t.csv", sep=";", header=1)
    assert list(cols) == list(want.columns)
    for k in cols:
        assert cols[k].dtype.kind == want[k].dtype.kind, k
        np.testing.assert_array_equal(cols[k], want[k].to_numpy())


# --- annotation QA ---------------------------------------------------------------------------
def _swap_case():
    c = np.array([1.0, 9.0, 5.0])
    f = (np.array([0.0, 0.0, 0.76]) - c) / np.linalg.norm(np.array([0.0, 0.0, 0.76]) - c)
    r = np.cross(f, [0, 0, 1.0])
    Mext = get_Mext(*(torch.from_numpy(v) for v in (c, f, r / np.linalg.norm(r)))).numpy()
    Mint = np.array([[2710.0, 0, 1280], [0, 2907.0, 720], [0, 0, 1]])
    px = chip_smoke.project_np(Mint, Mext, np.asarray(TABLE_POINTS, np.float64))
    return np.concatenate([px, np.ones((13, 1))], -1).astype(np.float32), Mint, Mext, c


def test_swap_detection_and_statistics_match_jax():
    kps, Mint, Mext, c = _swap_case()
    bad = kps.copy()
    a, b = QA.LEFT_RIGHT_PAIRS[0]
    bad[[a, b], :2] = bad[[b, a], :2]
    for k in (kps, bad):
        got, want = QA.detect_left_right_swaps(k, (2560, 1440), device="cpu"), \
            JQA.detect_left_right_swaps(k, (2560, 1440))
        assert got[0] == want[0]
    assert got[0] and 0 in got[0]
    fixed, n = QA.fix_left_right_swaps(bad, (2560, 1440), device="cpu")
    assert n >= 1
    np.testing.assert_allclose(fixed[:, :2], kps[:, :2], atol=1e-4)
    got, want = QA.camera_statistics([(Mint, Mext)]), JQA.camera_statistics([(Mint, Mext)])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0)
    assert abs(got["distance"][0] - np.linalg.norm(c)) < 1e-3


def test_render_annotation_check_marks_the_swap(tmp_path):
    from upliftingtabletennis_torch.data.png import read_png

    Mint, Mext = _camera()
    px = chip_smoke.project_np(Mint, Mext, np.asarray(TABLE_POINTS, np.float64))
    kps = np.concatenate([px, np.ones((13, 1))], -1).astype(np.float32)
    kps[[0, 1]] = kps[[1, 0]]
    out = str(tmp_path / "check.png")
    img = QA.render_annotation_check(np.zeros((H, W, 3), np.uint8), kps, (W, H), out_path=out,
                                     device="cpu")
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(read_png(out), img)
    red = (img[..., 0] == 255) & (img[..., 1] == 0) & (img[..., 2] == 0)
    ys, xs = np.nonzero(red)
    near = [np.hypot(xs - x, ys - y).min() for x, y in kps[[0, 1], :2]]
    assert red.sum() > 20 and max(near) < 5
    assert ((img[..., 0] == 255) & (img[..., 1] == 165)).sum() > 0  # the reprojected table
