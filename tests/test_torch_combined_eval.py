"""The port's `eval/run_combined_eval.py` against the JAX package's.

* The protocols' numbers from the same pipeline output: each package's `evaluate_rally`
  (TTHQ) and `evaluate_rally_ttst` (TTST) on a stub pipeline whose `run_rally` returns one
  fixed output and whose `calibrate_camera` is each package's calibration in float64 from
  JAX's draws of PRNGKey(42) (`_calibrations`: in float32 the calibration is chaotic, so
  two float32 implementations part), on keypoints projected through a known camera with
  1 px noise. The TTST annotations are at 2560x1440 (rescaled by both to 1920x1080).
  Tolerance: 1e-3 relative (float64 cameras, the same f32 projections), NaN where JAX has
  NaN.
* End to end on the JAX tests' tiny pipeline (tests/test_combined_eval.py: WASB and the
  table HRNet at 96x64, chunk 4, connectstage small), JAX's seeded weights carried across
  (tests/test_torch_rally.py's fixture: the ball's aux detector is its main one, so the
  ball filter keeps the rally and the uplifting model runs): spin and pos3d within
  tests/test_torch_rally.py's 1e-3 of their max; TTST's numbers within 1e-2 relative
  (the table keypoints agree within 0.2 px there). TTHQ's two reprojection errors go
  through the calibration of the random-weight table keypoints, which differ by up to
  0.2 px between the packages: even in float64 from the same draws that calibration lands
  elsewhere (396 px against 305 px on this rally), so they are held by their NaN pattern
  here and by their values in the test above.
* `SpinCounts` equal to JAX's; `visualize_rally` and `render_rally_3d` draw their PNGs
  (the port's own drawing: their content is checked, not JAX's matplotlib pixels); the
  CLI on a TTHQ and a TTST layout of PNG rallies, with the tiny pipeline patched in.
"""
import json

import jax
import numpy as np
import pytest
import torch

from make_calib_tail_witness import jax_draws
from test_torch_rally import UPLIFT_RTOL, _frames, pipelines  # noqa: F401 (a fixture)
from upliftingtabletennis_tpu.eval import run_combined_eval as JCE
from upliftingtabletennis_torch.core import calibration as C
from upliftingtabletennis_torch.core.geometry import TABLE_POINTS, get_Mext, world2img
from upliftingtabletennis_torch.data.png import read_png, write_png
from upliftingtabletennis_torch.eval import run_combined_eval as CE
from upliftingtabletennis_torch.pipeline import interface

PROTO_RTOL, E2E_RTOL = 1e-3, 1e-2


def _calibrations():
    """(JAX's calibrate_camera, the port's) of (keypoints (13, 3), resolution) in float64,
    the port fed JAX's float64 draws of PRNGKey(42). In float32 the calibration of 13
    near-planar keypoints is chaotic (ROADMAP, found in the reference, PR 12), so the two
    packages compare their protocols on float64 cameras from the same draws."""
    import jax.numpy as jnp

    from upliftingtabletennis_tpu.core import calibration as JC

    u, normal = (torch.from_numpy(a) for a in jax_draws(np.float64))

    def jax_calib(kp, res):
        with jax.enable_x64():
            K, E, n = JC.calibrate_camera(jnp.asarray(kp[:, :2], jnp.float64),
                                          jnp.asarray(kp[:, 2], jnp.float64), tuple(res),
                                          jax.random.PRNGKey(42), True)
            return np.asarray(K), np.asarray(E), int(n)

    def port_calib(kp, res):
        K, E, n = C.calibrate_camera(torch.as_tensor(kp[:, :2], dtype=torch.float64),
                                     torch.as_tensor(kp[:, 2], dtype=torch.float64),
                                     tuple(res), True, ransac_u=u, polish_normal=normal)
        return K.numpy(), E.numpy(), int(n)

    return jax_calib, port_calib


def _camera(res=(1920, 1080)):
    c, look = np.array([1.5, 9.0, 4.5]), np.array([0.1, -0.1, 0.76])
    f = (look - c) / np.linalg.norm(look - c)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r = r / np.linalg.norm(r)
    Mext = get_Mext(*(torch.from_numpy(v) for v in (c, f, r))).numpy()
    Mint = np.array([[2000.0, 0, res[0] // 2], [0, 2100.0, res[1] // 2], [0, 0, 1.0]])
    return Mint, Mext


def _project(Mint, Mext, pts):
    return world2img(*(torch.as_tensor(a, dtype=torch.float64)
                       for a in (pts, Mext, Mint))).numpy()


class _Stub:
    """A pipeline whose run_rally returns `out`; calibrate_camera is `calibrate`."""

    def __init__(self, out, calibrate):
        self.out, self.calibrate_camera = out, calibrate

    def run_rally(self, frames, fps):
        return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in self.out.items()}


@pytest.fixture(scope="module")
def fixed_output():
    """A run_rally output of a flight seen through _camera at 1920x1080, 1 px noise, and
    its TTST annotations at 2560x1440."""
    rng = np.random.default_rng(0)
    Mint, Mext = _camera()
    t = np.arange(20) / 50.0
    pos3d = np.stack([-1.2 + 5 * t, 0.1 + 0.2 * t, 1.1 + 1.0 * t - 4.9 * t ** 2], -1)
    ball = _project(Mint, Mext, pos3d) + rng.normal(0, 1, (20, 2))
    table = np.concatenate([_project(Mint, Mext, TABLE_POINTS) + rng.normal(0, 1, (13, 2)),
                            np.ones((13, 1))], -1)
    table[4, 2] = 0.0
    out = {"ball": ball, "valid_idx": np.arange(20) + 2, "times": t, "table": table,
           "spin": np.array([3.0, -40.0, 5.0]), "pos3d": pos3d + rng.normal(0, 0.01, (20, 3))}
    s = np.array([2560 / 1920, 1440 / 1080])
    Mint_src = Mint.copy()
    Mint_src[0, 0], Mint_src[1, 1] = Mint[0, 0] * s[0], Mint[1, 1] * s[1]
    Mint_src[:2, 2] = (Mint[:2, 2] + 0.5) * s - 0.5
    ann = {"r_img": (_project(Mint, Mext, pos3d)[1:] + rng.normal(0, 0.5, (19, 2))) * s,
           "times": t[1:], "Mint": Mint_src, "Mext": Mext, "spin_class": 2,
           "table_img": _project(Mint, Mext, TABLE_POINTS) * s}
    return out, ann


def _close(got, want, rtol):
    for k in want:
        if isinstance(want[k], float):
            assert isinstance(got[k], float), k
            if np.isnan(want[k]):
                assert np.isnan(got[k]), k
            else:
                assert got[k] == pytest.approx(want[k], rel=rtol), k


def test_protocols_from_the_same_output_match_jax(fixed_output):
    out, ann = fixed_output
    jax_calib, port_calib = _calibrations()
    jstub = _Stub(out, lambda kp: jax_calib(kp, (1920, 1080)))
    pstub = _Stub(out, lambda kp: port_calib(kp, (1920, 1080)))
    want, got = JCE.evaluate_rally(jstub, None, 50), CE.evaluate_rally(pstub, None, 50)
    assert got["n_ball"] == want["n_ball"] == 20
    assert np.isfinite(want["table_reproj_px"]) and want["table_reproj_px"] < 2.0
    _close(got, want, PROTO_RTOL)
    want, got = (JCE.evaluate_rally_ttst(jstub, None, ann),
                 CE.evaluate_rally_ttst(pstub, None, ann))
    assert all(np.isfinite(want[k]) for k in ("table_px", "ball_detection_px",
                                              "ball_uplifting_px"))
    _close(got, want, PROTO_RTOL)
    # frame_offset moves which annotation each detection meets
    _close(CE.evaluate_rally_ttst(pstub, None, ann, frame_offset=2),
           JCE.evaluate_rally_ttst(jstub, None, ann, frame_offset=2), PROTO_RTOL)


@pytest.mark.parametrize("protocol", ["tthq", "ttst"])
def test_protocols_end_to_end_match_jax(pipelines, protocol):
    jp, pp = pipelines
    frames = _frames()
    if protocol == "tthq":
        want, got = JCE.evaluate_rally(jp, frames, 50), CE.evaluate_rally(pp, frames, 50)
        assert got["n_ball"] == want["n_ball"] == 7
        # the calibration of random-weight keypoints: compared by NaN pattern only (see
        # the module's docstring)
        for k in ("table_reproj_px", "ball_reproj_px"):
            assert np.isnan(got[k]) == np.isnan(want[k]), k
    else:
        Mint, Mext = _camera((2560, 1440))
        rng = np.random.default_rng(5)
        ann = {"r_img": rng.uniform(100, 2000, (7, 2)), "times": np.arange(7) / 50.0,
               "Mint": Mint, "Mext": Mext, "spin_class": 1,
               "table_img": rng.uniform(100, 1400, (13, 2))}
        want, got = (JCE.evaluate_rally_ttst(jp, frames, ann),
                     CE.evaluate_rally_ttst(pp, frames, ann))
        assert all(np.isfinite(want[k]) for k in ("table_px", "ball_detection_px",
                                                  "ball_uplifting_px"))
        _close(got, want, E2E_RTOL)
    for k in ("spin", "pos3d"):
        assert np.abs(got[k] - want[k]).max() <= UPLIFT_RTOL * np.abs(want[k]).max(), k


def test_spin_counts_match_jax():
    rng = np.random.default_rng(1)
    got, want = CE.SpinCounts(), JCE.SpinCounts()
    for _ in range(30):
        spin, cls = rng.normal(size=3), int(rng.integers(0, 3))
        got.update(spin, cls)
        want.update(spin, cls)
    got.update(None, 1)
    want.update(None, 1)
    assert (got.tp, got.tn, got.fp, got.fn) == (want.tp, want.tn, want.fp, want.fn)
    assert got.metrics() == want.metrics()


def _title(path):
    from upliftingtabletennis_torch.data import png

    with open(path, "rb") as f:
        chunks = dict(png._chunks(f.read()))
    return chunks[b"tEXt"].split(b"\0", 1)[1].decode("latin-1")


def test_pictures(pipelines, tmp_path):
    """The port draws the JAX module's pictures without matplotlib: the overlay keeps the
    frame and marks the detected keypoints and ball (lime) and the reprojected track
    (orange), the spin in its title; the 3D view draws the track (orange), the table's
    keypoints (green) and wireframe (black) on white."""
    _, pp = pipelines
    frames = list(_frames())
    out = CE.visualize_rally(pp, frames, 50, str(tmp_path), "t0000", spin_gt=2)
    overlay = read_png(str(tmp_path / "t0000_2d.png"))
    assert overlay.shape == frames[4].shape
    lime = np.all(overlay == CE.LIME, -1)
    marked = lime | np.all(overlay == CE.ORANGE, -1)
    assert lime.any() and (overlay[~marked] == frames[4][~marked]).all()
    # the title in the JAX module's wording
    title = _title(tmp_path / "t0000_2d.png")
    assert title.startswith("Predicted Spin: " + ("Topspin " if out["spin"][1] > 0
                                                  else "Backspin "))
    assert title.endswith("Hz , GT: Backspin")
    view = read_png(str(tmp_path / "t0000_3d.png"))  # the uplifting model ran
    assert view.shape == (800, 800, 3)
    t = np.linspace(0, 1, 30)
    CE.render_rally_3d(np.stack([-1 + 3 * t, 0.3 * np.sin(3 * t), 1.0 - 1.5 * t + 2 * t ** 2],
                                -1), str(tmp_path / "traj.png"))
    img = read_png(str(tmp_path / "traj.png"))
    for color, least in ((CE.ORANGE, 500), (CE.GREEN, 13 * 20), (CE.BLACK, 500)):
        assert np.all(img == color, -1).sum() >= least, color
    assert np.all(img == CE.WHITE, -1).mean() > 0.8


@pytest.mark.parametrize("dataset", ["tthq", "ttst"])
def test_cli_on_png_rallies(pipelines, monkeypatch, tmp_path, capsys, dataset):
    _, pp = pipelines
    seen = {}

    def tiny(ck=None, device="cuda"):
        seen["device"] = device
        return pp

    monkeypatch.setattr(interface, "TableTennisPipeline", tiny)
    for i in range(2):
        d = tmp_path / f"trajectory_{i:04d}"
        fdir = d if dataset == "tthq" else d / "frames"
        fdir.mkdir(parents=True)
        for k, frame in enumerate(_frames(20 + i)):
            write_png(str(fdir / (f"frame_{k:04d}.png" if dataset == "tthq" else f"{k:04d}.png")),
                      frame)
        if dataset == "tthq":
            (d / "meta.json").write_text(json.dumps({"fps": 50.0, "spin_class": 1}))
        else:
            Mint, Mext = _camera((2560, 1440))
            for k, v in {"r_img": np.full((7, 2), 500.0), "times": np.arange(7) / 50.0,
                         "Mint": Mint, "Mext": Mext, "spin_class": np.array(2)}.items():
                np.save(d / f"{k}.npy", v)
    res = CE.main(["--dataset", dataset, "--data_root", str(tmp_path), "--limit", "2",
                   "--visualize_dir", str(tmp_path / "viz"), "--device", "cpu"])
    assert seen["device"] == "cpu" and res["n"] == 2
    assert "spin acc:" in capsys.readouterr().out
    assert (tmp_path / "viz" / "trajectory_0001_2d.png").exists()
