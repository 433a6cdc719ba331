"""The rally path of the port against the JAX package: the uplifting inputs, the i420
ingest, the host downscale, and `TableTennisPipeline.run_rally` end to end.

The rally runs at the JAX tests' small setup (tests/test_pipeline.py): WASB and the table
HRNet at 96x64, chunk 4, 9 frames, so that triplets cross piece edges and the last piece
is padded. Both packages get the same weights (the JAX detectors' seeded init, carried
across with flax_to_torch); the ball's main detector is its aux detector, so the ball
filter keeps every interior frame and the uplifting model runs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.data import image_transforms as jax_it
from upliftingtabletennis_tpu.pipeline import filters as jax_filters
from upliftingtabletennis_tpu.pipeline import interface as jax_interface
from upliftingtabletennis_torch import hub
from upliftingtabletennis_torch.data import image_transforms as it
from upliftingtabletennis_torch.pipeline import filters
from upliftingtabletennis_torch.pipeline import interface
from upliftingtabletennis_torch.utils.checkpoint import save_checkpoint
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)

RES = (96, 64)
# Peaks at 1920x1080. The ball's 3x3 peak fits are well conditioned here and agree within
# 2e-4 px. Of the table HRNet's 117 windows per rally, 1-6 (by seed) hold values of 2-4
# (random weights) where the fit expects a unit-amplitude Gaussian; there the two f32 LM
# fits part by up to 0.8 px on identical heatmaps. The table filter averages a cluster
# of at least 4 frames (measured 0.05-0.09 px apart); 0.2 px bounds 0.8 / 4.
BALL_TOL_PX, TABLE_TOL_PX = 0.05, 0.2
# spin and pos3d, relative to their max |value|: the table's 0.2 px is 1e-4 of the frame
# width in the model's normalised input; measured 1e-5-4e-5
UPLIFT_RTOL = 1e-3


def test_uplifting_inputs_match_jax():
    rng = np.random.default_rng(0)
    table = np.concatenate([rng.uniform(0, 1080, (13, 2)), rng.integers(0, 2, (13, 1))], -1)
    for n in (7, 50, 63):  # padded, full, cut to SEQUENCE_LEN
        ball, times = rng.uniform(0, 1920, (n, 2)), np.arange(n) / 50.0
        got = filters.uplifting_inputs(ball, table, times, 1920, 1080)
        want = jax_filters.uplifting_inputs(ball, table, times, 1920, 1080)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_i420_conversions_match_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    np.testing.assert_array_equal(it.rgb_to_i420(rgb), jax_it.rgb_to_i420(rgb))
    yuv = rng.integers(0, 256, (3, 96, 96), dtype=np.uint8)  # every code, saturating too
    got = it.i420_to_rgb(torch.from_numpy(yuv), 64, 96)
    assert got.dtype == torch.uint8 and got.shape == (3, 64, 96, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_it.i420_to_rgb(jnp.asarray(yuv),
                                                                              64, 96)))


@pytest.mark.parametrize("pixel_format", ["rgb", "i420"])
def test_host_downscale_within_one_level_of_jax(pixel_format):
    """The JAX function's cv2 INTER_LINEAR rounds fixed-point weights; the port rounds the
    f32 half-pixel bilinear: within 1 grey level, layout kept."""
    frames = np.random.default_rng(7).integers(0, 255, (2, 128, 192, 3), dtype=np.uint8)
    if pixel_format == "i420":
        frames = jax_it.rgb_to_i420(frames)
    got = it.host_downscale(frames, RES, pixel_format)
    want = jax_it.host_downscale(frames, RES, pixel_format)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    # and the device resize's convention (tests/test_pipeline.py:182)
    if pixel_format == "rgb":
        ref = np.asarray(jax.image.resize(frames.astype(np.float32), (2, 64, 96, 3), "bilinear",
                                          antialias=False))
        assert np.abs(got - ref).max() <= 0.5 + 1e-3


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) with the same weights, built as the JAX tests build
    theirs (`__new__`, detectors at 96x64, chunk 4)."""
    jp = jax_interface.TableTennisPipeline.__new__(jax_interface.TableTennisPipeline)
    jp.ball_detector = jax_interface.BallDetector("wasb", chunk=4, resolution=RES)
    jp.ball_detector_aux = jp.ball_detector
    jp.table_detector = jax_interface.TableDetector("hrnet", chunk=4, resolution=RES)
    jp.table_detector_aux = jax_interface.TableDetector("hrnet", chunk=4, resolution=RES)
    jp.uplifting_model = jax_interface.UpliftingModel(name="connectstage", size="small")
    jp.KEYPOINT_VISIBLE = 1
    for d in (jp.ball_detector, jp.table_detector, jp.table_detector_aux):
        d._ensure_init(9 if d.task == "ball" else 3)
    jp.uplifting_model._ensure_init(*(jnp.zeros(s) for s in ((1, 50, 2), (1, 13, 3), (1, 50),
                                                               (1, 50))))

    def port(cls, jdet, name):
        return cls(name, flax_to_torch(jax.device_get(jdet._variables)), chunk=4,
                   resolution=RES, device="cpu")

    pp = interface.TableTennisPipeline.__new__(interface.TableTennisPipeline)
    pp.ball_detector = port(interface.BallDetector, jp.ball_detector, "wasb")
    pp.ball_detector_aux = pp.ball_detector
    pp.table_detector = port(interface.TableDetector, jp.table_detector, "hrnet")
    pp.table_detector_aux = port(interface.TableDetector, jp.table_detector_aux, "hrnet")
    pp.uplifting_model = interface.UpliftingModel(
        flax_to_torch({"params": jax.device_get(jp.uplifting_model.params)}), size="small",
        device="cpu")
    pp.KEYPOINT_VISIBLE = 1
    return jp, pp


def _frames(seed=11, hw=(64, 96)):
    return np.random.default_rng(seed).integers(0, 255, (9, *hw, 3), dtype=np.uint8)


def _assert_rally_close(got, want):
    np.testing.assert_array_equal(got["valid_idx"], want["valid_idx"])
    np.testing.assert_array_equal(got["times"], want["times"])
    assert got["ball"].shape == want["ball"].shape == (len(want["valid_idx"]), 2)
    np.testing.assert_allclose(got["ball"], want["ball"], atol=BALL_TOL_PX, rtol=0)
    np.testing.assert_array_equal(got["table"][:, 2], want["table"][:, 2])
    np.testing.assert_allclose(got["table"], want["table"], atol=TABLE_TOL_PX, rtol=0)
    for k in ("spin", "pos3d"):
        assert got[k].shape == want[k].shape
        assert np.abs(got[k] - want[k]).max() <= UPLIFT_RTOL * np.abs(want[k]).max(), k


@pytest.mark.parametrize("case", ["array", "list", "table_stride_2", "i420"])
def test_run_rally_matches_jax(pipelines, case):
    """ball, valid_idx, times, table (with equal visibility), spin and pos3d of the port's
    run_rally against the JAX run_rally on the same frames."""
    jp, pp = pipelines
    frames = _frames()
    kw, inp = {}, frames
    if case == "list":
        inp = list(frames)
    elif case == "table_stride_2":
        kw = {"table_stride": 2}
    elif case == "i420":
        kw, inp = {"pixel_format": "i420"}, it.rgb_to_i420(frames)
    want = jp.run_rally(inp, fps=50, **kw)
    got = pp.run_rally(inp, fps=50, **kw)
    assert len(want["valid_idx"]) == 7  # every interior frame: the uplifting model ran
    _assert_rally_close(got, want)
    assert pp._last_frame_res == jp._last_frame_res == (96, 64)


@pytest.mark.parametrize("pixel_format", ["rgb", "i420"])
def test_run_rally_upload_res_equals_predownscaled_frames(pipelines, pixel_format):
    """upload_res "model" (the largest detector input, 96x64) and an explicit tuple give
    exactly the rally of frames downscaled beforehand and uploaded as given; frames at the
    model resolution upload untouched. The caller's frame stays the record."""
    _, pp = pipelines
    frames = _frames(13, (128, 192))
    if pixel_format == "i420":
        frames = it.rgb_to_i420(frames)
    kw = {"fps": 50, "pixel_format": pixel_format}
    auto = pp.run_rally(frames, **kw)
    assert pp._last_frame_res == (192, 128)
    pre = pp.run_rally(it.host_downscale(frames, RES, pixel_format), upload_res=None, **kw)
    others = [pre]
    if pixel_format == "rgb":
        others.append(pp.run_rally(frames, upload_res=RES, **kw))
        small = _frames(13)
        a, b = pp.run_rally(small, fps=50), pp.run_rally(small, fps=50, upload_res=None)
        np.testing.assert_array_equal(a["ball"], b["ball"])
    for out in others:
        for k in auto:
            np.testing.assert_array_equal(out[k], auto[k])


def test_pipeline_calibrates_in_the_last_rally_frame(pipelines):
    """calibrate_camera's principal point is the centre of the last rally's frame."""
    _, pp = pipelines
    pp.run_rally(_frames(13, (128, 192)), fps=50)
    kp = np.concatenate([np.random.default_rng(2).uniform(0, 128, (13, 2)), np.ones((13, 1))], -1)
    Mint, Mext, n = pp.calibrate_camera(kp)
    assert (Mint[0, 2], Mint[1, 2]) == (96, 64) and Mext.shape == (4, 4) and 0 <= n <= 13
    Mint, _, _ = pp.calibrate_camera(kp, resolution=(1920, 1080))
    assert (Mint[0, 2], Mint[1, 2]) == (960, 540)


@pytest.mark.parametrize("build", ["pipeline", "uplifting", "hub_full_pipeline", "hub_uplifting",
                                   "reproject"])
def test_default_device_raises_without_cuda(monkeypatch, build):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctor = {"pipeline": interface.TableTennisPipeline, "uplifting": interface.UpliftingModel,
            "hub_full_pipeline": hub.full_pipeline, "hub_uplifting": hub.uplifting,
            "reproject": lambda: interface.TableTennisPipeline.reproject(
                np.zeros((2, 3)), np.eye(3), np.eye(4))}[build]
    with pytest.raises(RuntimeError, match="cuda"):
        ctor()


def test_pipeline_refuses_what_is_not_ported(tmp_path, monkeypatch):
    import urllib.error

    from upliftingtabletennis_torch.parallel.mesh import make_mesh
    from upliftingtabletennis_torch.utils import port_reference_weights as PRW

    # the mesh is ported (tests/test_torch_parallel.py); a chunk its dp does not divide
    with pytest.raises(ValueError, match="divisible"):
        interface.TableTennisPipeline(chunk=8, mesh=make_mesh(3, devices=["cpu"] * 3))
    # weights_url is ported (tests/test_torch_port_reference_weights.py); a zip that is not
    # there cannot be fetched, and nothing is cached
    monkeypatch.setattr(PRW, "CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises((FileNotFoundError, urllib.error.URLError)):
        hub.full_pipeline(weights_url=f"file://{tmp_path}/missing.zip", device="cpu")
    assert os.listdir(tmp_path / "cache") == []


def test_hub_full_pipeline_on_the_cpu(tmp_path):
    """The production ensemble on the CPU, the uplifting weights read from the
    weights_root layout; the uplifting model predicts from pixel inputs."""
    up = interface.UpliftingModel(device="cpu", size="large")
    state = {k: v + 1.0 for k, v in up.model.state_dict().items()}
    path = tmp_path / hub.WEIGHTS_LAYOUT["uplifting"]
    save_checkpoint(str(path), state, "x", {"name": "connectstage", "size": "large",
                                            "tabletoken_mode": "dynamic", "time_rotation": "new",
                                            "transform_mode": "global"})
    pipe = hub.full_pipeline(weights_root=str(tmp_path), device="cpu", chunk=2)
    names = [d.model_name for d in pipe._detectors()]
    assert names == ["segformerpp_b2", "wasb", "segformerpp_b2", "hrnet"]
    assert all(d.chunk == 2 and d.device.type == "cpu" for d in pipe._detectors())
    loaded = pipe.uplifting_model.model.state_dict()
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    ball = np.stack([np.linspace(400, 1500, 20), np.linspace(700, 300, 20)], -1)
    table = np.concatenate([np.random.default_rng(0).uniform(0, 1080, (13, 2)),
                            np.ones((13, 1))], -1)
    spin, pos3d = pipe.uplifting_model.predict(ball, table, np.arange(20) / 50.0)
    assert spin.shape == (3,) and pos3d.shape == (20, 3) and np.isfinite(pos3d).all()
