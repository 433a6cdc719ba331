"""Pre/post-processing and the ball detector of the port against the JAX package.

Seeded numpy inputs go through both. Tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.data.image_transforms import normalize_image as jax_normalize
from upliftingtabletennis_tpu.ops import heatmap_decode as jax_decode
from upliftingtabletennis_tpu.ops.peak import extract_peaks as jax_extract_peaks
from upliftingtabletennis_tpu.ops.resize import resize_bilinear_down as jax_resize
from upliftingtabletennis_torch.data.image_transforms import normalize_image
from upliftingtabletennis_torch.ops.heatmap_decode import flip_back
from upliftingtabletennis_torch.ops.peak import extract_peaks
from upliftingtabletennis_torch.ops.resize import resize_bilinear_down
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)


def test_normalize_image_matches_jax():
    x = np.random.default_rng(0).uniform(0, 255, (2, 5, 7, 9)).astype(np.float32)
    np.testing.assert_allclose(normalize_image(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(x))), atol=1e-5, rtol=1e-6)


# every (in, out) pair the detectors request at 1080p ingest, as in tests/test_resize.py
@pytest.mark.parametrize("in_hw,out_hw", [
    ((1080, 1920), (896, 1600)),
    ((1080, 1920), (704, 1280)),
    ((1080, 1920), (640, 1152)),
    ((896, 1600), (704, 1280)),
    ((135, 24), (112, 20)),
    ((64, 64), (48, 48)),
])
def test_resize_matches_jax_on_uint8(in_hw, out_hw):
    x = np.random.default_rng(0).integers(0, 256, size=(2, *in_hw, 3), dtype=np.uint8)
    got = resize_bilinear_down(torch.from_numpy(x), *out_hw).numpy()
    assert got.dtype == np.float32 and got.shape == (2, *out_hw, 3)
    # the convention: jax.image.resize (cv2 half-pixel bilinear, no antialias) and the
    # JAX module's exact mode; 0.05 on the 255 scale is f32 weight noise, a tap error is O(1)
    want = np.asarray(jax.image.resize(jnp.asarray(x, jnp.float32), (2, *out_hw, 3),
                                       "bilinear", antialias=False))
    assert np.abs(got - want).max() < 5e-2
    exact = np.asarray(jax_resize(jnp.asarray(x), *out_hw, exact=True))
    assert np.abs(got - exact).max() < 5e-2


def _blob_heatmaps(centres, H=24, W=40, sigma=1.3):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    maps = [np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2)) for cx, cy in centres]
    return np.stack(maps)[:, None].astype(np.float32)


def test_extract_peaks_matches_jax_including_border():
    rng = np.random.default_rng(0)
    centres = [(10.3, 7.6), (0.0, 12.2), (39.0, 23.0), (20.45, 0.2), (5.5, 5.5)]
    hm = _blob_heatmaps(centres) + rng.normal(0, 0.01, (len(centres), 1, 24, 40)).astype(np.float32)
    got = extract_peaks(torch.from_numpy(hm), 1920, 1080).numpy()
    want = np.asarray(jax_extract_peaks(jnp.asarray(hm), 1920, 1080))
    assert got.shape == want.shape == (len(centres), 1, 3)
    # same fixed-iteration LM in f32 on both sides: 1e-2 px at 1920x1080 (48x scale)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    thr = extract_peaks(torch.from_numpy(hm), 1920, 1080, threshold=0.9).numpy()[..., 2]
    np.testing.assert_array_equal(
        thr, np.asarray(jax_extract_peaks(jnp.asarray(hm), 1920, 1080, threshold=0.9))[..., 2])


def test_extract_peaks_flat_window_falls_back_to_centre():
    hm = np.zeros((1, 8, 8), np.float32)
    hm[0, 3, 5] = 1e-4  # a fit cannot improve on a near-flat window
    got = extract_peaks(torch.from_numpy(hm), 8, 8).numpy()
    want = np.asarray(jax_extract_peaks(jnp.asarray(hm), 8, 8))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_ball_detector_matches_jax_detector():
    """Same converted weights, same seeded 448x256 triplets, model input 224x128."""
    from upliftingtabletennis_tpu.pipeline.interface import BallDetector as JaxBallDetector

    jdet = JaxBallDetector("segformerpp_b2", chunk=2, resolution=(224, 128))
    jdet._ensure_init(9)
    variables = jax.device_get(jdet._variables)
    det = BallDetector("segformerpp_b2", checkpoint=flax_to_torch(variables), chunk=2,
                       resolution=(224, 128), device="cpu")
    assert det.model.decode_head.linear_fuse.out_channels == 768

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, size=(5, 256, 448, 3), dtype=np.uint8)
    triples = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(3)]  # 2 chunks, 1 padded

    # heatmaps on the same preprocessed input: f32 end to end on both sides
    images = np.stack([np.concatenate(t, -1) for t in triples])
    x = jax_normalize(jax_resize(jnp.asarray(images), 128, 224, exact=True))
    want = np.asarray(jax.jit(jdet.model.apply)(jdet._variables, x)[0])[..., 0]
    got = det.heatmaps(torch.from_numpy(images))[:, 0].numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()

    # peaks through each package's own predict (the JAX one resizes in bf16 on the CPU):
    # within 0.5 px at 1920x1080 (a heatmap pixel is 8.6 px; the bf16 resize of the JAX
    # path moves its input by up to half a grey level)
    pos, extra = det.predict(triples)
    jpos, _ = jdet.predict(triples)
    assert extra is None and pos.shape == (3, 3) and np.isfinite(pos).all()
    np.testing.assert_allclose(pos, jpos, atol=0.5, rtol=0)


# (port detector, JAX detector name, model, input channels, heatmap tolerance): the
# tolerances of the model tests (tests/test_torch_hrnet.py, tests/test_torch_segformer.py)
@pytest.mark.parametrize("kind,name,channels,rel_tol", [
    ("ball", "wasb", 9, 2e-4), ("table", "hrnet", 3, 2e-4), ("table", "segformerpp_b0", 3, 2e-5),
])
def test_detectors_match_jax_detectors(kind, name, channels, rel_tol):
    """Same converted weights, same seeded 192x108 frames, model input 96x64; heatmaps in
    f32 on the same preprocessed input. The port's predict is then held against the JAX
    peak fit on the JAX heatmaps: within 0.05 px at 1920x1080 (a heatmap pixel is 20 px
    here), visibility (the table's threshold 0.1) equal. The JAX detector's own predict
    resizes in bf16 on the CPU, which moves an HRNet peak of random weights by pixels."""
    from upliftingtabletennis_tpu.pipeline import interface as jax_interface

    jcls = jax_interface.BallDetector if kind == "ball" else jax_interface.TableDetector
    cls = BallDetector if kind == "ball" else TableDetector
    jdet = jcls(name, chunk=2, resolution=(96, 64))
    jdet._ensure_init(channels)
    det = cls(name, checkpoint=flax_to_torch(jax.device_get(jdet._variables)), chunk=2,
              resolution=(96, 64), device="cpu")

    frames = np.random.default_rng(8).integers(0, 256, size=(5, 108, 192, 3), dtype=np.uint8)
    if kind == "ball":
        items = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(3)]
        images = np.stack([np.concatenate(t, -1) for t in items])
    else:
        items = list(frames[:3])
        images = frames[:3]
    x = jax_normalize(jax_resize(jnp.asarray(images), 64, 96, exact=True))
    out = jax.jit(jdet.model.apply)(jdet._variables, x)
    want = np.moveaxis(np.asarray(out[0] if isinstance(out, tuple) else out), -1, 1)
    got = det.heatmaps(torch.from_numpy(images)).numpy()
    assert np.abs(got - want).max() <= rel_tol * np.abs(want).max()

    pos, extra = det.predict(items)  # 2 chunks, the second padded
    jpos = np.asarray(jax_extract_peaks(jnp.asarray(want), 1920, 1080, threshold=det.threshold))
    if kind == "ball":
        jpos = jpos[:, 0]
    assert extra is None and pos.shape == jpos.shape and np.isfinite(pos).all()
    np.testing.assert_allclose(pos[..., :2], jpos[..., :2], atol=5e-2, rtol=0)
    np.testing.assert_array_equal(pos[..., 2], jpos[..., 2])


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("flip_pairs", [(), ((0, 2), (1, 3))])
def test_flip_back_matches_jax(flip_pairs, shift):
    hm = np.random.default_rng(9).normal(size=(2, 5, 7, 4)).astype(np.float32)
    got = flip_back(torch.from_numpy(hm), flip_pairs, shift).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_decode.flip_back(jnp.asarray(hm),
                                                                       flip_pairs, shift)))


def test_ball_detector_flip_test_matches_jax():
    """`BallDetector(flip_test=True)` against the JAX detector's flip test: same converted
    weights, same seeded 192x108 triplets, model input 96x64. Heatmaps: the JAX
    `flip_test_heatmaps` on the same preprocessed input, 2e-5 of max (the model tests'
    tolerance; the flip and the mean add no error in f32). Peaks: the port's predict
    against the JAX peak fit on those heatmaps, within 0.05 px at 1920x1080."""
    from upliftingtabletennis_tpu.pipeline.interface import BallDetector as JaxBallDetector

    jdet = JaxBallDetector("segformerpp_b0", chunk=2, resolution=(96, 64), flip_test=True)
    jdet._ensure_init(9)
    det = BallDetector("segformerpp_b0", checkpoint=flax_to_torch(jax.device_get(jdet._variables)),
                       chunk=2, resolution=(96, 64), device="cpu", flip_test=True)
    assert det.flip_test

    frames = np.random.default_rng(10).integers(0, 256, size=(5, 108, 192, 3), dtype=np.uint8)
    items = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(3)]
    images = np.stack([np.concatenate(t, -1) for t in items])
    x = jax_normalize(jax_resize(jnp.asarray(images), 64, 96, exact=True))
    apply = jax.jit(lambda t: jdet.model.apply(jdet._variables, t)[0])
    want = np.moveaxis(np.asarray(jax_decode.flip_test_heatmaps(apply, x)), -1, 1)
    got = det.heatmaps(torch.from_numpy(images)).numpy()
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    det.flip_test = False  # the mirrored pass changes the heatmaps
    assert np.abs(det.heatmaps(torch.from_numpy(images)).numpy() - got).max() > 1e-3
    det.flip_test = True

    pos, extra = det.predict(items)  # 2 chunks, the second padded
    jpos = np.asarray(jax_extract_peaks(jnp.asarray(want), 1920, 1080))[:, 0]
    assert extra is None and pos.shape == jpos.shape == (3, 3) and np.isfinite(pos).all()
    np.testing.assert_allclose(pos[..., :2], jpos[..., :2], atol=5e-2, rtol=0)


def test_ball_detector_reads_head_style_from_checkpoint():
    from upliftingtabletennis_torch.models.segformer import MMSegHead, SegFormerNet

    sd = SegFormerNet(1, 3, "b0", head_style="mmseg", decoder_dim=64).state_dict()
    det = BallDetector("segformerpp_b0", checkpoint=sd, chunk=1, resolution=(64, 32),
                       device="cpu")
    assert isinstance(det.model.decode_head, MMSegHead)
    assert det.model.decode_head.fusion_conv.out_channels == 64
    pos, _ = det.predict([(np.zeros((32, 64, 3), np.uint8),) * 3])
    assert pos.shape == (1, 3) and np.isfinite(pos).all()


def test_ball_detector_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        BallDetector()


def test_table_detector_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        TableDetector()


def test_hub_entry_point_on_cpu():
    from upliftingtabletennis_torch.hub import ball_detection

    det = ball_detection("segformerpp_b0", device="cpu", chunk=3)
    assert det.resolution == (1920, 1088) and det.chunk == 3 and det.dtype == torch.float32
    assert next(det.model.parameters()).device.type == "cpu"


def test_table_hub_entry_point_on_cpu():
    from upliftingtabletennis_torch.hub import table_detection

    det = table_detection("hrnet", device="cpu", chunk=2, resolution=(64, 32))
    assert det.threshold == 0.1 and det.model.model.conv1.in_channels == 3
    kp, extra = det.predict([np.zeros((54, 96, 3), np.uint8)] * 3)
    assert extra is None and kp.shape == (3, 13, 3) and np.isfinite(kp).all()
    fused = det.filter_trajectory(kp, kp)
    assert fused.shape == (13, 3)


def test_hrnet_detector_reads_input_frames_from_checkpoint():
    from upliftingtabletennis_torch.models.hrnet import WASBNet

    det = BallDetector("wasb", checkpoint=WASBNet(in_frames=3).state_dict(), chunk=1,
                       resolution=(32, 32), device="cpu")
    assert det.model.model.conv1.in_channels == 9 and det.resolution == (32, 32)
