"""The port's ViTPose (CPU, einsum attention) against flax `VitPoseNet.apply`.

Weights go across through `utils/convert.py:flax_to_torch` with a strict
`load_state_dict`; inputs are seeded numpy arrays. Tolerance: max |torch - flax|
<= 2e-5 * max |flax| over the output, the tolerance of tests/test_torch_segformer.py;
both sides run in fp32 (tests/conftest.py pins JAX matmuls to f32), so what
remains is summation order through 12 blocks and the two deconvolutions. Every
leaf of the flax tree is perturbed (biases, norms, BatchNorm statistics, the
position embedding), so a wrong map of any of them shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.models.vit import HeatmapHead as FlaxHeatmapHead
from upliftingtabletennis_tpu.models.vit import ViTBackbone as FlaxViTBackbone
from upliftingtabletennis_tpu.models.vit import VitPoseNet as FlaxVitPoseNet
from upliftingtabletennis_tpu.ops.peak import extract_peaks as jax_extract_peaks
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.vit import HeatmapHead, ViTBackbone, VitPoseNet, patch_grid
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)
REL_TOL = 2e-5


def _perturbed_variables(model, shape, seed):
    """flax init, then every leaf moved: 1-D leaves and the position embedding by
    N(0, 0.1), BatchNorm means both ways and variances by a factor of 0.5-1.5."""
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros(shape)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "var":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if a.ndim == 1 or name == "pos_embed":
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _rel_err(got, want):
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _port_out(model, variables, x):
    model.load_state_dict(flax_to_torch(variables), strict=True)
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return (out[0] if isinstance(out, tuple) else out).numpy()


def test_patch_grid_matches_flax_conv():
    """floor((H + 4 - 16) / 16) + 1 per side: 40 x 72 at 1152x640, as flax's conv gives."""
    assert patch_grid(640, 1152) == (40, 72)
    for h, w in ((64, 48), (96, 64), (50, 33)):
        feats = jax.eval_shape(lambda x: FlaxViTBackbone(64, 1, 4, in_chans=3).init_with_output(
            jax.random.PRNGKey(0), x)[0], jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32))
        assert patch_grid(h, w) == feats.shape[1:3]


def test_backbone_matches_flax():
    """Depth 2, embed 64, 4 heads at 64x80: the blocks and the position embedding."""
    flax_model = FlaxViTBackbone(embed_dim=64, depth=2, num_heads=4, in_chans=9)
    shape = (2, 64, 80, 9)
    variables = _perturbed_variables(flax_model, shape, seed=0)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(flax_model.apply)(variables, x))
    got = _port_out(ViTBackbone(patch_grid(64, 80), 64, 2, 4, 9), variables, x)
    assert _rel_err(got, want) <= REL_TOL


def test_heatmap_head_matches_flax_with_shifted_batch_norm():
    """The deconvolutions (square 256 -> 256 included: only values prove the in/out
    order) and BatchNorm on perturbed running statistics."""
    flax_model = FlaxHeatmapHead(out_channels=13)
    shape = (2, 5, 7, 64)
    variables = _perturbed_variables(flax_model, shape, seed=2)
    assert np.abs(variables["batch_stats"]["deconv_layers_1"]["mean"]).max() > 0.05
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(flax_model.apply)(variables, x))
    got = _port_out(HeatmapHead(64, 13), variables, x)
    assert got.shape == (2, 20, 28, 13)
    assert _rel_err(got, want) <= REL_TOL
    # the transposed 256 -> 256 kernel read the other way round fails the tolerance
    sd = flax_to_torch(variables)
    sd["deconv_layers_3.weight"] = sd["deconv_layers_3.weight"].transpose(0, 1).contiguous()
    head = HeatmapHead(64, 13)
    head.load_state_dict(sd, strict=True)
    with torch.no_grad():
        wrong = head.eval()(torch.from_numpy(x)).numpy()
    assert _rel_err(wrong, want) > 1e-2


@pytest.fixture(scope="module")
def vitpose_cases():
    """flax ViTPose small for ball (9 channels in, 1 out) and table (3 in, 13 out), each
    initialised once and jitted once."""
    cases = {}
    for task, (out, frames) in {"ball": (1, 3), "table": (13, 1)}.items():
        model = FlaxVitPoseNet(out, frames, "small")
        cases[task] = dict(model=model, out=out, frames=frames, apply=jax.jit(model.apply),
                           variables=_perturbed_variables(model, (1, 64, 48, 3 * frames),
                                                          seed=4 if task == "ball" else 5))
    return cases


@pytest.mark.parametrize("task", ["ball", "table"])
@pytest.mark.parametrize("hw", [(64, 48), (96, 64)])
def test_vitpose_matches_flax(vitpose_cases, task, hw):
    """The full VitPoseNet small (12 blocks, 384 wide, 12 heads), at two resolutions:
    the position embedding is sized from the input as flax sizes it at init."""
    c = vitpose_cases[task]
    shape = (2, *hw, 3 * c["frames"])
    variables = c["variables"]
    if hw != (64, 48):  # a resolution of its own: flax sizes pos_embed at init
        variables = _perturbed_variables(c["model"], shape, seed=6)
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    heat, extra = c["apply"](variables, x)
    assert extra is None
    want = np.asarray(heat)
    got = _port_out(VitPoseNet(c["out"], c["frames"], "small", (hw[1], hw[0])), variables, x)
    assert got.shape == (2, hw[0] // 4, hw[1] // 4, c["out"])
    assert _rel_err(got, want) <= REL_TOL


@pytest.mark.parametrize("task", ["ball", "table"])
def test_flax_to_torch_round_trip_is_strict(vitpose_cases, task):
    """flax init -> flax_to_torch -> load_state_dict(strict=True): no key missing or
    unexpected, every shape equal, the position embedding carried as it is."""
    c = vitpose_cases[task]
    sd = flax_to_torch(c["variables"])
    model, res = get_detector("vitpose", task, resolution=(48, 64))
    assert res == (48, 64)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        model.model_backbone.pos_embed.detach().numpy(),
        c["variables"]["params"]["model_backbone"]["pos_embed"])


def test_vitpose_base_matches_flax():
    """model_size="base" (768 wide, 12 heads of 64) at 64x48."""
    flax_model = FlaxVitPoseNet(1, 3, "base")
    shape = (1, 64, 48, 9)
    variables = _perturbed_variables(flax_model, shape, seed=8)
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.jit(flax_model.apply)(variables, x)[0])
    got = _port_out(VitPoseNet(1, 3, "base", (48, 64)), variables, x)
    assert _rel_err(got, want) <= REL_TOL


def test_factory_builds_vitpose_at_native_and_override_resolutions():
    model, res = get_detector("vitpose", "ball")
    assert res == (1152, 640) and model.model_backbone.grid == (40, 72)
    assert model.model_backbone.pos_embed.shape == (1, 2881, 384)
    assert model.model_backbone.patch_embed_proj.in_channels == 9
    model, res = get_detector("vitpose", "table", resolution=(96, 64))
    assert res == (96, 64) and model.model_backbone.grid == (4, 6)
    assert model.model_keypoint_head.final_layer.out_channels == 13
    with pytest.raises(ValueError, match="unknown detector"):
        get_detector("vitpose_huge", "ball")


# (port detector, JAX detector, input channels): the JAX detector inits at its
# resolution after the override, as the port builds it
@pytest.mark.parametrize("kind,channels", [("ball", 9), ("table", 3)])
def test_vitpose_detector_matches_jax_detector(kind, channels):
    """Same converted weights, same seeded 192x108 frames, model input 96x64. Heatmaps in
    f32 on the same preprocessed input, 2e-5 of max. Peaks: the port's predict against
    the JAX peak fit on the JAX heatmaps, within 0.05 px at 1920x1080 (a heatmap pixel
    is 80 px here); the table's visibility (threshold 0.1) equal."""
    from upliftingtabletennis_tpu.data.image_transforms import normalize_image as jax_normalize
    from upliftingtabletennis_tpu.ops.resize import resize_bilinear_down as jax_resize
    from upliftingtabletennis_tpu.pipeline import interface as jax_interface

    jcls = jax_interface.BallDetector if kind == "ball" else jax_interface.TableDetector
    cls = BallDetector if kind == "ball" else TableDetector
    jdet = jcls("vitpose", chunk=2, resolution=(96, 64))
    jdet._ensure_init(channels)
    det = cls("vitpose", checkpoint=flax_to_torch(jax.device_get(jdet._variables)), chunk=2,
              resolution=(96, 64), device="cpu")
    assert det.resolution == (96, 64) and det.model.model_backbone.grid == (4, 6)

    frames = np.random.default_rng(11).integers(0, 256, size=(5, 108, 192, 3), dtype=np.uint8)
    if kind == "ball":
        items = [(frames[t], frames[t + 1], frames[t + 2]) for t in range(3)]
        images = np.stack([np.concatenate(t, -1) for t in items])
    else:
        items = list(frames[:3])
        images = frames[:3]
    x = jax_normalize(jax_resize(jnp.asarray(images), 64, 96, exact=True))
    want = np.moveaxis(np.asarray(jax.jit(jdet.model.apply)(jdet._variables, x)[0]), -1, 1)
    got = det.heatmaps(torch.from_numpy(images)).numpy()
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()

    pos, extra = det.predict(items)  # 2 chunks, the second padded
    jpos = np.asarray(jax_extract_peaks(jnp.asarray(want), 1920, 1080, threshold=det.threshold))
    if kind == "ball":
        jpos = jpos[:, 0]
    assert extra is None and pos.shape == jpos.shape and np.isfinite(pos).all()
    np.testing.assert_allclose(pos[..., :2], jpos[..., :2], atol=5e-2, rtol=0)
    np.testing.assert_array_equal(pos[..., 2], jpos[..., 2])


def test_vitpose_detector_reads_architecture_from_checkpoint():
    """A table checkpoint builds a 1-frame table model; a ball checkpoint given to
    the table detector fails the strict load (1 output, not 13)."""
    sd = VitPoseNet(13, 1, "small", (64, 32)).state_dict()
    det = TableDetector("vitpose", checkpoint=sd, chunk=1, resolution=(64, 32), device="cpu")
    assert det.model.model_backbone.patch_embed_proj.in_channels == 3
    kp, _ = det.predict([np.zeros((54, 96, 3), np.uint8)])
    assert kp.shape == (1, 13, 3) and np.isfinite(kp).all()
    with pytest.raises(RuntimeError, match="final_layer"):
        TableDetector("vitpose", checkpoint=VitPoseNet(1, 3, "small", (64, 32)).state_dict(),
                      resolution=(64, 32), device="cpu")


def test_vitpose_hub_entry_points_on_cpu():
    from upliftingtabletennis_torch.hub import ball_detection, table_detection

    det = ball_detection("vitpose", device="cpu", chunk=2, resolution=(64, 32))
    assert det.resolution == (64, 32) and det.dtype == torch.float32
    pos, _ = det.predict([(np.zeros((54, 96, 3), np.uint8),) * 3])
    assert pos.shape == (1, 3) and np.isfinite(pos).all()
    det = table_detection("vitpose", device="cpu", chunk=2)
    assert det.resolution == (1152, 640) and det.model.model_backbone.grid == (40, 72)
