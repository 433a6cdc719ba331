"""The port's SegFormerNet (CPU, plain path) against flax `SegFormerNet.apply`.

Weights go across through `utils/convert.py:flax_to_torch`. Inputs are seeded
numpy arrays. Tolerance: max |torch - flax| <= 2e-5 * max |flax| over the heatmap;
both sides run in fp32 (tests/conftest.py pins JAX matmuls to f32), so what remains
is summation order through 8 blocks and the decode head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.models.segformer import SegFormerNet as FlaxSegFormerNet
from upliftingtabletennis_tpu.models.segformer import _resize_bilinear as jax_resize
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.segformer import SegFormerNet, _resize_bilinear
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)
REL_TOL = 2e-5


def _perturbed_variables(model, shape, seed):
    """flax init, then every leaf perturbed so biases, norms and BN stats are not trivial."""
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros(shape))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "var":
            return (np.abs(a + rng.normal(0, 0.2, a.shape)) + 0.5).astype(np.float32)
        if a.ndim == 1:
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


def _compare(flax_model, torch_model, variables, x):
    want_heat, want_cls = jax.jit(flax_model.apply)(variables, jnp.asarray(x))
    torch_model.load_state_dict(flax_to_torch(variables))
    torch_model.eval()
    with torch.no_grad():
        got_heat, got_cls = torch_model(torch.from_numpy(x))
    want = np.asarray(want_heat)
    assert got_heat.shape == want.shape
    err = np.abs(got_heat.numpy() - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err
    if want_cls is not None:
        np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("task,head_style,hw,classify", [
    ("ball", "nvlabs", (128, 224), False),
    ("ball", "mmseg", (128, 224), True),
    ("table", "nvlabs", (128, 224), False),
    ("ball", "nvlabs", (120, 200), False),   # stage dims not divisible by the sr ratio
])
def test_segformer_b0_matches_flax(task, head_style, hw, classify):
    out, frames = (1, 3) if task == "ball" else (13, 1)
    kw = dict(model_size="b0", classify_invisible=classify, head_style=head_style)
    flax_model = FlaxSegFormerNet(out, frames, **kw)
    shape = (2, *hw, 3 * frames)
    variables = _perturbed_variables(flax_model, shape, seed=3)
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    _compare(flax_model, SegFormerNet(out, frames, **kw), variables, x)


def test_segformer_committed_table_checkpoint_matches_flax():
    from upliftingtabletennis_tpu.models.factory import get_detector as jax_get_detector
    from upliftingtabletennis_tpu.utils.checkpoint import load_checkpoint

    variables, _, info = load_checkpoint("artifacts/closed_loop/table_detector")
    assert info["model"] == "segformerpp_b0" and info["task"] == "table"
    flax_model, _ = jax_get_detector("segformerpp_b0", "table")
    model, res = get_detector("segformerpp_b0", "table")
    assert res == (1920, 1088)
    x = np.random.default_rng(5).normal(size=(1, 128, 224, 3)).astype(np.float32)
    _compare(flax_model, model, jax.device_get(variables), x)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_head_upsample_matches_jax_image_resize(factor):
    x = np.random.default_rng(factor).normal(size=(2, 4, 7, 5)).astype(np.float32)
    hw = (4 * factor, 7 * factor)
    want = np.asarray(jax_resize(jnp.asarray(x), hw))
    got = _resize_bilinear(torch.from_numpy(x), hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _smooth_input():
    """The smooth image of tests/test_token_merge.py: neighbouring tokens similar."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(3)
    return ndi.gaussian_filter(rng.normal(size=(1, 64, 96, 9)), (0, 6, 6, 0)).astype(np.float32)


# ToMe at ratio 0.4 (the ratio of tests/test_token_merge.py). The smooth input merges
# in stage 1 only (N = 384); the random one at 128x192 in stages 1 and 2 (N = 1536, 384).
# ToMe has no parameters, so `flax_to_torch` converts the same tree as without it.
@pytest.mark.parametrize("head_style,classify", [("nvlabs", False), ("mmseg", True)])
@pytest.mark.parametrize("inp", ["smooth", "random"])
def test_segformer_tome_matches_flax(head_style, classify, inp):
    kw = dict(model_size="b0", classify_invisible=classify, head_style=head_style,
              tome_ratio=0.4)
    flax_model = FlaxSegFormerNet(1, 3, **kw)
    if inp == "smooth":
        x = _smooth_input()
    else:
        x = np.random.default_rng(6).normal(size=(2, 128, 192, 9)).astype(np.float32)
    variables = _perturbed_variables(flax_model, x.shape, seed=3)
    _compare(flax_model, SegFormerNet(1, 3, **kw), variables, x)


def test_segformer_tome_committed_table_checkpoint_matches_flax():
    from upliftingtabletennis_tpu.utils.checkpoint import load_checkpoint

    variables, _, info = load_checkpoint("artifacts/closed_loop/table_detector")
    assert info["model"] == "segformerpp_b0" and info["task"] == "table"
    flax_model = FlaxSegFormerNet(13, 1, "b0", tome_ratio=0.4)
    x = np.random.default_rng(5).normal(size=(1, 128, 224, 3)).astype(np.float32)
    _compare(flax_model, SegFormerNet(13, 1, "b0", tome_ratio=0.4), jax.device_get(variables), x)
