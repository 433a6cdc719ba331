"""The uplifting transformer of the port against the JAX package: the attention ops, every
model variant on JAX-initialised weights, the committed checkpoint, and the spin frames.

Seeded numpy inputs go through both; JAX runs in f32 with its matmuls pinned to float32
(tests/conftest.py), op by op: its per-operation compile cache makes that several times
faster than a whole-model jit for models this small. Model outputs are held within 1e-4
of their max |output|: the same f32 arithmetic in another order (flax's LayerNorm takes
E[x^2] - E[x]^2, torch two passes; XLA and torch sum the products in other orders),
through 16 layers.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.core import geometry as jax_geometry
from upliftingtabletennis_tpu.models.uplifting import get_uplifting_model as jax_get_model
from upliftingtabletennis_tpu.ops import attention as jax_attention
from upliftingtabletennis_torch.core import geometry
from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.ops import attention
from upliftingtabletennis_torch.pipeline.interface import UpliftingModel
from upliftingtabletennis_torch.utils.checkpoint import load_model_from_checkpoint, save_checkpoint
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)

MODEL_RTOL = 1e-4
OP_ATOL = 1e-5
CKPT = glob.glob(os.path.join(os.path.dirname(__file__), "..", "artifacts", "uplifting_backview",
                              "ckpt", "*", "model"))


def _inputs(B=2, T=50, seed=0, pad_from=30):
    """ball (B, T, 2), table (B, 13, 3) with some keypoints invisible, mask (B, T) with the
    second sequence padded from pad_from on, times (B, T) at 50 fps."""
    rng = np.random.default_rng(seed)
    ball = rng.uniform(0, 1, (B, T, 2)).astype(np.float32)
    table = np.concatenate([rng.uniform(0, 1, (B, 13, 2)),
                            rng.uniform(0, 1, (B, 13, 1)) > 0.25], -1).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, pad_from:] = 0.0
    times = np.tile(np.arange(T, dtype=np.float32) / 50.0, (B, 1)) * mask
    return ball, table, mask, times


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def test_rope_angles_match_jax_including_half_positions():
    # t * MAX_FPS lands on k + 0.5 for some entries: both round half to even
    times = np.array([[0.0, 0.001, 0.003, 0.005, 0.007, 0.0123, 0.5, 1.0]], np.float32)
    got = attention.rope_angles(torch.from_numpy(times), 32).numpy()
    want = np.asarray(jax_attention.rope_angles(jnp.asarray(times), 32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.round(times * 500), got[..., 0])


@pytest.mark.parametrize("time_rotation", ["new", "old"])
def test_apply_rope_over_time_matches_jax(time_rotation):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 4, 10, 8)).astype(np.float32)  # (B, T, H, N, Dh)
    times = rng.uniform(0, 1, (2, 1, 10)).astype(np.float32)  # broadcast over T and heads
    got = attention.apply_rope_over_time(*_torch(x, times), time_rotation).numpy()
    want = np.asarray(jax_attention.apply_rope_over_time(jnp.asarray(x), jnp.asarray(times),
                                                         time_rotation))
    np.testing.assert_allclose(got, want, atol=OP_ATOL, rtol=0)


def test_apply_rope_rotates_interleaved_pairs():
    """Channels (0, 1) rotate together, not (0, Dh/2): a vector on channel 0 only moves
    into channel 1."""
    x = np.zeros((1, 1, 1, 8), np.float32)
    x[..., 0] = 1.0
    out = attention.apply_rope_over_time(*_torch(x, np.full((1, 1), 0.002, np.float32)))
    assert torch.count_nonzero(out[..., 2:]) == 0 and out[..., 1].abs() > 0.5


def test_masked_attention_matches_jax_with_padded_rows():
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 4, 12, 8)).astype(np.float32) for _ in range(3))
    mask = np.zeros((2, 12), np.float32)
    mask[1, 7:] = attention.NEG_INF
    got = attention.masked_attention(*_torch(q, k, v, mask)).numpy()
    want = np.asarray(jax_attention.masked_attention(*map(jnp.asarray, (q, k, v, mask))))
    np.testing.assert_allclose(got, want, atol=OP_ATOL, rtol=0)
    # a padded query row: a uniform softmax over the valid keys, not NaN
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[1, :, 9], v[1, :, :7].mean(1), atol=1e-5)


@pytest.mark.parametrize("kind", ["binary", "additive"])
def test_binarize_mask_matches_jax(kind):
    mask = (np.random.default_rng(3).uniform(size=(2, 9)) > 0.3).astype(np.float32)
    if kind == "additive":
        mask = np.where(mask > 0.5, 0.0, attention.NEG_INF).astype(np.float32)
    got = attention.binarize_mask(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_attention.binarize_mask(jnp.asarray(mask))))


VARIANTS = [("singlestage", "free", "new"), ("singlestage", "dynamic", "new"),
            ("singlestage", "stacked", "new"), ("multistage", "dynamic", "new"),
            ("multistage", "stacked", "new"), ("multistage", "originalmethod", "new"),
            ("connectstage", "dynamic", "new"), ("connectstage", "stacked", "new"),
            ("connectstage", "originalmethod", "new"), ("connectstage", "dynamic", "old")]


@pytest.mark.parametrize("name,mode,time_rotation", VARIANTS)
def test_uplifting_variant_matches_jax(name, mode, time_rotation):
    """Every get_uplifting_model variant at 'small' on JAX-initialised weights, carried
    across by flax_to_torch: rotation and positions within MODEL_RTOL of max |output|."""
    ball, table, mask, times = _inputs(T=20, pad_from=13)
    jmodel = jax_get_model(name, "small", mode, time_rotation)
    params = jmodel.init(jax.random.PRNGKey(0), ball, table, mask, times)["params"]
    rot, pos = jmodel.apply({"params": params}, ball, table, mask, times)
    model = get_uplifting_model(name, "small", mode, time_rotation)
    state = flax_to_torch({"params": jax.device_get(params)})
    model.load_state_dict(state)  # strict: every parameter, named as the flax tree
    with torch.no_grad():
        trot, tpos = model(*_torch(ball, table, mask, times))
    assert trot.shape == rot.shape and tpos.shape == pos.shape
    assert _rel_err(trot, rot) <= MODEL_RTOL and _rel_err(tpos, pos) <= MODEL_RTOL


@pytest.fixture(scope="module")
def committed():
    """The committed uplifting checkpoint read through the JAX package (Orbax): (JAX
    model, params, info)."""
    from upliftingtabletennis_tpu.utils.checkpoint import load_model_from_checkpoint as jax_load

    assert len(CKPT) == 1, CKPT
    jmodel, params, _, info = jax_load(CKPT[0])
    return jmodel, jax.device_get(params), info


def test_flax_to_torch_carries_the_committed_checkpoint(committed):
    """cls_token passes through as it is; every leaf lands on a parameter of the model
    the checkpoint's metadata names."""
    _, params, info = committed
    state = flax_to_torch({"params": params})
    assert len(state) == 241 and sum(v.numel() for v in state.values()) == 2_043_910
    np.testing.assert_array_equal(state["cls_token"].numpy(), params["cls_token"])
    model = get_uplifting_model(info["name"], info["size"], info["tabletoken_mode"],
                                info["time_rotation"])
    assert sorted(model.state_dict()) == sorted(state)


def test_committed_checkpoint_matches_jax_apply(committed, tmp_path):
    """connectstage / large / dynamic / 'new' from the committed checkpoint against JAX
    .apply on a full and a padded sequence; then the same weights through a port
    checkpoint file and UpliftingModel, whose spin is turned into the flight frame as the
    JAX UpliftingModel's (`transform_rotation_axes` of the padded output)."""
    jmodel, params, info = committed
    ball, table, mask, times = _inputs()
    rot, pos = jmodel.apply({"params": params}, ball, table, mask, times)
    path = str(tmp_path / "uplifting")
    save_checkpoint(path, flax_to_torch({"params": params}), "committed", info)
    model, _, ident, info2 = load_model_from_checkpoint(path)
    assert ident == "committed" and info2 == info
    with torch.no_grad():
        trot, tpos = model(*_torch(ball, table, mask, times))
    assert _rel_err(trot, rot) <= MODEL_RTOL and _rel_err(tpos, pos) <= MODEL_RTOL

    port = UpliftingModel(path, device="cpu")
    assert port.transform_mode == info["transform_mode"] == "global"
    # the padded sequence: 30 valid steps
    spin, pos3d = port.predict_without_normalization(ball[1:], table[1:], mask[1:], times[1:])
    jspin = np.asarray(jax_geometry.transform_rotation_axes(rot[1], pos[1]))
    assert spin.shape == (3,) and pos3d.shape == (30, 3)
    assert _rel_err(spin, jspin) <= MODEL_RTOL and _rel_err(pos3d, pos[1, :30]) <= MODEL_RTOL


@pytest.mark.parametrize("fn", ["transform_rotation_axes", "inverse_transform_rotation_axes"])
def test_spin_frames_match_jax(fn):
    rng = np.random.default_rng(5)
    spin = rng.normal(size=(4, 3)).astype(np.float32)
    traj = rng.normal(size=(4, 6, 3)).astype(np.float32)
    got = getattr(geometry, fn)(*_torch(spin, traj)).numpy()
    want = np.asarray(getattr(jax_geometry, fn)(jnp.asarray(spin), jnp.asarray(traj)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    back = geometry.inverse_transform_rotation_axes(
        geometry.transform_rotation_axes(*_torch(spin, traj)), torch.from_numpy(traj))
    np.testing.assert_allclose(back.numpy(), spin, atol=1e-5)


def test_uplifting_model_from_state_dict_and_checkpoint_metadata(tmp_path):
    """A state dict builds the architecture the arguments name; a checkpoint path
    rebuilds it from its metadata, transform_mode included."""
    ref = UpliftingModel(name="singlestage", size="small", mode="stacked", device="cpu")
    state = ref.model.state_dict()
    same = UpliftingModel(state, name="singlestage", size="small", mode="stacked", device="cpu")
    path = str(tmp_path / "up")
    info = {"name": "singlestage", "size": "small", "tabletoken_mode": "stacked",
            "time_rotation": "new", "transform_mode": "local"}
    save_checkpoint(path, state, "x", info)
    assert json.load(open(path + ".json"))["additional_info"] == info
    loaded = UpliftingModel(path, device="cpu")
    assert loaded.transform_mode == "local"
    ball = np.random.default_rng(6).uniform(0, 1920, (12, 2))
    table = np.concatenate([np.random.default_rng(7).uniform(0, 1080, (13, 2)),
                            np.ones((13, 1))], -1)
    times = np.arange(12) / 50.0
    a, b, c = (m.predict(ball, table, times) for m in (ref, same, loaded))
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[1], c[1])
    assert a[1].shape == (12, 3)
