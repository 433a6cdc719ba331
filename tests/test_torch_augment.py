"""The port's detection-noise augmentations (data/augment.py) against the JAX package.

Each augmentation gets the same input batch (the JAX `assemble_batch` on seeded analytic
flights) and JAX's own draws (the same keys and splits as the JAX function). Integer and
boolean outputs are equal: the masks, the motion-blur picks (the gathered 3D positions),
the compaction order of `random_missing` and the cut of `random_stop`. Pixel outputs agree
within 1e-2 px (the reprojection rounds its f32 matmuls in another order; detections are
hundreds to thousands of px), the rest within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uplift_data import analytic_datagen
from upliftingtabletennis_tpu.data import augment as JA
from upliftingtabletennis_tpu.data import synthetic as JSYN
from upliftingtabletennis_torch.data import augment as A
from upliftingtabletennis_torch.data import synthetic as SYN

torch.set_num_threads(1)
PX_ATOL, ATOL = 1e-2, 1e-5
B, T = 8, 50
EXACT = ("mask", "r_world", "times", "hits", "rotation")


def _jit(fn):
    """The JAX augmentation jitted whole (op by op its first call costs seconds of
    compiles), its strength or config static. Not for motion blur: jitted whole, XLA fuses
    `lo_t * 500 - 1e-6` into one rounding, and a pick on the knife edge of the ceil moves
    (1 of 600 frames of the full pipeline's batch); op by op JAX computes the function as
    written, as the port does."""
    return jax.jit(fn, static_argnums=2)


@pytest.fixture(scope="module")
def sample():
    """A training batch from the JAX assemble_batch, as numpy."""
    store = SYN.store_from_datagen(analytic_datagen(24, seed=1))  # test_torch_synthetic's
    s = JSYN.assemble_batch(jax.random.PRNGKey(2), jax.tree.map(jnp.asarray, store),
                            jnp.arange(B), train=True)
    return {k: np.asarray(v) for k, v in s.items()}


def _jax(sample):
    return {k: jnp.asarray(v) for k, v in sample.items()}


def _torch(sample):
    return {k: torch.tensor(v) for k, v in sample.items()}


def _u(key, *shape):
    return torch.tensor(np.asarray(jax.random.uniform(key, shape)))


def _n(key, *shape):
    return torch.tensor(np.asarray(jax.random.normal(key, shape)))


def _compare(got, want, exact=EXACT):
    assert set(want) <= set(got)
    for k in exact:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    for k in ("r_img", "table_img"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=PX_ATOL, rtol=0,
                                   err_msg=k)


def test_motion_blur_matches_jax(sample):
    key = jax.random.PRNGKey(1)
    want = JA.motion_blur(key, _jax(sample), 0.4)
    got = A.motion_blur(_torch(sample), _u(key, B, T), 0.4)
    _compare(got, want)
    moved = (got["r_world"].numpy() != sample["r_world"]).any(-1)
    assert moved.sum() > B * 10  # most valid frames move to another grid sample


def test_randomize_detections_matches_jax(sample):
    key = jax.random.PRNGKey(2)
    want = _jit(JA.randomize_detections)(key, _jax(sample), 2.0)
    k1, k2 = jax.random.split(key)
    got = A.randomize_detections(_torch(sample), _n(k1, B, T, 2), _n(k2, B, 13, 2), 2.0)
    _compare(got, want)


@pytest.mark.parametrize("stop_prob", [0.5, 1.0, 0.0])
def test_random_stop_matches_jax(sample, stop_prob):
    key = jax.random.PRNGKey(3)
    want = _jit(JA.random_stop)(key, _jax(sample), stop_prob)
    k1, k2 = jax.random.split(key)
    got = A.random_stop(_torch(sample), _u(k1, B), _u(k2, B), stop_prob)
    _compare(got, want)
    cut = (got["mask"].numpy().sum(1) < sample["mask"].sum(1)).sum()
    assert (cut > 0) == (stop_prob > 0)


def test_random_detection_matches_jax(sample):
    key = jax.random.PRNGKey(4)
    want = _jit(JA.random_detection)(key, _jax(sample), 0.3)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    got = A.random_detection(_torch(sample), _u(k1, B, T), _u(k2, B, T, 2), _u(k3, B, 13),
                             _u(k4, B, 13, 2), 0.3)
    _compare(got, want)


def test_random_missing_matches_jax(sample):
    key = jax.random.PRNGKey(5)
    want = _jit(JA.random_missing)(key, _jax(sample), 0.3)
    got = A.random_missing(_torch(sample), _u(key, B, T), 0.3)
    _compare(got, want)
    assert (got["mask"].numpy().sum(1) < sample["mask"].sum(1)).all()


def test_table_missing_matches_jax(sample):
    key = jax.random.PRNGKey(6)
    want = _jit(JA.table_missing)(key, _jax(sample), 0.3)
    k1, k2 = jax.random.split(key)
    got = A.table_missing(_torch(sample), _u(k1, B, 13), _u(k2, B, 13, 2), 0.3)
    _compare(got, want)
    np.testing.assert_array_equal(got["table_img"][..., 2].numpy(),
                                  np.asarray(want["table_img"][..., 2]))


def test_zero_strength_returns_the_input_and_draws_nothing(sample):
    s = _torch(sample)
    assert A.motion_blur(s, None, 0) is s
    assert A.random_detection(s, None, None, None, None, 0) is s
    assert A.random_missing(s, None, 0) is s
    assert A.table_missing(s, None, None, 0) is s
    cfg = A.AugmentConfig(blur_strength=0.0, randdet_prob=0.0, randmiss_prob=0.0,
                          tablemiss_prob=0.0)
    d = A.draw_augment(B, T, cfg, torch.Generator().manual_seed(0), "cpu")
    assert [k for k, v in d.items() if v is None] == ["motion_blur", "random_detection",
                                                       "random_missing", "table_missing"]


def _jax_train_draws(key, cfg):
    """JAX's draws of train_augment(key, ...) in `draw_augment`'s layout."""
    keys = jax.random.split(key, 6)
    k = {name: keys[i] for i, name in enumerate(
        ("motion_blur", "randomize_detections", "random_stop", "random_detection",
         "random_missing", "table_missing"))}
    r1, r2 = jax.random.split(k["randomize_detections"])
    s1, s2 = jax.random.split(k["random_stop"])
    d1, d2, d3, d4 = jax.random.split(k["random_detection"], 4)
    t1, t2 = jax.random.split(k["table_missing"])
    return {"motion_blur": (_u(k["motion_blur"], B, T),) if cfg.blur_strength else None,
            "randomize_detections": (_n(r1, B, T, 2), _n(r2, B, 13, 2)),
            "random_stop": (_u(s1, B), _u(s2, B)),
            "random_detection": ((_u(d1, B, T), _u(d2, B, T, 2), _u(d3, B, 13),
                                  _u(d4, B, 13, 2)) if cfg.randdet_prob else None),
            "random_missing": (_u(k["random_missing"], B, T),) if cfg.randmiss_prob else None,
            "table_missing": ((_u(t1, B, 13), _u(t2, B, 13, 2)) if cfg.tablemiss_prob
                              else None)}


@pytest.mark.parametrize("cfg", [A.AugmentConfig(),
                                 A.AugmentConfig(randdet_prob=0.1, randmiss_prob=0.2,
                                                 tablemiss_prob=0.2)])
def test_train_augment_matches_jax(sample, cfg):
    key = jax.random.PRNGKey(8)
    want = JA.train_augment(key, _jax(sample), JA.AugmentConfig(*cfg))
    got = A.train_augment(_torch(sample), cfg, draws=_jax_train_draws(key, cfg))
    for k in EXACT:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    for k in ("r_img", "table_img"):  # normalised: px / (2560, 1440)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=PX_ATOL / 1440,
                                   rtol=0, err_msg=k)


def test_train_augment_draws_from_the_generator(sample):
    gen = torch.Generator().manual_seed(0)
    a = A.train_augment(_torch(sample), generator=gen)
    b = A.train_augment(_torch(sample), generator=torch.Generator().manual_seed(0))
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    assert np.isfinite(a["r_img"].numpy()).all()


def test_eval_augment_matches_jax(sample):
    want = JA.eval_augment(_jax(sample))
    got = A.eval_augment(_torch(sample))
    for k in ("r_img", "table_img"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got["mask"].numpy(), sample["mask"])
