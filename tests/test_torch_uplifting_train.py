"""The port's uplifting training step (train/uplifting_train.py, the save criteria of
train/run_uplifting.py, utils/visualization.count_missortings) against the JAX package.

The JAX model ('connectstage', size small) is initialised by `jax.jit(model.init)` and
carried across by `flax_to_torch`; the batch is the JAX validation pipeline's on seeded
analytic flights (B = 8). JAX runs jitted (`value_and_grad`, `make_eval_step`, ...) in
f32 with its matmuls pinned to float32 (tests/conftest.py). Tolerances:

* the loss within 1e-5 relative; each gradient within 2e-4 of its tensor's max |grad|
  (the same f32 arithmetic summed in other orders through 12 layers, as the detector
  trainer's test);
* clip + Adam + EMA over 3 steps fed JAX's own gradients: parameters, EMA and both
  moments within 1e-5 of each tensor's max |value| (only the global norm's summation
  order differs); the port's own 3 training steps give JAX's losses within 1e-4;
* at full width (size large, the trainer's default, B = 8) the same limits: the loss, each
  gradient, and 3 training steps' losses. Seven ReLU units of this batch have a float64
  pre-activation within 1e-6 of their activation's max of zero (layers 6 and 9 of the
  first stage, five in its table stage), so the host's f32 rounding turns each on or off
  in either package: on an AVX-512 host the port's f32 forward turns the unit of layer 6
  on (its fc1 gradient lands 2e-3 of its max from the float64 one) and JAX's turns the
  unit of layer 9 on (3.2e-4), and the gradient a unit passes reaches every layer before
  it by up to 3.4e-4. So tests/parity_checks.py's `check_gradients` holds each gradient
  within 2e-4 of JAX's once some choice of -1, 0 or +1 times each such unit's float64
  contribution is taken from the difference (on the tensors that differ by 1e-4 or more,
  what is left is below 1.2e-6); a tensor that no such unit reaches is held as before;
* the validation metrics within 1e-4 relative (val2d's flight-frame spin score 1e-3: its
  frame is the difference of two predicted positions), the sign counts equal; the spin metrics
  equal, the ROC-AUC within 1e-12 of scikit-learn's; the save criteria and
  count_missortings exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from parity_checks import check_gradients, knife_edges
from uplift_data import analytic_datagen
from upliftingtabletennis_tpu.data import augment as JA
from upliftingtabletennis_tpu.data import synthetic as JSYN
from upliftingtabletennis_tpu.models.uplifting import get_uplifting_model as jax_get_model
from upliftingtabletennis_tpu.train import uplifting_train as JUT
from upliftingtabletennis_tpu.utils.visualization import count_missortings as jax_missortings
from upliftingtabletennis_torch.models.uplifting import get_uplifting_model
from upliftingtabletennis_torch.train import uplifting_train as UT
from upliftingtabletennis_torch.train.run_uplifting import INITIAL_BEST, save_decisions
from upliftingtabletennis_torch.utils.convert import flax_to_torch
from upliftingtabletennis_torch.utils.visualization import count_missortings

torch.set_num_threads(1)
LOSS_RTOL, GRAD_TOL, OPT_TOL, STEP_LOSS_RTOL, METRIC_RTOL = 1e-5, 2e-4, 1e-5, 1e-4, 1e-4
# val2d's spin score is the spin in the flight frame of the PREDICTED positions, whose
# direction is the difference of the first two: the cancellation gives up about 3 digits
SPIN_SCORE_RTOL = 1e-3
MAX_KNIFE_EDGES = 8  # 7 ReLU units of the full-width batch lie within 1e-6 of zero
B = 8
LR, DECAY = 1e-3, 0.999


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX params, the JAX sample dict, the JAX Batch)."""
    store = JSYN.store_from_datagen(analytic_datagen(24, seed=1))  # test_torch_synthetic's
    s = JA.eval_augment(JSYN.assemble_batch(jax.random.PRNGKey(0),
                                            jax.tree.map(jnp.asarray, store), jnp.arange(B),
                                            train=False))
    batch = JUT.Batch(ball_img=s["r_img"], table_img=s["table_img"], mask=s["mask"],
                      r_world=s["r_world"], rotation=s["rotation"], times=s["times"])
    jmodel = jax_get_model("connectstage", "small", mode="dynamic")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch.ball_img, batch.table_img,
                                  batch.mask, batch.times)["params"]
    return jmodel, params, {k: np.asarray(v) for k, v in s.items()}, batch


@pytest.fixture(scope="module")
def jax_fns(setup):
    """The JAX side jitted once per module: value_and_grad of loss_fn per transform mode
    (compiled at its first call), and the optimizer's update, apply and EMA."""
    jmodel, _, _, batch = setup
    tx = JUT.make_optimizer(LR)
    vg = {tm: jax.jit(jax.value_and_grad(lambda p, tm=tm: JUT.loss_fn(jmodel, p, batch, tm),
                                         has_aux=True)) for tm in ("global", "local")}
    ema = jax.jit(lambda e, p: jax.tree.map(lambda a, b: DECAY * a + (1.0 - DECAY) * b, e, p))
    return vg, tx, jax.jit(tx.update), jax.jit(optax.apply_updates), ema


def _torch_model(params):
    model = get_uplifting_model("connectstage", "small", "dynamic")
    model.load_state_dict(flax_to_torch({"params": jax.device_get(params)}))
    return model


def _as_list(model, tree):
    """A JAX parameter-shaped tree as tensors in model.parameters() order."""
    sd = flax_to_torch({"params": jax.device_get(tree)})
    return [sd[n] for n, _ in model.named_parameters()]


def _torch_batch(batch):
    return UT.Batch(*(torch.tensor(np.asarray(a)) for a in batch))


def _double(batch):
    return UT.Batch(*(t.double() if t.is_floating_point() else t for t in batch))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("transform_mode", ["global", "local"])
def test_loss_and_gradients_match_jax(setup, jax_fns, transform_mode):
    _, params, _, batch = setup
    (loss_j, (rot_j, pos_j)), grads_j = jax_fns[0][transform_mode](params)
    model = _torch_model(params)
    loss, (rot, pos) = UT.loss_fn(model, _torch_batch(batch), transform_mode)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    for g, w in ((loss, loss_j), (rot, rot_j), (pos, pos_j)):
        assert abs(g.item() - float(w)) <= LOSS_RTOL * abs(float(w))
    names = [n for n, _ in model.named_parameters()]
    for n, g, w in zip(names, grads, _as_list(model, grads_j)):
        assert _rel(g.numpy(), w.numpy()) <= GRAD_TOL, n


def _adam_state(opt_state):
    return next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu"))


@pytest.mark.parametrize("grad_scale", [1.0, 1e-4])  # the clip active, then inactive
def test_clip_adam_ema_match_optax_over_three_steps(setup, jax_fns, grad_scale):
    _, params, _, _ = setup
    vg, tx, update, apply_updates, ema_step = jax_fns
    opt_state, ema = jax.jit(tx.init)(params), params
    model = _torch_model(params)
    state = UT.init_train_state(model)
    for step in range(3):
        _, grads = vg["global"](params)
        grads = jax.tree.map(lambda g: np.asarray(g) * grad_scale, jax.device_get(grads))
        norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for g in jax.tree.leaves(grads))))
        assert (norm >= UT.CLIP_NORM) == (grad_scale == 1.0), norm
        UT.apply_update(state, _as_list(model, grads), LR, DECAY)
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
        ema = ema_step(ema, params)
        adam = _adam_state(opt_state)
        assert state.step[0] == int(adam.count) == step + 1
        for group, tree in (("params", params), ("ema", ema), ("mu", adam.mu), ("nu", adam.nu)):
            for n, g, w in zip([n for n, _ in model.named_parameters()], getattr(state, group),
                               _as_list(model, tree)):
                assert _rel(g.detach().numpy(), w.numpy()) <= OPT_TOL, (step, group, n)


def test_train_steps_give_the_jax_losses(setup, jax_fns):
    _, params, _, batch = setup
    vg, tx, update, apply_updates, _ = jax_fns
    opt_state, want = jax.jit(tx.init)(params), []
    model = _torch_model(params)
    state = UT.init_train_state(model)
    got = [float(UT.train_step(model, state, _torch_batch(batch), LR)["loss"]) for _ in range(3)]
    for _ in range(3):
        (loss, _), grads = vg["global"](params)
        want.append(float(loss))
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
    np.testing.assert_allclose(got, want, rtol=STEP_LOSS_RTOL)
    assert got[-1] < got[0]


@pytest.fixture(scope="module")
def full_width(setup):
    """The trainer's default model (connectstage large) on setup's batch: (JAX model, its
    params from `jax.jit(model.init)`, jitted value_and_grad of the global loss)."""
    _, _, _, batch = setup
    jmodel = jax_get_model("connectstage", "large", mode="dynamic")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch.ball_img, batch.table_img,
                                  batch.mask, batch.times)["params"]
    vg = jax.jit(jax.value_and_grad(lambda p: JUT.loss_fn(jmodel, p, batch, "global"),
                                    has_aux=True))
    return jmodel, params, vg


def _large_model(params):
    model = get_uplifting_model("connectstage", "large", "dynamic")
    model.load_state_dict(flax_to_torch({"params": jax.device_get(params)}))
    return model


def test_full_width_loss_and_gradients_match_jax(setup, full_width):
    _, params, vg = full_width
    (loss_j, _), grads_j = vg(params)
    model = _large_model(params)
    batch = _torch_batch(setup[3])
    loss, _ = UT.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(loss.item() - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j))
    units = knife_edges(model.double(), lambda m: UT.loss_fn(m, _double(batch))[0],
                        MAX_KNIFE_EDGES)
    names = [n for n, _ in model.named_parameters()]
    grads_j = [w.numpy() for w in _as_list(model, grads_j)]
    check_gradients(names, [g.numpy() for g in grads], grads_j, units, GRAD_TOL)


def test_full_width_train_steps_give_the_jax_losses(setup, full_width):
    _, params, vg = full_width
    tx = JUT.make_optimizer(LR)
    update, apply_updates = jax.jit(tx.update), jax.jit(optax.apply_updates)
    opt_state, want = jax.jit(tx.init)(params), []
    model = _large_model(params)
    state = UT.init_train_state(model)
    got = [float(UT.train_step(model, state, _torch_batch(setup[3]), LR)["loss"])
           for _ in range(3)]
    for _ in range(3):
        (loss, _), grads = vg(params)
        want.append(float(loss))
        updates, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, updates)
    np.testing.assert_allclose(got, want, rtol=STEP_LOSS_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("transform_mode", ["global", "local"])
def test_eval_step_matches_jax(setup, transform_mode):
    jmodel, params, _, batch = setup
    want = JUT.make_eval_step(jmodel, transform_mode)(params, batch)
    got = UT.eval_step(_torch_model(params), _torch_batch(batch), transform_mode)
    assert got["count"] == want["count"] == B
    for k in ("metric", "metric_abs", "metric_angle", "metric_position"):
        assert abs(float(got[k]) - float(want[k])) <= METRIC_RTOL * abs(float(want[k])), k
    for k in ("tp", "tn", "fp", "fn"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)


def test_val2d_step_matches_jax(setup):
    jmodel, params, s, _ = setup
    keys = ("r_img", "table_img", "mask", "times", "Mint", "Mext")
    want = JUT.make_val2d_step(jmodel, "global")(params, *(jnp.asarray(s[k]) for k in keys))
    got = UT.val2d_step(_torch_model(params), *(torch.tensor(s[k]) for k in keys))
    assert abs(float(got["metric_2d"]) - float(want["metric_2d"])) <= (
        METRIC_RTOL * abs(float(want["metric_2d"])))
    assert _rel(got["spin_score"].numpy(), want["spin_score"]) <= SPIN_SCORE_RTOL
    assert got["count"] == B


def test_spin_classification_metrics_match_jax_and_sklearn():
    sklearn_metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, 200).astype(np.float32)
    scores = np.round(rng.normal(0, 1, 200), 1)  # rounded: many ties, some exactly 0
    scores[:5] = 0.0
    got = UT.spin_classification_metrics(scores, labels)
    want = JUT.spin_classification_metrics(scores, labels)
    assert got["accuracy"] == want["accuracy"] and got["macro_f1"] == want["macro_f1"]
    assert abs(got["roc_auc"] - want["roc_auc"]) <= 1e-12
    for seed in range(5):
        r = np.random.default_rng(seed)
        y = r.integers(0, 2, 50)
        s = np.round(r.normal(0, 1, 50) + 0.5 * y, 1)
        assert abs(UT.roc_auc(y, s) - sklearn_metrics.roc_auc_score(y, s)) <= 1e-12
    assert np.isnan(UT.roc_auc(np.ones(4), np.arange(4.0)))
    assert np.isnan(UT.spin_classification_metrics(scores, np.ones(200))["roc_auc"])


def _decide(epochs):
    best, saved = dict(INITIAL_BEST), []
    for traj, spin, synth in epochs:
        names, best = save_decisions(best, traj, spin, synth)
        saved.append(names)
    return saved, best


def test_save_decisions_strictness_and_the_gate():
    saved, best = _decide([(0.01, 0.5, 10.0), (0.01, 0.5, 10.0), (0.009, 0.4, 9.0)])
    # a tie: no new trajectory or synthetic checkpoint (strict <), a spin one (>=)
    assert saved == [["model_trajectory", "model_spin", "model_synthetic"], ["model_spin"],
                     ["model_trajectory", "model_synthetic"]]
    assert best["spin_mixed"] == 0.0  # the reprojection never passed the 0.007 gate
    # the gate: 0.007 passes (<=), just above it does not
    assert "model" in save_decisions(INITIAL_BEST, 0.007, 0.1, 1.0)[0]
    assert "model" not in save_decisions(INITIAL_BEST, np.nextafter(0.007, 1), 0.1, 1.0)[0]


def test_save_decisions_combined_tie_break():
    saved, best = _decide([(0.006, 0.6, 5.0),   # the combined model
                           (0.005, 0.6, 5.0),   # the same F1, a lower reprojection: saves
                           (0.0055, 0.6, 5.0),  # the same F1, a higher reprojection: not
                           (0.0069, 0.7, 5.0),  # a higher F1 within the gate: saves
                           (0.008, 0.9, 5.0)])  # a higher F1 beyond the gate: not
    assert ["model" in s for s in saved] == [True, True, False, True, False]
    assert best["spin_mixed"] == 0.7 and best["traj_mixed"] == 0.0069
    assert best["spin"] == 0.9 and best["trajectory"] == 0.005


def test_count_missortings_matches_jax():
    rng = np.random.default_rng(3)
    for n in (2, 7, 50):
        y = rng.integers(0, 2, n)
        s = np.round(rng.normal(0, 1, n), 1)
        assert count_missortings(y, s) == jax_missortings(y, s)
    # one miss at 0.2 and at -0.1; the threshold nearer 0 wins
    assert count_missortings([1, 1, 0, 0], [0.2, -0.1, 0.1, -0.5]) == (1, -0.1)


def test_uplift_witness_holds_jax_weights_and_the_port_follows_its_losses():
    """tests/uplift_witness_60.npz (tests/make_uplift_witness.py): the weights are JAX's
    `create_train_state(PRNGKey(0))` for the batch's shapes, JAX's 60 losses end below 0.9
    of the first (tests/test_data_pipeline.py::test_train_step_reduces_loss), and the
    port's first 20 steps on the CPU from the file give JAX's losses within 1e-2 (roundings
    grow through Adam's steps). chip_smoke.py's gate 3 runs all 60 on the card."""
    with np.load(os.path.join(os.path.dirname(__file__), "uplift_witness_60.npz")) as z:
        w = {k: z[k] for k in z.files}
    jmodel = jax_get_model("connectstage", "small", mode="dynamic")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), w["ball_img"], w["table_img"],
                                  w["mask"], w["times"])["params"]
    state_dict = flax_to_torch({"params": jax.device_get(params)})
    assert {f"param.{k}" for k in state_dict} == {k for k in w if k.startswith("param.")}
    for k, v in state_dict.items():
        np.testing.assert_array_equal(w[f"param.{k}"], v.numpy(), k)
    model = get_uplifting_model("connectstage", "small", "dynamic")
    model.load_state_dict(state_dict)
    state = UT.init_train_state(model)
    batch = UT.Batch(*(torch.from_numpy(w[f]) for f in UT.Batch._fields))
    assert w["losses"][-1] < 0.9 * w["losses"][0]
    got = [float(UT.train_step(model, state, batch, LR)["loss"]) for _ in range(20)]
    np.testing.assert_allclose(got, w["losses"][:20], rtol=1e-2)


def test_reference_init_draws_the_jax_initialisers(setup):
    """`reference_init` against JAX's `model.init`: the same parameters, biases and norms
    equal (0 and 1), and every kernel a uniform draw of JAX's limit: its largest |value|
    within 20% of JAX's (the largest of n uniform draws falls short of the limit by about
    1/n of it; the smallest kernel has 24 entries)."""
    from upliftingtabletennis_torch.models.uplifting import reference_init

    _, params, _, _ = setup
    want = flax_to_torch({"params": jax.device_get(params)})
    model = reference_init(get_uplifting_model("connectstage", "small", "dynamic"),
                           torch.Generator().manual_seed(0))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].detach()
        if w.abs().max() == w.abs().min():  # zeros and ones
            assert torch.equal(g, w), name
        else:
            assert abs(float(g.abs().max() / w.abs().max()) - 1) <= 0.2, name
