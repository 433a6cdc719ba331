"""The port's HRNet family in training mode against the JAX model with `train=True`.

* A narrow HRNet (the WASB graph at widths 4-32, 32x48, batch 2, perturbed weights and
  statistics) from the same weights and input, with and without `remat`: the heatmaps
  within 1e-5 of their max, every gradient within 2e-4 of its tensor's max |grad| (a
  fixed random weighting of the heatmap as the loss), and the running mean and variance
  after the step within 1e-6 of the max of flax's `batch_stats` (its rule: the biased
  variance, momentum 0.9). Flax's f32 fast variance E[x^2] - E[x]^2 puts one running
  variance of this net 1.04e-6 from the float64 statistic of the same input (the port's
  4.7e-8): where flax misses the float64 statistic by more than the limit, the port is
  held to the float64 statistic instead (at most two tensors).
* `remat` on and off give equal gradients, and the running statistics move exactly once
  in a forward and backward with `remat` (the checkpointed blocks rerun their forward in
  the backward; a second update would leave 0.81 of the old statistics, not 0.9).
* The state dict after the step loads into the folded inference model, which matches
  JAX's `train=False` apply with the new `batch_stats`.
* Leaving training mode drops the folded weights: an in-place step then `train(False)`
  runs the new weights.
* `run_detection --model wasb` (ball) and `--task table --model hrnet` run 2 steps on the
  CPU and write checkpoints that `BallDetector` / `TableDetector` load.
f32 throughout; JAX pinned to full-f32 matmuls (tests/conftest.py).
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.models.hrnet import HRNet as FlaxHRNet
from upliftingtabletennis_torch.models.batch_norm import FLAX_BN_MOMENTUM
from upliftingtabletennis_torch.models import hrnet as port_hrnet
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.hrnet import HRNet
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
from upliftingtabletennis_torch.train import run_detection as T
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

HEAT_TOL = 1e-5
GRAD_TOL = 2e-4
STATS_TOL = 1e-6
B, H, W, OUT = 2, 32, 48, 3
NARROW_CFG = {
    "stem_inplanes": 8,
    "stem_strides": (1, 1),
    "stage1": {"block": "BOTTLENECK", "num_blocks": (1,), "num_channels": (4,)},
    "stage2": {"block": "BASIC", "num_blocks": (1, 1), "num_channels": (4, 8)},
    "stage3": {"block": "BASIC", "num_blocks": (1, 1, 1), "num_channels": (4, 8, 16)},
    "stage4": {"block": "BASIC", "num_blocks": (1, 1, 1, 1), "num_channels": (4, 8, 16, 32)},
    "final_conv_kernel": 1,
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def case():
    """The JAX side: perturbed variables, one train-mode forward and value_and_grad of a
    weighted sum of the heatmap, with and without remat; the eval-mode heatmap with the
    new statistics."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    wsum = rng.normal(size=(B, H, W, OUT)).astype(np.float32)
    model = FlaxHRNet(OUT, 1, NARROW_CFG, train=True)
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)))

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "mean":
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name == "var":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if a.ndim == 1:
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    out = {"x": x, "wsum": wsum, "variables": variables}
    for remat in (False, True):
        m = FlaxHRNet(OUT, 1, NARROW_CFG, train=True, remat=remat)

        def loss(params, m=m):
            (heat, _), new = m.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     x, mutable=["batch_stats"])
            return jnp.sum(heat * wsum), (heat, new["batch_stats"])

        (_, (heat, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
        out[remat] = {"heat": np.asarray(heat), "stats": jax.device_get(stats),
                      "grads": flax_to_torch({"params": jax.device_get(grads)})}
    new_vars = {"params": variables["params"], "batch_stats": out[True]["stats"]}
    out["new_variables"] = new_vars
    heat_eval, _ = jax.jit(FlaxHRNet(OUT, 1, NARROW_CFG, train=False).apply)(new_vars, x)
    out["heat_eval"] = np.asarray(heat_eval)
    return out


def _port_step(case, remat):
    """The port in training mode from the case's weights: (model, heatmap, grads by name)."""
    model = HRNet(OUT, 1, NARROW_CFG, kernels=False, remat=remat)
    model.load_state_dict(flax_to_torch(case["variables"]), strict=True)
    model.train()
    heat, _ = model(torch.from_numpy(case["x"]))
    loss = (heat * torch.from_numpy(case["wsum"])).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
    return model, heat.detach().numpy(), dict(zip(names, grads))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_mode_heatmaps_gradients_and_statistics_match_flax(case, remat, monkeypatch):
    want = case[remat]
    inputs = {}  # each BatchNorm's input, for a float64 referee of the statistics
    norm = port_hrnet.batch_norm

    def spy(x, bn, sink=None):
        inputs.setdefault(bn, x.detach().double().reshape(-1, x.shape[-1]))
        return norm(x, bn, sink)

    monkeypatch.setattr(port_hrnet, "batch_norm", spy)
    model, heat, grads = _port_step(case, remat)
    assert np.abs(want["heat"]).std() > 1e-2  # alive
    assert _rel(heat, want["heat"]) <= HEAT_TOL
    assert sorted(grads) == sorted(want["grads"])
    worst = max((_rel(g.numpy(), want["grads"][k].numpy()), k) for k, g in grads.items()
                if np.abs(want["grads"][k].numpy()).max() > 0)
    assert worst[0] <= GRAD_TOL, worst
    # parameters no output reaches get zero gradients on both sides
    for k, g in grads.items():
        if not np.abs(want["grads"][k].numpy()).any():
            assert not g.any(), k
    # The running statistics within STATS_TOL of flax's; where flax's own f32 statistic
    # (its fast variance E[x^2] - E[x]^2) is farther than that from the float64 one on
    # the same input, the port must be within STATS_TOL of the float64 statistic instead.
    new = flax_to_torch({"batch_stats": want["stats"]})
    start = flax_to_torch(case["variables"])
    state = model.state_dict()
    names = {bn: n for n, bn in model.named_modules()}
    refereed = []
    for bn, x in inputs.items():
        n = names[bn]
        assert int(state[n + ".num_batches_tracked"]) == 1, n
        for stat, exact in (("mean", x.mean(0)), ("var", x.var(0, unbiased=False))):
            k = f"{n}.running_{stat}"
            f64 = (FLAX_BN_MOMENTUM * start[k].double() + (1 - FLAX_BN_MOMENTUM) * exact).numpy()
            err = _rel(state[k].numpy(), new[k].numpy())
            if err > STATS_TOL:
                assert _rel(new[k].numpy(), f64) > STATS_TOL, (k, err)
                assert _rel(state[k].numpy(), f64) <= STATS_TOL, k
                refereed.append(k)
    assert len(inputs) == sum(k.endswith("running_mean") for k in new)
    assert len(refereed) <= 2, refereed


def test_remat_gives_the_same_gradients_and_moves_the_statistics_once(case):
    plain, _, g_plain = _port_step(case, remat=False)
    remat, _, g_remat = _port_step(case, remat=True)
    for k in g_plain:
        np.testing.assert_allclose(g_remat[k].numpy(), g_plain[k].numpy(), rtol=1e-6,
                                   atol=1e-7 * float(g_plain[k].abs().max()) + 1e-12)
    start = flax_to_torch(case["variables"])
    for (k, a), b in zip(plain.named_buffers(), remat.buffers()):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=k)
    bn = remat.bn1
    # bn1 of the stem: its batch statistics from the same input, moved once by flax's rule
    with torch.no_grad():
        y = torch.nn.functional.conv2d(torch.from_numpy(case["x"]).permute(0, 3, 1, 2),
                                       remat.conv1.weight, padding=1).permute(0, 2, 3, 1)
        mean = y.mean((0, 1, 2))
        var = torch.clamp((y * y).mean((0, 1, 2)) - mean * mean, min=0)
    m = FLAX_BN_MOMENTUM
    torch.testing.assert_close(bn.running_mean, m * start["bn1.running_mean"] + (1 - m) * mean,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_var, m * start["bn1.running_var"] + (1 - m) * var,
                               rtol=1e-6, atol=1e-7)
    # every BatchNorm of every checkpointed block moved once
    assert {int(v) for k, v in remat.state_dict().items() if k.endswith("tracked")} == {1}


def test_trained_state_dict_loads_into_the_folded_inference_model(case):
    trained, _, _ = _port_step(case, remat=True)
    model = HRNet(OUT, 1, NARROW_CFG, kernels=False)
    model.load_state_dict(trained.state_dict(), strict=True)
    model.eval()
    with torch.no_grad():
        heat, _ = model(torch.from_numpy(case["x"]))
    assert _rel(heat.numpy(), case["heat_eval"]) <= 2e-4  # the folded path's tolerance
    # and the trained model itself, once out of training mode, folds the same weights
    trained.train(False)
    with torch.no_grad():
        np.testing.assert_array_equal(trained(torch.from_numpy(case["x"]))[0].numpy(),
                                      heat.numpy())


def test_leaving_training_mode_drops_the_folded_weights(case):
    model = HRNet(OUT, 1, NARROW_CFG, kernels=False)
    model.load_state_dict(flax_to_torch(case["variables"]), strict=True)
    x = torch.from_numpy(case["x"])
    model.eval()
    with torch.no_grad():
        before = model(x)[0]
    assert model._folded_key is not None
    model.train()
    with torch.no_grad():  # an optimizer step: the weights change in place
        for p in model.parameters():
            p.mul_(1.1)
    model.train(False)
    assert model._folded_key is None
    with torch.no_grad():
        after = model(x)[0]
    fresh = HRNet(OUT, 1, NARROW_CFG, kernels=False)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = fresh.eval()(x)[0]
    np.testing.assert_array_equal(after.numpy(), want.numpy())
    assert not torch.equal(after, before)


def test_factory_builds_trainable_hrnets_and_refuses_vitpose():
    for name, task in (("wasb", "ball"), ("hrnet", "table")):
        model, res = get_detector(name, task, train=True, remat=True)
        assert model.training and model.model.remat and res == (1280, 704)
        assert not get_detector(name, task)[0].training
    with pytest.raises(ValueError, match="item 5"):
        get_detector("vitpose", "ball", train=True)


@pytest.fixture(scope="module")
def tiny_tthq(tmp_path_factory):
    """2 videos of 8 96x128 frames with a ball blob and 13 random keypoints; video 1 is
    the val/test pool (the layout tests/test_torch_detection_train.py writes)."""
    import cv2

    root = tmp_path_factory.mktemp("data")
    tthq = root / "tthq"
    rng = np.random.default_rng(0)
    rows_ball = ["video;frame;ball_x;ball_y;ball_flag"]
    rows_table = ["video;frame;" + ";".join(f"point_{k}_x;point_{k}_y;point_{k}_flag"
                                            for k in range(1, 14))]
    h, w = 96, 128
    for video in (1, 2):
        vdir = tthq / f"{video:02d}"
        vdir.mkdir(parents=True)
        for frame in range(8):
            img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
            bx, by = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
            cv2.circle(img, (int(bx), int(by)), 3, (255, 255, 255), -1)
            cv2.imwrite(str(vdir / f"{video:02d}_{frame:06d}.png"), img)
            if 1 <= frame <= 6:
                rows_ball.append(f"{video};{frame};{bx:.1f};{by:.1f};2")
                pts = ";".join(f"{rng.uniform(5, w - 5):.1f};{rng.uniform(5, h - 5):.1f};2"
                               for _ in range(13))
                rows_table.append(f"{video};{frame};{pts}")
    (tthq / "ball_detection.csv").write_text("\n".join(rows_ball))
    (tthq / "table_detection.csv").write_text("\n".join(rows_table))
    return str(root)


@pytest.mark.parametrize("task,model,detector", [("ball", "wasb", BallDetector),
                                                 ("table", "hrnet", TableDetector)])
def test_cli_trains_hrnets_and_saves_loadable_checkpoints(tiny_tthq, tmp_path, task, model,
                                                          detector):
    save = tmp_path / "ckpt"
    T.main(["--task", task, "--model", model, "--data_root", tiny_tthq, "--batch_size", "2",
            "--num_epochs", "1", "--val_iterations", "2", "--max_steps", "2",
            "--resolution", "64", "48", "--eval_resolution", "128", "96",
            "--save_dir", str(save), "--logdir", str(tmp_path / "runs"), "--device", "cpu"])
    (ckpt,) = glob.glob(str(save / f"{task}_{model}_*" / "model.pt"))
    state, _, info = load_checkpoint(ckpt)
    assert info["model"] == model and info["resolution"] == [64, 48]
    # two steps: every BatchNorm moved twice, and the EMA weights moved
    assert {int(v) for k, v in state.items() if k.endswith("tracked")} == {2}
    init, _ = get_detector(model, task, train=True)
    T.init_weights(init, 42)
    assert any(not torch.equal(state[k], v) for k, v in init.state_dict().items()
               if k.endswith("weight"))
    det = detector(model, checkpoint=ckpt, chunk=2, resolution=(64, 48), device="cpu")
    frames = np.random.default_rng(1).integers(0, 255, (3, 96, 128, 3), dtype=np.uint8)
    if task == "ball":
        pos, _ = det.predict([(frames[0], frames[1], frames[2])])
        assert pos.shape == (1, 3) and np.isfinite(pos).all()
    else:
        kp, _ = det.predict(list(frames))
        assert kp.shape == (3, 13, 3) and np.isfinite(kp).all()


def test_table_hrnet_returns_a_bare_heatmap_unlike_what_the_jax_trainer_unpacks():
    """The JAX trainer unpacks every detector's output as (heatmap, extra)
    (`train/run_detection.py:267`, `:288`); flax's TableHRNet returns the heatmap alone, so
    there the pair is the batch axis: at batch 4 it raises, at batch 2 it would take the
    first sample as the heatmap. The port's trainer takes a bare heatmap as it is
    (`run_detection.heatmap`), as the JAX closed loop does."""
    from upliftingtabletennis_tpu.models.factory import get_detector as jax_get_detector

    model, _ = jax_get_detector("hrnet", "table", train=True)
    x = jnp.zeros((4, 32, 32, 3))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x)
    out, _ = model.apply(variables, x, mutable=["batch_stats"])
    assert not isinstance(out, tuple) and out.shape == (4, 32, 32, 13)
    with pytest.raises(ValueError):
        (heat, cls_out), _ = out, None  # the JAX trainer's line, at batch 4
    port = torch.zeros(4, 32, 32, 13)
    assert T.heatmap(port) is port and T.heatmap((port, None)) is port
