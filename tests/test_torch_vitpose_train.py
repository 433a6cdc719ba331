"""The port's ViTPose in training mode against the JAX model with `train=True`.

* VitPoseNet (12 blocks of 384, fixed) at a 64x64 input (a 4x4 token grid), batch 2,
  ball (9 channels), perturbed head statistics: JAX draws its stochastic-depth masks
  from the `dropout` key inside the jitted apply; `jax.random.bernoulli` is wrapped
  there so the same apply returns them, and the port takes them as `drop_masks`. The
  trainer's loss (`run_detection.loss_fn`: the logits upscaled to 48x32, weighted MSE):
  heatmaps within 1e-5 of their max, the loss within 1e-5 relative, every gradient
  within 2e-4 of its tensor's max |grad|, the head's running statistics within 1e-6 of
  the max of flax's `batch_stats`.
* Planted faults break those limits: the drop path without `/ keep`, the head's
  BatchNorms on their running statistics in training, and the unbiased batch variance
  in the running statistics (`chip_smoke.unbiased_stats_fault`).
* The drop rates rise linearly from 0 (block 0, which draws nothing, as in JAX) to
  0.3; `draw_drop_masks` keeps each sample with probability 1 - rate; a model in
  training mode without masks raises.
* `run_detection --model vitpose` runs 2 steps on a tiny TTHQ layout on the CPU, for the
  ball and the table, and its checkpoint loads into `BallDetector` / `TableDetector`.
f32 throughout; JAX pinned to full-f32 matmuls (tests/conftest.py).
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.eval import metrics as jax_metrics
from upliftingtabletennis_tpu.models.vit import VitPoseNet as FlaxVitPose
from upliftingtabletennis_torch.models import batch_norm as BN
from upliftingtabletennis_torch.models import vit as V
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
from upliftingtabletennis_torch.train import run_detection as T
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

HEAT_TOL, LOSS_TOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-5, 2e-4, 1e-6
B, H, W, EH, EW = 2, 64, 64, 32, 48


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jax_train_apply(model, variables, x, key, target=None):
    """One train-mode apply (and, with a target, the trainer's loss and its gradients),
    jitted, returning JAX's drop masks as a (depth, 2, B) array (block 0 all ones)."""
    orig = jax.random.bernoulli
    draws = []

    def spy(k, p, shape=None):
        out = orig(k, p, shape)
        draws.append(out)
        return out

    def apply(params):
        draws.clear()
        jax.random.bernoulli = spy
        try:
            (heat, _), new = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                         x, mutable=["batch_stats"], rngs={"dropout": key})
        finally:
            jax.random.bernoulli = orig
        masks = jnp.stack([d.reshape(-1) for d in draws]).reshape(-1, 2, x.shape[0])
        masks = jnp.concatenate([jnp.ones((1, 2, x.shape[0]), masks.dtype), masks])
        logits = jnp.moveaxis(heat, -1, 1)
        logits = jax.image.resize(logits, (*logits.shape[:2], EH, EW), "bilinear")
        loss = jax_metrics.weighted_mse_loss(logits, target)
        return loss, (heat, new["batch_stats"], masks.astype(jnp.float32))

    (loss, (heat, stats, masks)), grads = jax.jit(jax.value_and_grad(apply, has_aux=True))(
        variables["params"])
    return {"loss": float(loss), "heat": np.asarray(heat), "masks": np.asarray(masks),
            "stats": flax_to_torch({"batch_stats": jax.device_get(stats)}),
            "grads": flax_to_torch({"params": jax.device_get(grads)})}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, W, 9)).astype(np.float32)
    model = FlaxVitPose(1, 3, train=True)
    variables = jax.device_get(jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x))

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if path[-1].key == "var":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    coords = rng.uniform([0, 0], [EW, EH], (B, 1, 2)).astype(np.float32)
    target = np.asarray(jax_metrics.render_gaussian_heatmaps(
        jnp.asarray(coords), jnp.ones((B, 1)), EH, EW, 6.0))
    out = jax_train_apply(model, variables, jnp.asarray(x), jax.random.PRNGKey(3),
                          jnp.asarray(target))
    return {"x": x, "target": target, "variables": variables, **out}


def _port_step(case, monkeypatch=None, fault=None):
    """The port's trainer loss from the case's weights and JAX's masks: (model, heatmap,
    loss, gradients by name)."""
    model, _ = get_detector("vitpose", "ball", resolution=(W, H), train=True, kernels=False)
    model.load_state_dict(flax_to_torch(case["variables"]), strict=True)
    masks = torch.from_numpy(case["masks"].copy())
    if fault == "no_keep_scaling":
        monkeypatch.setattr(V, "_drop_path", lambda y, m, keep: y * m.to(y.dtype)[:, None, None])
    elif fault == "running_stats_in_training":
        monkeypatch.setattr(V.HeatmapHead, "_deconv_bn_relu", lambda self, x, d, bn: torch.relu(
            torch.nn.functional.batch_norm(
                torch.nn.functional.conv_transpose2d(x, d.weight, None, stride=2, padding=1),
                bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)))
    elif fault == "unbiased_variance":  # nn.BatchNorm2d's running variance
        from chip_smoke import unbiased_stats_fault

        monkeypatch.setattr(V, "batch_norm", unbiased_stats_fault(BN.batch_norm))
    heat = {}
    hook = model.model_keypoint_head.register_forward_hook(
        lambda m, a, o: heat.__setitem__("heat", o.detach().numpy()))
    loss, new = T.loss_fn(model, torch.from_numpy(case["x"]), torch.from_numpy(case["target"]),
                          masks)
    hook.remove()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return model, heat["heat"], loss.item(), dict(zip(names, grads))


def _errors(case, model, heat, loss, grads):
    worst = max((_rel(g.numpy(), case["grads"][k].numpy()), k) for k, g in grads.items())
    state = model.state_dict()
    stats = max(_rel(state[k].numpy(), v.numpy()) for k, v in case["stats"].items()
                if not k.endswith("tracked"))
    return {"heat": _rel(heat, case["heat"]),
            "loss": abs(loss - case["loss"]) / abs(case["loss"]),
            "grad": worst[0], "grad_worst": worst[1], "stats": stats}


def test_train_mode_matches_flax_from_jax_draws(case):
    masks = case["masks"]
    assert masks.shape == (12, 2, B) and set(np.unique(masks)) <= {0.0, 1.0}
    assert masks[1:].min() == 0.0  # some branch is dropped: the masks are in play
    model, heat, loss, grads = _port_step(case)
    assert np.abs(case["heat"]).std() > 1e-3  # alive
    assert sorted(grads) == sorted(case["grads"])
    err = _errors(case, model, heat, loss, grads)
    assert err["heat"] <= HEAT_TOL, err
    assert err["loss"] <= LOSS_TOL, err
    assert err["grad"] <= GRAD_TOL, err
    assert err["stats"] <= STATS_TOL, err
    assert {int(v) for k, v in model.state_dict().items() if k.endswith("tracked")} == {1}


@pytest.mark.parametrize("fault", ["no_keep_scaling", "running_stats_in_training",
                                   "unbiased_variance"])
def test_planted_faults_break_the_limits(case, monkeypatch, fault):
    err = _errors(case, *_port_step(case, monkeypatch, fault))
    if fault == "unbiased_variance":
        assert err["stats"] > STATS_TOL, err
    else:
        assert err["heat"] > HEAT_TOL and err["grad"] > GRAD_TOL, err


def test_drop_rates_and_draws():
    rates = V.drop_path_rates()
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.3)
    np.testing.assert_allclose(np.diff(rates), 0.3 / 11, rtol=1e-12)
    model, _ = get_detector("vitpose", "table", resolution=(32, 32), train=True)
    assert [getattr(model.model_backbone, f"blocks_{i}").drop_path for i in range(12)] == rates
    # one Bernoulli(1 - rate) per sample and branch; block 0 keeps everything
    g = torch.Generator().manual_seed(0)
    masks = V.draw_drop_masks(g, 20000)
    keep = masks.mean(2)
    assert torch.equal(masks[0], torch.ones(2, 20000))
    np.testing.assert_allclose(keep.numpy(), 1 - np.array(rates)[:, None].repeat(2, 1),
                               atol=0.012)
    # in training mode the masks are required: the trainer draws them from its generator
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="drop_masks"):
        model(x)
    # out of training mode the masks are ignored
    model.eval()
    a = model(x)[0]
    torch.testing.assert_close(a, model(x, torch.zeros(12, 2, 3))[0], rtol=0, atol=0)


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


@pytest.mark.parametrize("task,detector", [("ball", BallDetector), ("table", TableDetector)])
def test_cli_trains_vitpose_and_saves_a_loadable_checkpoint(tiny_tthq, tmp_path, task,
                                                            detector):
    save = tmp_path / "ckpt"
    T.main(["--task", task, "--model", "vitpose", "--data_root", tiny_tthq, "--batch_size",
            "2", "--num_epochs", "1", "--val_iterations", "2", "--max_steps", "2",
            "--resolution", "64", "48", "--eval_resolution", "128", "96",
            "--save_dir", str(save), "--logdir", str(tmp_path / "runs"), "--device", "cpu"])
    (ckpt,) = glob.glob(str(save / f"{task}_vitpose_*" / "model.pt"))
    state, _, info = load_checkpoint(ckpt)
    assert info["model"] == "vitpose" and info["resolution"] == [64, 48]
    # two steps: the head's BatchNorms moved twice; the token grid of 64x48 is 3x4
    assert {int(v) for k, v in state.items() if k.endswith("tracked")} == {2}
    assert state["model_backbone.pos_embed"].shape == (1, 13, 384)
    det = detector("vitpose", checkpoint=ckpt, chunk=2, resolution=(64, 48), device="cpu")
    frames = np.random.default_rng(1).integers(0, 255, (3, 96, 128, 3), dtype=np.uint8)
    if task == "ball":
        pos, _ = det.predict([(frames[0], frames[1], frames[2])])
        assert pos.shape == (1, 3) and np.isfinite(pos).all()
    else:
        kp, _ = det.predict(list(frames))
        assert kp.shape == (3, 13, 3) and np.isfinite(kp).all()
