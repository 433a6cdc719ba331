"""The port's SegFormer detector trainer (`train/run_detection.py`) against the JAX trainer.

* `loss_fn` on segformerpp_b0 (random JAX init carried over with `flax_to_torch`, 64x96,
  batch 2, the loss at 72x128): the loss within 1e-5 relative, every parameter's
  gradient within 2e-4 of its largest |grad| (the port's backward recomputes K1 and K2;
  the JAX CPU path runs the unfused block), the new batch statistics within 1e-5. The
  five biases whose gradient is zero in exact arithmetic (a per-channel constant before
  the head's batch-statistics BatchNorm) are named, and must be below 1e-6 of the
  model's largest |grad| on both sides;
* `apply_update` against `optax.chain(clip_by_global_norm(5.0), adam(lr))` and the EMA,
  fed the same gradients (Adam's first step is about lr * sign(g): gradients of two
  separate backward passes would compare noise), within 1e-6, with and without clipping;
* the CLI end to end on a tiny TTHQ layout (b0, ball and table, 128x96, 2 steps, a
  validation pass, on the CPU), whose checkpoint `BallDetector` / `TableDetector` loads;
  `--debug_nans`, and `--debug`, which implies it, turn on autograd anomaly detection
  (the JAX trainer's jax_debug_nans); `--data blurball` raises, and `--model vitpose`, `--dp`,
  `--torch_init` and `--hf_backbone` do their work (a missing file raises).
f32 throughout; JAX pinned to full-f32 matmuls (tests/conftest.py).
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upliftingtabletennis_tpu.eval import metrics as jax_metrics
from upliftingtabletennis_tpu.models.factory import get_detector as jax_get_detector
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
from upliftingtabletennis_torch.train import run_detection as T
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)


def test_loss_fn_gradients_and_batch_stats_match_jax():
    H, W, EH, EW, B = 64, 96, 72, 128, 2
    jmodel, _ = jax_get_detector("segformerpp_b0", "ball", train=True)
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(B, H, W, 9)).astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 9)))
    # shift the running statistics so the update of both is visible
    stats = jax.tree.map(lambda a: a + 0.3, variables["batch_stats"])
    coords = rng.uniform([0, 0], [EW, EH], (B, 1, 2)).astype(np.float32)
    target = np.asarray(jax_metrics.render_gaussian_heatmaps(
        jnp.asarray(coords), jnp.ones((B, 1)), EH, EW, 6.0))

    def jloss(p):
        (heat, _), new = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(imgs),
                                      mutable=["batch_stats"])
        logits = jnp.moveaxis(heat, -1, 1)
        logits = jax.image.resize(logits, (*logits.shape[:2], EH, EW), "bilinear")
        return jax_metrics.weighted_mse_loss(logits, jnp.asarray(target)), new

    (loss_j, new_j), grads_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])

    model, _ = get_detector("segformerpp_b0", "ball", train=True)
    model.load_state_dict(flax_to_torch({"params": variables["params"], "batch_stats": stats}))
    loss, new = T.loss_fn(model, torch.from_numpy(imgs), torch.from_numpy(target.copy()))
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))

    want = flax_to_torch({"params": grads_j})
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    top = max(np.abs(g.numpy()).max() for g in want.values())
    zero = set()
    for name, p in params.items():
        g = want[name].numpy()
        assert p.grad is not None, name
        if np.abs(g).max() < 1e-6 * top:  # zero in exact arithmetic: float noise both sides
            zero.add(name)
            assert np.abs(p.grad.numpy()).max() < 1e-6 * top, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=2e-4 * np.abs(g).max(),
                                   err_msg=name)
    # a constant per channel before the head's batch-statistics BatchNorm cancels: the
    # last stage norm's bias and the head's projection biases get no gradient
    assert zero == {"backbone.stage_norm_3.bias",
                    *(f"decode_head.linear_c{i}.bias" for i in range(4))}
    want_stats = flax_to_torch({"batch_stats": new_j["batch_stats"]})
    for name, v in want_stats.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(new[name].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_apply_update_matches_optax_chain_and_ema(scale):
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 5)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lr, decay = 1e-3, 0.999
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr))
    jp = jax.tree.map(jnp.asarray, params)
    state, jema = tx.init(jp), jp
    names = sorted(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    tema = [t.clone() for t in tp]
    tstate = T.init_adam(tp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        jema = jax.tree.map(lambda e, q: decay * e + (1 - decay) * q, jema, jp)
        T.apply_update(tp, [torch.from_numpy(g[k]) for k in names], tstate, tema, lr, decay)
    for k, t, e in zip(names, tp, tema):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(e.numpy(), np.asarray(jema[k]), rtol=1e-6, atol=1e-6)
    assert tstate["count"] == 3


@pytest.fixture(scope="module")
def fake_tthq(tmp_path_factory):
    """Tiny TTHQ tree (the layout of tests/test_detection_training.py): 2 videos of 8
    128x96 frames with a bright ball blob; video 1 is the val/test pool."""
    import cv2

    root = tmp_path_factory.mktemp("data")
    tthq = root / "tthq"
    rng = np.random.default_rng(0)
    rows_ball = ["video;frame;ball_x;ball_y;ball_flag"]
    rows_table = ["video;frame;" + ";".join(f"point_{k}_x;point_{k}_y;point_{k}_flag"
                                            for k in range(1, 14))]
    H, W = 96, 128
    for video in (1, 2):
        vdir = tthq / f"{video:02d}"
        vdir.mkdir(parents=True)
        for frame in range(8):
            img = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
            bx, by = rng.uniform(10, W - 10), rng.uniform(10, H - 10)
            cv2.circle(img, (int(bx), int(by)), 3, (255, 255, 255), -1)
            cv2.imwrite(str(vdir / f"{video:02d}_{frame:06d}.png"), img)
            if 1 <= frame <= 6:
                rows_ball.append(f"{video};{frame};{bx:.1f};{by:.1f};{2 if frame != 3 else 0}")
                pts = ";".join(f"{rng.uniform(5, W - 5):.1f};{rng.uniform(5, H - 5):.1f};2"
                               for _ in range(13))
                rows_table.append(f"{video};{frame};{pts}")
    (tthq / "ball_detection.csv").write_text("\n".join(rows_ball))
    (tthq / "table_detection.csv").write_text("\n".join(rows_table))
    return str(root)


def test_data_index_and_batches_match_jax(fake_tthq):
    from upliftingtabletennis_tpu.data import detection as JD
    from upliftingtabletennis_torch.data import detection as PD

    for mode in ("train", "val", "test"):
        for invis in (True, False):
            assert (PD.load_tthq_ball_index(fake_tthq, mode, invis)
                    == JD.load_tthq_ball_index(fake_tthq, mode, invis))
        got, want = PD.load_tthq_table_index(fake_tthq, mode), JD.load_tthq_table_index(
            fake_tthq, mode)
        assert [(s.video, s.frame) for s in got] == [(s.video, s.frame) for s in want]
        for s, t in zip(got, want):
            np.testing.assert_array_equal(s.keypoints, t.keypoints)
    samples = PD.load_tthq_ball_index(fake_tthq, "train")[:3]
    for n_in in (1, 3):
        for a, b in zip(PD.load_ball_batch(fake_tthq, samples, n_in),
                        JD.load_ball_batch(fake_tthq, samples, n_in)):
            np.testing.assert_array_equal(a, b)
    tsamples = PD.load_tthq_table_index(fake_tthq, "val")
    for a, b in zip(PD.load_table_batch(fake_tthq, tsamples),
                    JD.load_table_batch(fake_tthq, tsamples)):
        np.testing.assert_array_equal(a, b)
    batches = list(PD.Prefetcher(lambda i: i * i, 4))
    assert batches == [0, 1, 4, 9]
    with pytest.raises(ZeroDivisionError):
        list(PD.Prefetcher(lambda i: 1 // 0, 2))


@pytest.mark.parametrize("task", ["ball", "table"])
def test_cli_trains_validates_and_saves_a_loadable_checkpoint(fake_tthq, tmp_path, task):
    save = tmp_path / "ckpt"
    T.main(["--task", task, "--model", "segformerpp_b0", "--data_root", fake_tthq,
            "--batch_size", "2", "--num_epochs", "1", "--val_iterations", "2",
            "--max_steps", "2", "--resolution", "128", "96", "--eval_resolution", "256", "192",
            "--exp_id", "cli", "--save_dir", str(save), "--logdir", str(tmp_path / "runs"),
            "--device", "cpu"])
    (ckpt,) = glob.glob(str(save / f"{task}_segformerpp_b0_exp:cli_*" / "model.pt"))
    state, identifier, info = load_checkpoint(ckpt)
    assert identifier.startswith(f"{task}_segformerpp_b0_exp:cli_")
    assert info["resolution"] == [128, 96] and info["in_frames"] == (3 if task == "ball" else 1)
    # the EMA weights moved away from the initial ones, and the statistics were updated
    init, _ = get_detector("segformerpp_b0", task, train=True)
    T.init_weights(init, 42)
    assert any(not torch.equal(state[k], v) for k, v in init.state_dict().items()
               if k.startswith("backbone"))
    assert int(state["decode_head.fuse_bn.num_batches_tracked"]) == 2
    (log,) = glob.glob(str(tmp_path / "runs" / "*" / "metrics.jsonl"))
    rec = json.loads(open(log).read().splitlines()[-1])
    assert rec["it"] == 2 and all(f"pck{t}" in rec for t in (2, 5, 10, 20))
    assert np.isfinite(rec["loss"])
    frames = np.random.default_rng(3).integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    if task == "ball":
        det = BallDetector("segformerpp_b0", checkpoint=ckpt, device="cpu", resolution=(128, 96))
        pos, _ = det.predict([(frames[0], frames[1], frames[0])])
        assert pos.shape == (1, 3) and np.isfinite(pos).all()
    else:
        det = TableDetector("segformerpp_b0", checkpoint=ckpt, device="cpu", resolution=(128, 96))
        kps, _ = det.predict([frames[0]])
        assert kps.shape == (1, 13, 3) and np.isfinite(kps[..., :2]).all()


@pytest.mark.parametrize("flag", ["--debug_nans", "--debug"])
def test_cli_debug_nans_turns_on_anomaly_detection(fake_tthq, tmp_path, flag):
    """The JAX trainer's `--debug_nans` (and `--debug`, which implies it) is accepted and
    turns on the NaN check: autograd anomaly detection, for the steps of the run."""
    save, logs = tmp_path / "ckpt", tmp_path / "runs"
    assert not torch.is_anomaly_enabled()
    try:
        T.main(["--task", "ball", "--model", "segformerpp_b0", "--data_root", fake_tthq,
                "--batch_size", "2", "--num_epochs", "1", "--val_iterations", "2",
                "--max_steps", "1", "--resolution", "64", "64", "--eval_resolution", "128",
                "96", "--save_dir", str(save), "--logdir", str(logs), "--device", "cpu", flag])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    # --debug also sends the logs and checkpoints to <dir>_tmp
    suffix = "_tmp" if flag == "--debug" else ""
    assert glob.glob(str(tmp_path / f"ckpt{suffix}" / "*" / "model.pt"))
    assert glob.glob(str(tmp_path / f"runs{suffix}" / "*" / "metrics.jsonl"))


@pytest.mark.parametrize("flags,match", [(["--data", "blurball"], "no training samples")],
                         ids=["blurball"])
def test_cli_refuses_what_is_not_ported(tmp_path, flags, match):
    """`--data blurball` trains (tests/test_torch_blurball.py); on a root without the
    BlurBall layout it refuses before writing anything, where it would train no step."""
    with pytest.raises(ValueError, match=match):
        T.main(["--data_root", str(tmp_path), "--device", "cpu", *flags])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flags,error,match", [
    (["--model", "vitpose", "--resolution", "64", "64"], None, None),
    (["--dp", "2"], ValueError, "needs 2 processes"),
    (["--model", "wasb", "--torch_init", "missing.pth"], FileNotFoundError, "missing.pth"),
    (["--hf_backbone", "missing.pt"], FileNotFoundError, "missing.pt"),
], ids=["model", "dp", "torch_init", "hf_backbone"])
def test_cli_flags_once_refused_now_do_their_work(fake_tthq, tmp_path, flags, error, match):
    """`--model vitpose` trains; `--dp 2` in one process asks for its two processes (JAX's
    mesh refuses more devices than it has); `--torch_init` and `--hf_backbone` read their
    file, so a missing one raises FileNotFoundError."""
    argv = ["--task", "ball", "--data_root", fake_tthq, "--batch_size", "2", "--num_epochs",
            "1", "--val_iterations", "1", "--max_steps", "1", "--resolution", "64", "64",
            "--eval_resolution", "128", "96", "--save_dir", str(tmp_path / "ckpt"),
            "--logdir", str(tmp_path / "runs"), "--device", "cpu", *flags]
    if "--model" not in flags:
        argv += ["--model", "segformerpp_b0"]
    if error is None:
        T.main(argv)
        assert glob.glob(str(tmp_path / "ckpt" / "ball_vitpose_*" / "model.pt"))
        return
    with pytest.raises(error, match=match):
        T.main(argv)
    assert not glob.glob(str(tmp_path / "ckpt" / "*"))
