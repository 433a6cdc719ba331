"""The port's closed loop (`eval/closed_loop.py`) against the JAX package's.

* The protocol end to end at the JAX test's toy size: tests/test_torch_closed_loop_protocol.py
  (a file of its own, so that the test workers run the two files side by side).
* `ema_update` / `ema_finalize` bit-equal to JAX's on the same arrays; `ema_decay_for`
  equal.
* `warmup_cosine_lr` within 1e-7 of optax's `warmup_cosine_decay_schedule` at every step.
* One training step's loss (the heatmap MSE plus the soft-argmax L1) and gradients, WASB
  (remat) and segformerpp_b0, from JAX's weights and batch: the loss within 1e-5
  relative, every gradient within 2e-4 of its tensor's max |grad|; the targets equal.
  WASB's f32 gradient through its 60 train-mode BatchNorms is ill-conditioned: JAX's
  own f32 gradient is up to 3e-2 of its max from the float64 gradient of the same
  weights and batch, on 117 of 176 tensors at a fresh initialisation (69 from the
  committed weights), and the port's f32 gradient as far. Where the port misses JAX's
  f32 gradient by more than the limit, both packages run again in float64
  (`jax.enable_x64`): there the gradients must agree within the limit, and the port's
  f32 gradient must be within 5e-2 (the card trainer's limit) of JAX's float64 one.
  b0's gradients need no referee but for its five biases that are zero in exact
  arithmetic (a per-channel constant before the head's batch-statistics BatchNorm).
* The scoring of one fixed pipeline output: `evaluate_pipeline` of each package with
  the same sample and a pipeline stub that returns the same detections, camera, spin and
  positions gives the same result and diagnostics (within 1e-6 relative).
* Each committed port checkpoint under `upliftingtabletennis_torch/weights/closed_loop/`
  bit-equal to `flax_to_torch` of its Orbax checkpoint, with its metadata.
* The committed WASB and b0 detectors on one rendered frame at their 960x544: heatmaps
  within 2e-4 (WASB) and 2e-5 (b0) of their max, against the JAX detectors; their
  sub-pixel peaks at 1920x1080 within 1e-2 px of JAX's, on JAX's heatmaps and on the
  port's own.
f32 throughout; JAX pinned to full-f32 matmuls (tests/conftest.py).
"""
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from upliftingtabletennis_tpu.eval import closed_loop as JCL
from upliftingtabletennis_tpu.eval import metrics as JM
from upliftingtabletennis_tpu.models.factory import get_detector as jax_get_detector
from upliftingtabletennis_torch.eval import closed_loop as CL
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.pipeline.interface import BallDetector, TableDetector
from upliftingtabletennis_torch.utils.checkpoint import load_checkpoint
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
SCORE_RTOL = 1e-6
HEAT_TOL = {"wasb": 2e-4, "segformerpp_b0": 2e-5}
MAX_REFEREED = {"wasb": 176, "segformerpp_b0": 0}
ZERO_GRAD_REL = 1e-6
F32_NOISE_TOL = 5e-2  # the card trainer's gradient limit
PEAK_PX = 1e-2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "upliftingtabletennis_torch", "weights", "closed_loop")

def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_ema_helpers_are_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    p = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    for decay in (CL.EMA_DECAY, CL.ema_decay_for(150)):
        jema = [jnp.zeros_like(a) for a in p]
        tema = [torch.zeros(a.shape) for a in p]
        for t in range(1, 6):
            q = [a * (1 + 0.1 * t) for a in p]
            jema = JCL.ema_update(jema, [jnp.asarray(a) for a in q], decay)
            tema = CL.ema_update(tema, [torch.from_numpy(a) for a in q], decay)
            for j, e in zip(jema, tema):
                np.testing.assert_array_equal(e.numpy(), np.asarray(j))
        for j, e in zip(JCL.ema_finalize(jema, 5, decay), CL.ema_finalize(tema, 5, decay)):
            np.testing.assert_array_equal(e.numpy(), np.asarray(j))
    # constant parameters come back exactly (up to f32 rounding) at any step count
    for t in (1, 3, 50):
        ema = [torch.zeros(2)]
        w = torch.tensor([1.5, -2.0])
        for _ in range(t):
            ema = CL.ema_update(ema, [w])
        torch.testing.assert_close(CL.ema_finalize(ema, t)[0], w, rtol=1e-5, atol=0)
    for n in (1, 2, 20, 150, 1000, 1_000_000):
        assert CL.ema_decay_for(n) == JCL.ema_decay_for(n)


@pytest.mark.parametrize("train_steps", [2, 40, 600, 3000])
def test_schedule_matches_optax(train_steps):
    n_updates = train_steps
    warmup = min(min(100, max(10, n_updates // 20)), max(1, n_updates // 2))
    lr = 1e-3
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, n_updates, lr * 0.03)
    for step in range(n_updates + 3):
        assert abs(CL.warmup_cosine_lr(step, lr, warmup, n_updates)
                   - float(sched(step))) <= 1e-7 * lr / 1e-3


def _jax_loss(model, batch_stats, images, target, coords_m, vis, coord_weight=5.0,
              beta=20.0):
    """The JAX closed loop's loss (eval/closed_loop.py:339-363), as a function of params."""
    def soft_argmax_px(heat_bchw):
        B2, C, H2, W2 = heat_bchw.shape
        p = jax.nn.softmax((beta * heat_bchw).reshape(B2, C, -1), axis=-1).reshape(
            B2, C, H2, W2)
        ex = jnp.sum(p * jnp.arange(W2, dtype=jnp.float32)[None, None, None, :], axis=(-2, -1))
        ey = jnp.sum(p * jnp.arange(H2, dtype=jnp.float32)[None, None, :, None], axis=(-2, -1))
        return jnp.stack([ex, ey], axis=-1)

    def loss_fn(p):
        y, _ = model.apply({"params": p, "batch_stats": batch_stats}, images,
                           mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        heat = y[0] if isinstance(y, tuple) else y
        logits = jnp.moveaxis(heat, -1, 1)
        mse = JM.weighted_mse_loss(logits, target)
        OH, OW = logits.shape[-2:]
        l1 = jnp.abs(soft_argmax_px(logits) - coords_m) / jnp.asarray([OW, OH], jnp.float32)
        m = (vis > 0).astype(jnp.float32)[..., None]
        coord = jnp.sum(l1 * m) / jnp.maximum(jnp.sum(m) * 2, 1.0)
        return mse + coord_weight * coord

    return loss_fn


@pytest.mark.parametrize("name,task,hw", [("wasb", "ball", (48, 64)),
                                         ("segformerpp_b0", "table", (64, 64))])
def test_training_step_loss_and_gradients_match_jax(name, task, hw):
    from upliftingtabletennis_tpu.data.image_transforms import normalize_image

    H, W = hw
    n_ch, n_pts = (9, 1) if task == "ball" else (3, 13)
    jmodel, _ = jax_get_detector(name, task, train=True, remat=True)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, H, W, n_ch))))
    rng = np.random.default_rng(1)
    raw = rng.uniform(0, 255, (2, H, W, n_ch)).astype(np.float32)
    coords = rng.uniform([0, 0], [CL.EVAL_W, CL.EVAL_H], (2, n_pts, 2)).astype(np.float32)
    vis = (rng.uniform(size=(2, n_pts)) > 0.2).astype(np.float32)
    OH, OW = (H, W) if name == "wasb" else (H // 4, W // 4)
    sigma = max(6.0 * OW / CL.EVAL_W, 1.5)
    # JAX's batch (eval/closed_loop.py:310-322)
    coords_m = (jnp.asarray(coords) + 0.5) * jnp.asarray([OW / CL.EVAL_W, OH / CL.EVAL_H]) - 0.5
    target = JM.render_gaussian_heatmaps(coords_m, jnp.asarray(vis), OH, OW, sigma)
    images = normalize_image(jnp.asarray(raw))
    got_batch = CL.make_batch(torch.from_numpy(raw), torch.from_numpy(coords),
                              torch.from_numpy(vis), n_pts, (OH, OW), sigma)
    np.testing.assert_allclose(got_batch[0].numpy(), np.asarray(images), atol=1e-6)
    np.testing.assert_allclose(got_batch[2].numpy(), np.asarray(coords_m), atol=1e-4)
    np.testing.assert_allclose(got_batch[1].numpy(), np.asarray(target), atol=1e-5)

    loss_fn = _jax_loss(jmodel, variables.get("batch_stats", {}), images, target, coords_m,
                        jnp.asarray(vis))
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want_grads = flax_to_torch({"params": jax.device_get(want_grads)})

    model, _ = get_detector(name, task, train=True, remat=True)
    model.load_state_dict(flax_to_torch(variables), strict=True)
    loss, _, _ = CL.detector_loss(model, *(torch.from_numpy(np.array(a)) for a in
                                           (images, target, coords_m, vis)))
    grads = torch.autograd.grad(loss, list(model.parameters()), materialize_grads=True)
    grads = {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)}
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    # gradients zero in exact arithmetic: below 1e-6 of the model's largest on both sides
    gmax = max(float(np.abs(v.numpy()).max()) for v in want_grads.values())
    zero = [k for k in grads if np.abs(want_grads[k].numpy()).max() <= ZERO_GRAD_REL * gmax]
    for k in zero:
        assert np.abs(grads[k]).max() <= ZERO_GRAD_REL * gmax, k
    off = {k: _rel(g, want_grads[k].numpy()) for k, g in grads.items() if k not in zero}
    refereed = sorted(k for k, e in off.items() if e > GRAD_TOL)
    if refereed:  # the referee: both packages in float64
        with jax.enable_x64():
            f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               (variables, images, target, coords_m, vis))
            fn = _jax_loss(jmodel, f64[0].get("batch_stats", {}), *f64[1:])
            exact = jax.jit(jax.grad(fn))(f64[0]["params"])
            exact = {k: v.double().numpy() for k, v in
                     flax_to_torch({"params": jax.device_get(exact)}).items()}
        model.double()
        loss64, _, _ = CL.detector_loss(model, *(torch.from_numpy(np.array(a)).double()
                                                 for a in (images, target, coords_m, vis)))
        g64 = torch.autograd.grad(loss64, list(model.parameters()), materialize_grads=True)
        g64 = {n: g.numpy() for (n, _), g in zip(model.named_parameters(), g64)}
        for k in refereed:
            assert _rel(g64[k], exact[k]) <= GRAD_TOL, k
            assert _rel(grads[k], exact[k]) <= F32_NOISE_TOL, k
    assert len(refereed) <= MAX_REFEREED[name], refereed


def _fixed_rally(T=20):
    """One held-out rally's sample (the fields evaluate_pipeline reads) and a pipeline
    output on it: detections near the truth, one keypoint invisible, a camera."""
    rng = np.random.default_rng(5)
    L = 50
    mask = np.zeros((1, L), np.float32)
    mask[0, :T] = 1
    r_world = np.zeros((1, L, 3), np.float32)
    r_world[0, :T] = np.stack([np.linspace(-1.2, 1.0, T), np.linspace(0.2, -0.1, T),
                               1.0 + 0.3 * np.sin(np.linspace(0, 3, T))], -1)
    r_img = np.zeros((1, L, 2), np.float32)
    r_img[0, :T] = rng.uniform([400, 300], [2100, 1100], (T, 2))
    table_img = np.concatenate([rng.uniform([300, 400], [2200, 1200], (1, 13, 2)),
                                np.ones((1, 13, 1))], -1).astype(np.float32)
    times = (np.arange(L, dtype=np.float32) / 50.0)[None] * mask
    Mint = np.array([[[1800.0, 0, 1280], [0, 1800.0, 720], [0, 0, 1]]], np.float32)
    Mext = np.eye(4, dtype=np.float32)[None]
    Mext[0, 2, 3] = 9.0
    sample = {"r_img": r_img, "mask": mask, "table_img": table_img, "r_world": r_world,
              "rotation": np.array([[10.0, -80.0, 5.0]], np.float32), "times": times,
              "Mint": Mint, "Mext": Mext, "hits": np.array([[0.21]], np.float32)}
    ball_eval = (r_img[0, :T] + 0.5) * 0.75 - 0.5
    vi = np.arange(T - 2)[::2]  # interior frames 1..T-2, every other one kept
    table_eval = (table_img[0, :, :2] + 0.5) * 0.75 - 0.5
    table = np.concatenate([table_eval + rng.normal(0, 1.0, (13, 2)), np.ones((13, 1))], -1)
    table[4, 2] = 0
    out = {"ball": (ball_eval[vi + 1] + rng.normal(0, 0.8, (len(vi), 2))).astype(np.float32),
           "valid_idx": vi, "times": times[0, vi + 1], "table": table.astype(np.float32),
           "spin": np.array([3.0, 40.0, -2.0], np.float32),
           "pos3d": (r_world[0, vi + 1] + rng.normal(0, 0.05, (len(vi), 3))).astype(np.float32)}
    calib = (np.array([[1350.0, 0, 960], [0, 1350.0, 540], [0, 0, 1]], np.float32),
             np.array([[1, 0, 0, 0.1], [0, 1, 0, 0.0], [0, 0, 1, 9.2], [0, 0, 0, 1]],
                      np.float32), 9)
    return sample, out, calib


def test_scoring_of_a_fixed_pipeline_output_matches_jax(tmp_path, monkeypatch):
    from upliftingtabletennis_tpu.data import synthetic as JSYN
    from upliftingtabletennis_torch.data import synthetic as PSYN

    sample, out, calib = _fixed_rally()
    n = 5  # the test split holds trajectory 4
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(n, 60, 3)).astype(np.float32), np.ones((n, 60), bool),
              np.zeros((n, 3), np.float32), np.zeros((n, 1), np.float32),
              np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
              np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)))
    args = types.SimpleNamespace(n_eval=1, uplifting_checkpoint=None, render_res=(960, 544),
                                 skip_physics_fit=True, physfit_min_rallies=8)

    class Stub:
        device = torch.device("cpu")

        def run_rally(self, frames, fps):
            assert frames.shape == (20, 1080, 1920, 3) and fps == pytest.approx(50.0)
            return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in out.items()}

        def calibrate_camera(self, table):
            return calib

    results, ckpts = {}, {"ball": None, "table": None}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        args.out = str(d)
        if pkg == "jax":
            monkeypatch.setattr(JSYN, "assemble_batch", lambda key, s, idx, train=True: {
                k: jnp.asarray(v) for k, v in sample.items()})
            monkeypatch.setattr(JCL, "_pipeline_from", lambda *a, **k: Stub())
            res = JCL.evaluate_pipeline(JSYN.TrajectoryStore(*arrays), ckpts, args)
        else:
            monkeypatch.setattr(PSYN, "assemble_batch", lambda s, idx, train=True, **k: {
                k2: torch.from_numpy(v) for k2, v in sample.items()})
            res = CL.evaluate_pipeline(PSYN.TrajectoryStore(*arrays), ckpts, args, pipe=Stub())
        diags = [json.load(open(d / f)) for f in ("ball_frame_diag.json", "rally_diag.json")]
        results[pkg] = (res, diags)
    (want, want_diag), (got, got_diag) = results["jax"], results["port"]
    assert set(got) == set(want) and want["n_rallies"] == 1
    assert {"spin_accuracy", "spin_macro_f1", "ball_pck@2", "table_pck@20"} <= set(got)

    def close(a, b, what):
        if isinstance(b, dict):
            assert set(a) == set(b), what
            for k in b:
                close(a[k], b[k], f"{what}.{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), what
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{what}[{i}]")
        elif isinstance(b, float):
            assert a == pytest.approx(b, rel=SCORE_RTOL, abs=1e-9), what
        else:
            assert a == b, what

    close(got, want, "result")
    # the port's rally_diag.json also keeps each rally's calibration input and output
    extra = {"resolution": [1920, 1080], "table_kp": np.asarray(out["table"]).tolist(),
             "table_truth": None, "calib_Mint": np.asarray(calib[0]).tolist(),
             "calib_Mext": np.asarray(calib[1]).tolist()}
    for rally in got_diag[1]:
        assert set(rally) == set(want_diag[1][0]) | set(extra)
        np.testing.assert_allclose(rally.pop("table_truth"), sample["table_img"][0, :, :2]
                                   * np.float32(0.75) - np.float32(0.125), atol=1e-4)
        for k, v in extra.items():
            if v is not None:
                np.testing.assert_allclose(rally.pop(k), v, rtol=1e-6, err_msg=k)
    close(got_diag, want_diag, "diagnostics")


@pytest.mark.parametrize("name", ["ball_detector", "table_detector", "uplifting"])
def test_committed_weights_are_the_converted_orbax_checkpoints(name):
    import make_closed_loop_weights as MW

    want, ident, info = MW.converted(name)
    got, got_ident, got_info = load_checkpoint(os.path.join(WEIGHTS, name))
    assert (got_ident, got_info) == (ident, info)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    if name != "uplifting":
        assert info["render_res"] == [960, 544] and info["task"] in name


@functools.lru_cache(maxsize=None)
def _rendered_heatmaps(task, name):
    """(JAX's heatmap, the port's) of a committed detector on one rendered 1080p frame
    (triplet for the ball) resized to the detectors' trained 960x544, NHWC f32 numpy."""
    from upliftingtabletennis_tpu.data import render_rally as JR
    from upliftingtabletennis_tpu.data.image_transforms import normalize_image
    from upliftingtabletennis_tpu.data.synthetic import sample_cameras
    from upliftingtabletennis_tpu.core.geometry import TABLE_POINTS, world2img
    from upliftingtabletennis_tpu.utils.checkpoint import load_checkpoint as jax_load

    Mint, Mext = sample_cameras(jax.random.PRNGKey(7), ())
    up, ev = (2560, 1440), (1920, 1080)
    table = JR.rescale_px(world2img(jnp.asarray(TABLE_POINTS), Mext, Mint), up, ev)
    ctx = JR.rescale_px(JR.project_context(Mint, Mext), up, ev)
    ball = jnp.asarray([[900.0, 400.0], [930.0, 395.0], [960.0, 392.0]])
    frames = JR.render_frames(jax.random.PRNGKey(0), ball, jnp.ones(3), table, height=1080,
                              width=1920, context_px=ctx)
    frames = frames if task == "ball" else frames[1:2]
    small = jax.image.resize(frames.astype(jnp.float32), (len(frames), 544, 960, 3),
                             "bilinear", antialias=False)
    x = normalize_image(jnp.concatenate(list(jnp.round(small)), -1)[None])

    variables, _, info = jax_load(os.path.join(REPO, "artifacts", "closed_loop",
                                               f"{task}_detector"))
    jmodel, _ = jax_get_detector(name, task)
    y = jax.jit(jmodel.apply)(jax.device_get(variables), x)
    want = np.asarray(y[0] if isinstance(y, tuple) else y)
    det = (BallDetector if task == "ball" else TableDetector)(
        name, os.path.join(WEIGHTS, f"{task}_detector"), 1, resolution=(960, 544),
        device="cpu")
    with torch.no_grad():
        got = det._forward(torch.from_numpy(np.asarray(x))).numpy()
    return want, got


@pytest.mark.parametrize("task,name", [("ball", "wasb"), ("table", "segformerpp_b0")])
def test_committed_detectors_match_jax_on_a_rendered_frame(task, name):
    want, got = _rendered_heatmaps(task, name)
    assert want.std() > 1e-2
    assert _rel(got, want) <= HEAT_TOL[name]


@pytest.mark.parametrize("task,name", [("ball", "wasb"), ("table", "segformerpp_b0")])
def test_peaks_of_committed_detectors_match_jax(task, name):
    """`extract_peaks` (the detectors' and run_detection_eval's decode) on the heatmaps of
    the trained detectors, at 1920x1080 with each task's threshold: the port's on JAX's
    heatmap within PEAK_PX of JAX's (the same 20-step f32 LM on the same 3x3 windows,
    tests/test_torch_pipeline.py's limit on synthetic blobs) with the same visibility;
    the port's on its own heatmap within PEAK_PX of JAX's on JAX's."""
    from upliftingtabletennis_tpu.ops.peak import extract_peaks as jax_extract_peaks
    from upliftingtabletennis_torch.ops.peak import extract_peaks

    want, got = _rendered_heatmaps(task, name)
    thr = float("-inf") if task == "ball" else 0.1
    ref = np.asarray(jax_extract_peaks(jnp.moveaxis(jnp.asarray(want), -1, 1), 1920, 1080, thr))
    for heat in (want, got):
        peaks = extract_peaks(torch.from_numpy(heat).permute(0, 3, 1, 2), 1920, 1080, thr).numpy()
        np.testing.assert_array_equal(peaks[..., 2], ref[..., 2])
        assert np.abs(peaks[..., :2] - ref[..., :2]).max() <= PEAK_PX
    assert ref[..., 2].sum() >= (1 if task == "ball" else 10)  # the detections are there
