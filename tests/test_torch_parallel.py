"""The port's data parallelism (`parallel/`, `run_detection --dp`, the pipeline's and
datagen's `mesh`) on the CPU: one process, and two gloo processes.

One card can only run a world of one, so several ranks are tested here, with gloo:

* the helpers, single-process: no-op initialisation, rank 0 of 1, `main_process_only`,
  `local_batch_slice`; `make_mesh` / `shard_batch` / `replicate`, with JAX's errors;
* two gloo ranks (`tests/parallel_worker.py`) against one process on the global batch,
  in float64: a ViTPose `run_detection.train_step` (each rank the draws of the global
  batch, sliced; DDP; the BatchNorm statistics all-reduced over the ranks) and the
  `loss_fn` step of WASB and ViTPose on given inputs: the loss, every gradient and every
  running statistic within 1e-6 of their max. Without the all-reduce of the statistics a rank
  differs from the global step (held as a planted fault);
* the same `loss_fn` step of two ranks in f32 (ViTPose with JAX's drop masks) against
  JAX's step under a 2-device dp mesh (tests/test_parallel.py's pattern): the loss
  within 1e-5 relative, the running statistics within 1e-5 of their max (flax's f32 fast
  variance sits 1e-6 from the float64 statistic, tests/test_torch_hrnet_train.py), the
  gradients within 2e-4 of their max; WASB's f32 gradient is 2e-2 from its float64
  gradient in both packages, so there the two ranks must be no farther from the float64
  global step than twice JAX's distance from it;
* `TableTennisPipeline` over a two-entry CPU mesh against no mesh (`run_rally`: the
  filtered detections and table within 1e-4), the replicas on another device (`meta`),
  and a chunk the mesh's dp does not divide;
* `generate_dataset(mesh=...)` from per-device generators against single-device draws
  from those generators, concatenated in device order; `generate_production --dp` over
  two devices against `generate_dataset` with the same mesh and seeds.
"""
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from upliftingtabletennis_tpu.eval import metrics as jax_metrics
from upliftingtabletennis_tpu.models.factory import get_detector as jax_get_detector
from upliftingtabletennis_tpu.parallel.mesh import make_mesh as jax_make_mesh
from upliftingtabletennis_torch.parallel import distributed as D
from upliftingtabletennis_torch.parallel.mesh import make_mesh, replicate, shard_batch
from upliftingtabletennis_torch.utils.convert import flax_to_torch

import parallel_worker as PW

torch.set_num_threads(2)

DP_TOL = 1e-6
LOSS_TOL, GRAD_TOL, STATS_TOL = 1e-5, 2e-4, 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_helpers_single_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "NUM_PROCESSES", "PROCESS_ID", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert D.initialize_multihost(device="cpu") is False
    assert (D.process_count(), D.process_index()) == (1, 0)
    assert D.is_main_process() and D.local_batch_slice(32) == slice(0, 32)
    calls = []

    @D.main_process_only
    def log(x):
        calls.append(x)
        return x

    assert log(7) == 7 and calls == [7]
    t = torch.arange(3.0)
    assert D.all_reduce_mean(t) is t
    assert D.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank"):
        D.initialize_multihost(device="cpu")


def test_mesh_helpers():
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "mp": 2}
    assert make_mesh(devices=["cpu"] * 3).shape == {"dp": 3, "mp": 1}
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        make_mesh(3, 2, devices=["cpu"] * 4)
    parts = shard_batch(make_mesh(2, devices=["cpu", "cpu"]),
                        {"x": torch.arange(8.0).view(4, 2), "y": [torch.arange(4)]})
    assert torch.equal(parts[1]["x"], torch.tensor([[4.0, 5.0], [6.0, 7.0]]))
    assert torch.equal(parts[0]["y"][0], torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(make_mesh(3, devices=["cpu"] * 3), torch.zeros(4))
    idx, none = shard_batch(make_mesh(2, devices=["cpu", "cpu"]), (torch.arange(4), None))[1]
    assert torch.equal(idx, torch.tensor([2, 3])) and none is None
    # a module is its own copy on its device, and a deep copy on any other
    lin = torch.nn.Linear(2, 2)
    reps = replicate(make_mesh(2, devices=["cpu", "meta"]), lin)
    assert reps[0] is lin and reps[1] is not lin and reps[1].weight.device.type == "meta"
    assert replicate(make_mesh(2, devices=["cpu", "cpu"]), lin) == [lin, lin]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mesh_step(name, task, res, variables, imgs, target, key):
    """JAX's train-mode loss step with the batch sharded over a 2-device dp mesh: loss,
    gradients, new statistics (torch names) and the drop masks it drew (ViTPose)."""
    model, _ = jax_get_detector(name, task, train=True)
    mesh = jax_make_mesh(n_dp=2, devices=jax.devices()[:2])
    shard, rep = NamedSharding(mesh, P("dp")), NamedSharding(mesh, P())
    orig, draws = jax.random.bernoulli, []
    EH, EW = target.shape[-2:]

    def spy(k, p, shape=None):
        out = orig(k, p, shape)
        draws.append(out)
        return out

    def loss_fn(params, x, t):
        draws.clear()
        jax.random.bernoulli = spy
        try:
            out, new = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   x, mutable=["batch_stats"], rngs={"dropout": key})
        finally:
            jax.random.bernoulli = orig
        heat = out[0] if isinstance(out, tuple) else out
        logits = jnp.moveaxis(heat, -1, 1)
        logits = jax.image.resize(logits, (*logits.shape[:2], EH, EW), "bilinear")
        masks = (jnp.stack([d.reshape(-1) for d in draws]).astype(jnp.float32)
                 if draws else jnp.zeros((0,)))
        return jax_metrics.weighted_mse_loss(logits, t), (new["batch_stats"], masks)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, (stats, masks)), grads = step(jax.device_put(variables["params"], rep),
                                         jax.device_put(jnp.asarray(imgs), shard),
                                         jax.device_put(jnp.asarray(target), shard))
    masks = np.asarray(masks)
    if masks.size:
        B = imgs.shape[0]
        masks = np.concatenate([np.ones((1, 2, B), np.float32), masks.reshape(-1, 2, B)])
    else:
        masks = None
    return {"loss": float(loss), "grads": flax_to_torch({"params": jax.device_get(grads)}),
            "stats": flax_to_torch({"batch_stats": jax.device_get(stats)}), "masks": masks}


def _cases():
    """(cases for the ranks, JAX's mesh steps by case name)."""
    rng = np.random.default_rng(0)
    cases, jax_res = [], {}
    for name, task, res, B, C in (("wasb", "ball", (64, 48), 4, 9),
                                  ("vitpose", "ball", (64, 64), 2, 9)):
        W, H = res
        jmodel, _ = jax_get_detector(name, task, train=True)
        variables = jax.device_get(jax.jit(jmodel.init)(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, H, W, C))))
        variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
        variables["batch_stats"] = jax.tree.map(lambda a: a + 0.2, variables["batch_stats"])
        state = flax_to_torch(variables)
        base = {"model": name, "task": task, "resolution": res, "state": state, "batch": B}
        images = torch.from_numpy(rng.uniform(0, 255, (B, 2 * H, 2 * W, C)).astype(np.float32))
        coords = torch.from_numpy(rng.uniform([10, 10], [2 * W - 10, 2 * H - 10],
                                              (B, 3, 2)).astype(np.float32))
        f64 = {"dtype": torch.float64}
        if name == "vitpose":  # the trainer's step: the global draws and drop masks, sliced
            cases.append({**base, **f64, "name": f"{name}_train_step", "kind": "train_step",
                          "images": images, "coords": coords, "vis": torch.ones(B, 3),
                          "eval_res": (2 * W, 2 * H), "seed": 7})
        imgs = rng.normal(size=(B, H, W, C)).astype(np.float32)
        target = np.asarray(jax_metrics.render_gaussian_heatmaps(
            jnp.asarray(rng.uniform([0, 0], [W, H], (B, 1, 2)).astype(np.float32)),
            jnp.ones((B, 1)), H, W, 3.0))
        jres = _jax_mesh_step(name, task, res, variables, imgs, target, jax.random.PRNGKey(3))
        jax_res[f"{name}_loss_step"] = jres
        step = {**base, "kind": "loss_step", "imgs": torch.from_numpy(imgs.copy()),
                "target": torch.from_numpy(target.copy()),
                "masks": None if jres["masks"] is None else torch.from_numpy(jres["masks"])}
        cases += [{**step, "name": f"{name}_loss_step"},
                  {**step, **f64, "name": f"{name}_loss_step64"}]
    return cases, jax_res


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    cases, jax_res = _cases()
    d = tmp_path_factory.mktemp("dp")
    torch.save(cases, d / "spec.pt")
    torch.multiprocessing.spawn(PW.run, args=(2, _free_port(), str(d / "spec.pt"), str(d)),
                                nprocs=2, join=True)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    single = {c["name"]: PW.step(c) for c in cases}
    return cases, ranks, single, jax_res


def _compare(got, want):
    """Relative errors of a step against another: the loss, the worst gradient tensor
    (of its max |grad|), the largest gradient where the other's is zero, the worst
    running statistic."""
    errs = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "grad": max(_rel(g.double(), want["grads"][k].double())
                        for k, g in got["grads"].items()
                        if want["grads"][k].abs().max() > 0)}
    zero = [k for k, g in want["grads"].items() if not g.abs().max() > 0]
    errs["zero_grads"] = max([float(got["grads"][k].abs().max()) for k in zero] + [0.0])
    buffers = want.get("buffers", want.get("stats"))
    errs["stats"] = max(_rel(got["buffers"][k].double(), v.double())
                        for k, v in buffers.items() if "running" in k)
    return errs


@pytest.mark.parametrize("name", ["vitpose_train_step", "wasb_loss_step64",
                                  "vitpose_loss_step64"])
def test_two_gloo_ranks_equal_the_global_step(two_ranks, name):
    """In float64, where WASB's gradient is well conditioned (in f32 it is 2e-2 from the
    float64 gradient in both packages, tests/test_torch_hrnet_train.py): the sums over
    two ranks are the global batch's to rounding."""
    _, ranks, single, _ = two_ranks
    for r in ranks:  # every rank holds the global step's loss, gradients and statistics
        errs = _compare(r[name], single[name])
        assert errs["loss"] <= DP_TOL and errs["grad"] <= DP_TOL, errs
        assert errs["stats"] <= DP_TOL and errs["zero_grads"] == 0.0, errs
        assert {int(v) for k, v in r[name]["buffers"].items() if k.endswith("tracked")} == {1}


@pytest.mark.parametrize("model", ["wasb", "vitpose"])
def test_two_gloo_ranks_equal_jax_mesh_step(two_ranks, model):
    """The f32 step of two ranks against JAX's f32 step under a 2-device mesh: the loss
    and statistics within their limits; the gradients within GRAD_TOL of JAX's, or, where
    f32 itself is that far off (WASB), no farther from the float64 global step than twice
    JAX's own distance from it."""
    _, ranks, single, jax_res = two_ranks
    got, want, exact = ranks[0][f"{model}_loss_step"], jax_res[f"{model}_loss_step"], \
        single[f"{model}_loss_step64"]
    errs = _compare(got, want)
    assert errs["loss"] <= LOSS_TOL and errs["stats"] <= STATS_TOL, errs
    if errs["grad"] > GRAD_TOL:
        port = _compare(got, exact)["grad"]
        jax_off = max(_rel(want["grads"][k], g) for k, g in exact["grads"].items()
                      if g.abs().max() > 0)
        assert port <= 2 * jax_off, (port, jax_off, errs)


def test_rank_local_statistics_differ_from_the_global_step(two_ranks):
    """The planted fault: each rank's statistics its own (no all-reduce), rank 0's half
    of the WASB float64 loss step: the statistics and gradients leave the limit."""
    cases, _, single, _ = two_ranks
    case = next(c for c in cases if c["name"] == "wasb_loss_step64")
    half = dict(case, batch=2, imgs=case["imgs"][:2], target=case["target"][:2])
    errs = _compare(PW.step(half), single["wasb_loss_step64"])
    assert errs["stats"] > DP_TOL and errs["grad"] > DP_TOL, errs


def _pipeline(mesh, chunk=8):
    from upliftingtabletennis_torch.pipeline.interface import (BallDetector, TableDetector,
                                                               TableTennisPipeline,
                                                               UpliftingModel)

    pipe = TableTennisPipeline.__new__(TableTennisPipeline)
    pipe.ball_detector = BallDetector("wasb", chunk=chunk, resolution=(96, 64), device="cpu")
    pipe.ball_detector_aux = BallDetector("wasb", chunk=chunk, resolution=(96, 64), device="cpu")
    pipe.table_detector = TableDetector("hrnet", chunk=chunk, resolution=(96, 64), device="cpu")
    pipe.table_detector_aux = TableDetector("hrnet", chunk=chunk, resolution=(96, 64),
                                            device="cpu")
    pipe.uplifting_model = UpliftingModel(size="small", device="cpu")
    pipe.KEYPOINT_VISIBLE = 1
    pipe.mesh = mesh
    return pipe


def test_pipeline_over_a_two_entry_mesh_matches_no_mesh():
    from upliftingtabletennis_torch.pipeline.interface import TableTennisPipeline

    frames = np.random.default_rng(5).integers(0, 255, (18, 64, 96, 3), dtype=np.uint8)
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    one = _pipeline(None).run_rally(frames, fps=50)
    pipe = _pipeline(mesh)
    two = pipe.run_rally(frames, fps=50)
    # both entries are the CPU: the detectors are their own replicas there
    assert [dets for _, dets in pipe._replicas()] == [pipe._detectors()] * 2
    # on another device each detector gets a copy of its model, one for a detector in
    # two roles
    other = _pipeline(make_mesh(2, devices=["cpu", "meta"]))
    other.ball_detector_aux = other.ball_detector
    (_, home), (dev, away) = other._replicas()
    assert home == other._detectors() and dev == torch.device("meta")
    assert away[0] is away[1] and away[0] is not other.ball_detector
    assert all(d.device == dev and next(d.model.parameters()).device == dev for d in away)
    np.testing.assert_allclose(two["table"], one["table"], rtol=1e-4, atol=1e-4)
    assert two["ball"].shape == one["ball"].shape
    np.testing.assert_allclose(two["ball"], one["ball"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(two["valid_idx"], one["valid_idx"])
    single = _pipeline(make_mesh(1, devices=["cpu"])).run_rally(frames, fps=50)
    np.testing.assert_array_equal(single["ball"], one["ball"])
    with pytest.raises(ValueError, match="divisible"):
        TableTennisPipeline(chunk=8, mesh=make_mesh(3, devices=["cpu"] * 3))


def test_sharded_datagen_concatenates_per_device_draws_in_order():
    from upliftingtabletennis_torch.data import datagen as DG

    mesh = make_mesh(2, devices=["cpu", "cpu"])
    batch, n = 256, 12
    res = DG.generate_dataset(n, "intermediate", "left_to_right", batch=batch, mesh=mesh,
                              generator=[torch.Generator().manual_seed(s) for s in (3, 4)])
    gens = [torch.Generator().manual_seed(s) for s in (3, 4)]
    want, total, rounds = {k: [] for k in ("positions", "bounces", "n_bounces")}, 0, 0
    while total < n:
        rounds += 1
        for g in gens:  # device order within each round
            cand = DG.generate_candidates(batch, "intermediate", "left_to_right", g, "cpu")
            idx = torch.nonzero(cand["accept"])[:, 0][:max(batch // 8, 64)]
            for k in want:
                want[k].append(cand[k][idx].numpy())
            total += len(idx)
    assert res["candidates"] == rounds * 2 * batch
    for k, v in want.items():
        np.testing.assert_array_equal(res[k], np.concatenate(v)[:n])
    with pytest.raises(ValueError, match="generator"):
        DG.generate_dataset(4, mesh=mesh, generator=[torch.Generator()])
    # a one-device mesh with one generator is the run without a mesh
    a = DG.generate_dataset(4, batch=batch, mesh=make_mesh(1, devices=["cpu"]),
                            generator=torch.Generator().manual_seed(9))
    b = DG.generate_dataset(4, batch=batch, generator=torch.Generator().manual_seed(9),
                            device="cpu")
    np.testing.assert_array_equal(a["positions"], b["positions"])


def test_generate_production_dp_over_two_devices(tmp_path, monkeypatch):
    from upliftingtabletennis_torch.data import datagen as DG
    from upliftingtabletennis_torch.data import generate_production as GP
    from upliftingtabletennis_torch.data import synthetic as SYN

    monkeypatch.setattr(GP, "_dp_devices", lambda dev: [torch.device("cpu")] * 2)
    out = tmp_path / "store"
    shards = GP.main(["--out", str(out), "--scale", "0.0001", "--modes", "intermediate",
                      "--batch", "256", "--seed", "11", "--device", "cpu", "--dp"])
    assert [s["accepted"] for s in shards] == [5, 5]
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    gens = [torch.Generator().manual_seed(11 + i) for i in range(2)]
    for direction in DG.DIRECTIONS:  # the shards draw one after another from the same pair
        want = SYN.store_from_datagen(DG.generate_dataset(5, "intermediate", direction,
                                                          batch=256, mesh=mesh, generator=gens))
        got = SYN.load_store_npz(os.path.join(out, "intermediate", f"{direction}.npz"))
        assert len(got) == len(want) == 5
        for f in ("blur_positions", "rotations", "bounces"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
