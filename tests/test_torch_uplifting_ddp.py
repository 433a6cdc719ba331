"""Data parallelism of the uplifting trainer: two gloo ranks against one process.

The loss is not a mean over samples (`train/uplifting_train.py`): the rotation term is a
sum over the batch and the position term a masked sum over sum(mask) of the whole batch.
So each rank divides by the all-reduced sum(mask) and scales by the world size before
DDP averages the gradients. Held here, on connectstage small from JAX's initial weights
and a seeded batch whose masks differ between the two halves (the ranks' slices):

* one step on two gloo ranks (`tests/uplifting_ddp_worker.py`) against the step in one
  process on the global batch, in float64: the loss terms, the gradients that reach the
  clip / Adam / EMA update and the parameters after it, within 1e-6 of their largest
  magnitude (DDP_TOL), identical on both ranks;
* a planted fault (each rank dividing by its own sum(mask)) must break that limit;
* the loss terms against JAX's step on a two-device mesh (tests/test_parallel.py's
  `make_train_step` with the batch sharded over 'dp'), f32, within 1e-5 (LOSS_RTOL);
* the CLI (`run_uplifting.main`) over two gloo ranks launched as torchrun launches them
  (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT) against one process on the same store:
  the first step's logged losses within 1e-5, and nothing written by rank 1.
"""
import json
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uplifting_ddp_worker as W
from uplift_data import analytic_datagen
from upliftingtabletennis_tpu.models import get_uplifting_model as jax_get_model
from upliftingtabletennis_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from upliftingtabletennis_tpu.train.uplifting_train import (Batch, create_train_state,
                                                            make_train_step)
from upliftingtabletennis_torch.utils.convert import flax_to_torch

DDP_TOL = 1e-6
LOSS_RTOL = 1e-5
B, T = 4, 50
LR = 1e-4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batch():
    """A seeded global batch; samples 0-1 (rank 0) are long, 2-3 (rank 1) short."""
    rng = np.random.default_rng(0)
    lengths = np.array([50, 44, 17, 9])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return {"ball_img": rng.uniform(0.2, 0.8, (B, T, 2)).astype(np.float32) * mask[..., None],
            "table_img": np.concatenate([rng.uniform(0.2, 0.8, (B, 13, 2)),
                                         np.ones((B, 13, 1))], -1).astype(np.float32),
            "mask": mask,
            "r_world": (rng.normal(size=(B, T, 3)) * mask[..., None]).astype(np.float32),
            "rotation": (rng.normal(size=(B, 3)) * 50).astype(np.float32),
            "times": ((np.arange(T, dtype=np.float32) / 50.0)[None] * mask)}


@pytest.fixture(scope="module")
def spec():
    batch = _batch()
    jmodel = jax_get_model("connectstage", "small", mode="dynamic")
    jbatch = Batch(**{k: jnp.asarray(v) for k, v in batch.items()})
    state, tx = create_train_state(jmodel, jax.random.PRNGKey(0), jbatch, LR)
    params = jax.device_get(state.params)
    return {"state": flax_to_torch({"params": params}),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "dtype": torch.float64, "lr": LR, "ema_decay": 0.999,
            "transform_mode": "global", "jax": (jmodel, jbatch)}


@pytest.fixture(scope="module")
def two_ranks(spec, tmp_path_factory):
    d = tmp_path_factory.mktemp("ddp")
    torch.save({k: v for k, v in spec.items() if k != "jax"}, d / "spec.pt")
    torch.multiprocessing.spawn(W.run, args=(2, _free_port(), str(d / "spec.pt"), str(d)),
                                nprocs=2, join=True)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, W.step(spec)


def _worst(got, want):
    """The largest relative error over the loss terms and every gradient and parameter
    tensor (of the tensor's max magnitude)."""
    errs = [abs(got["loss"][k] - v) / abs(v) for k, v in want["loss"].items()]
    for group in ("grads", "params"):
        for k, w in want[group].items():
            errs.append(float((got[group][k] - w).abs().max() / w.abs().max().clamp_min(1e-300)))
    return max(errs)


def test_two_gloo_ranks_equal_the_one_process_step(two_ranks):
    ranks, single = two_ranks
    for r in ranks:
        assert _worst(r["ddp"], single) <= DDP_TOL
    for group in ("grads", "params"):
        for k, v in ranks[0]["ddp"][group].items():
            assert torch.equal(v, ranks[1]["ddp"][group][k]), (group, k)


def test_local_mask_sum_breaks_the_limit(two_ranks):
    ranks, single = two_ranks
    for r in ranks:
        assert _worst(r["fault"], single) > 100 * DDP_TOL


def test_two_ranks_match_the_jax_mesh_step(spec, two_ranks):
    ranks, _ = two_ranks
    jmodel, jbatch = spec["jax"]
    mesh = make_mesh(n_dp=2, devices=jax.devices()[:2])
    with mesh:
        state, tx = create_train_state(jmodel, jax.random.PRNGKey(0), jbatch, LR)
        state = replicate(mesh, state)
        _, metrics = make_train_step(jmodel, tx)(state, shard_batch(mesh, jbatch))
    for k in ("loss", "loss_rot", "loss_pos"):
        want = float(metrics[k])
        assert abs(ranks[0]["ddp"]["loss"][k] - want) <= LOSS_RTOL * abs(want), k


def _cli_rank(rank, world, port, argv, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from upliftingtabletennis_torch.train import run_uplifting

    res = run_uplifting.main(argv + ["--save_dir", f"{out}/r{rank}/ckpt",
                                     "--logdir", f"{out}/r{rank}/runs"])
    torch.save({"history": res["history"]}, f"{out}/cli{rank}.pt")


def test_cli_over_two_gloo_ranks_matches_one_process(tmp_path):
    from upliftingtabletennis_torch.data import synthetic as SYN
    from upliftingtabletennis_torch.train import run_uplifting

    store = SYN.store_from_datagen(analytic_datagen(40, seed=3))
    SYN.save_store_npz(str(tmp_path / "data" / "intermediate" / "left_to_right.npz"), store)
    argv = ["--data_dir", str(tmp_path / "data"), "--model_size", "small", "--batch_size", "8",
            "--num_epochs", "1", "--device", "cpu"]
    torch.multiprocessing.spawn(_cli_rank, args=(2, _free_port(), argv, str(tmp_path)),
                                nprocs=2, join=True)
    one = run_uplifting.main(argv + ["--save_dir", str(tmp_path / "one" / "ckpt"),
                                     "--logdir", str(tmp_path / "one" / "runs")])
    logs = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path / "r0" / "runs") for f in fs
            if f == "metrics.jsonl"]
    first = json.loads(open(logs[0]).readline())
    one_log = [os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path / "one" / "runs")
               for f in fs if f == "metrics.jsonl"]
    want = json.loads(open(one_log[0]).readline())
    assert first["step"] == want["step"] == 0
    for k in ("train/loss", "train/loss rotation", "train/loss position"):
        assert abs(first[k] - want[k]) <= LOSS_RTOL * abs(want[k]), k
    assert not (tmp_path / "r1").exists() or not any(
        files for _, _, files in os.walk(tmp_path / "r1"))
    assert torch.load(tmp_path / "cli1.pt", weights_only=False)["history"]
    assert one["history"]
