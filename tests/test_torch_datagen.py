"""Synthetic-trajectory generation of the port (data/datagen.py, data/generate.py,
data/simulation_check.py) against the JAX package.

JAX's own initial conditions (and JAX's own uniform draws) go through both packages'
validation. In float64 every rule's output is equal: accept, frame_valid, n_bounces
exactly, bounce times within 1e-12 s. In float32 the two simulations round
differently, so a candidate whose contact or cut lies on a knife edge may be judged
differently: at least 95% of the accept decisions must agree (all of them did on the
cases below). The sampler's map from draws to states is held within 1e-12 in float64
(atan2 and sin/cos round differently) and 1e-4 in float32 (angles in degrees of up to
a few hundred, through sin and cos).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.core.geometry import TABLE_HEIGHT, TABLE_LENGTH, TABLE_WIDTH
from upliftingtabletennis_tpu.data import datagen as JDG
from upliftingtabletennis_torch.core import physics as P
from upliftingtabletennis_torch.data import datagen as DG
from upliftingtabletennis_torch.data.generate import main as gen_main
from upliftingtabletennis_torch.data.simulation_check import (plot_trajectories_3d,
                                                              resimulate_check)

torch.set_num_threads(1)
F32_AGREEMENT = 0.95
CASES = [("intermediate", "left_to_right", 128), ("first_short", "right_to_left", 64),
         ("final_win", "left_to_right", 64)]


def _np_count_hits(positions, direction):
    """Independent numpy re-implementation of the reference's hit counting
    (tests/test_data_pipeline.py's oracle)."""
    hits = {"opponent": [], "own": [], "ground": []}
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    if direction == "left_to_right":
        opp = (-0.01 > x) & (x > -TABLE_LENGTH / 2)
        own = (TABLE_LENGTH / 2 > x) & (x > 0.01)
    else:
        opp = (TABLE_LENGTH / 2 > x) & (x > 0.01)
        own = (-0.01 > x) & (x > -TABLE_LENGTH / 2)
    low = z < TABLE_HEIGHT + 0.04
    ony = np.abs(y) < TABLE_WIDTH / 2
    masks = {"opponent": low & ony & opp, "own": low & ony & own, "ground": z <= 0.08}
    for name, m in masks.items():
        start = None
        for i, b in enumerate(m):
            if b and (i == 0 or not m[i - 1]):
                start = i
            if not b and i != 0 and m[i - 1]:
                end = i - 1
                t = 0.75 * (end + start) / 2 / 500 + 0.25 * (np.argmin(z[start:end + 1]) + start) / 500
                hits[name].append(t)
    return hits


def _jax_case(mode, direction, n, x64):
    """JAX's draws, initial conditions and candidates for PRNGKey(3)."""
    with jax.enable_x64(x64):
        dtype = jnp.float64 if x64 else jnp.float32
        key = jax.random.PRNGKey(3)
        k = jax.random.split(key, 10)
        u = np.stack([np.asarray(jax.random.uniform(k[i], (n,), dtype)) for i in range(10)])
        state0 = [np.asarray(a) for a in JDG.sample_initial_conditions(key, n, mode, direction)]
        cand = {name: np.asarray(v)
                for name, v in JDG.generate_candidates(key, n, mode, direction).items()}
    return u, state0, cand


@pytest.mark.parametrize("mode,direction,n", CASES)
def test_validation_on_jax_initial_conditions_matches_jax(mode, direction, n):
    u, state0, want = _jax_case(mode, direction, n, x64=True)
    got_ic = DG.initial_conditions_from_draws(torch.tensor(u), mode, direction)
    for g, w in zip(got_ic, state0):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-12)
    got = DG.validate_candidates(P.BallState(*(torch.tensor(a) for a in state0)), mode, direction)
    for name in ("accept", "frame_valid", "n_bounces"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    np.testing.assert_allclose(got["bounces"].numpy(), want["bounces"], rtol=0, atol=1e-12)
    # the port divides the frame index by 500 exactly; XLA multiplies by the float32
    # reciprocal (one rounding more): within one float32 ulp
    np.testing.assert_allclose(got["times"].numpy(), want["times"], rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(got["positions"].numpy(), want["positions"], rtol=0, atol=1e-7)
    if mode == "intermediate":
        assert want["accept"].sum() >= 2


@pytest.mark.parametrize("mode,direction,n", CASES[:1])
def test_validation_float32_agrees_with_jax(mode, direction, n):
    u, state0, want = _jax_case(mode, direction, n, x64=False)
    got_ic = DG.initial_conditions_from_draws(torch.tensor(u), mode, direction)
    for g, w in zip(got_ic, state0):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    got = DG.validate_candidates(P.BallState(*(torch.tensor(a) for a in state0)), mode, direction)
    agree = (got["accept"].numpy() == want["accept"]).mean()
    assert agree >= F32_AGREEMENT, agree
    same = got["accept"].numpy() & want["accept"]
    np.testing.assert_array_equal(got["n_bounces"].numpy()[same], want["n_bounces"][same])


@pytest.mark.parametrize("mode,direction", [("intermediate", "left_to_right"),
                                            ("intermediate", "right_to_left"),
                                            ("first_long", "left_to_right")])
def test_accepted_candidates_satisfy_the_oracle(mode, direction):
    """The port of tests/test_data_pipeline.py::test_datagen_accepted_satisfy_oracle, on
    the port's own seeded candidates."""
    c = DG.generate_candidates(256, mode, direction, torch.Generator().manual_seed(0),
                               device="cpu")
    acc = c["accept"].numpy()
    assert acc.any(), "no accepted trajectories in 256 candidates"
    pos, fv = c["positions"].numpy(), c["frame_valid"].numpy()
    sig = DG.BOUNCE_SIGNATURE[mode]
    for i in np.nonzero(acc)[0][:10]:
        n = int(fv[i].sum())
        hits = _np_count_hits(pos[i, :n], direction)
        assert len(hits["opponent"]) == sig[0], (i, hits)
        assert len(hits["own"]) == sig[1]
        assert len(hits["ground"]) == sig[2]
        assert pos[i, :n, 2].max() <= (1.4 if "first" in mode else 1.8) + 1e-6
        assert n >= DG.MIN_TRAJ_LEN_FRAMES
        bounces = c["bounces"].numpy()[i, :int(c["n_bounces"][i])]
        np.testing.assert_allclose(np.sort(hits["opponent"] + hits["own"]), bounces, atol=1e-6)


def test_count_hits_matches_jax():
    rng = np.random.default_rng(0)
    z = np.abs(np.sin(np.linspace(0, 9, 200)))[None] * 0.9 + rng.uniform(0, 0.2, (4, 200))
    pos = np.stack([np.linspace(-1.3, 1.3, 200)[None].repeat(4, 0), rng.uniform(-0.6, 0.6, (4, 200)),
                    z], -1)
    valid = np.arange(200)[None] < np.array([[200], [150], [90], [30]])
    with jax.enable_x64():
        want = JDG.count_hits(jnp.asarray(pos), jnp.asarray(valid), "right_to_left")
    got = DG.count_hits(torch.tensor(pos), torch.tensor(valid), "right_to_left")
    for name in ("opponent", "own", "ground"):
        for g, w in zip(got[name], want[name]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_generation_is_deterministic_from_a_seed():
    a, b = (DG.generate_candidates(32, "intermediate", "left_to_right",
                                   torch.Generator().manual_seed(7), device="cpu")
            for _ in range(2))
    for name in ("accept", "positions", "bounces"):
        assert torch.equal(a[name], b[name])
    s = DG.sample_initial_conditions(1000, "first_good", "right_to_left",
                                     torch.Generator().manual_seed(1), device="cpu")
    x = s.r[:, 0]
    assert ((x <= -1.0) & (x >= -2.5)).all()
    assert (torch.linalg.norm(s.v, dim=-1) <= 30.0 + 1e-4).all()


def test_sim_camera_matches_jax():
    Mext, Mint = JDG.sim_camera()
    got = DG.sim_camera("cpu")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(Mext), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(Mint))


@pytest.mark.parametrize("call", [lambda: DG.sim_camera(),
                                  lambda: DG.draw_initial_conditions(4),
                                  lambda: DG.sample_initial_conditions(4, "intermediate",
                                                                       "left_to_right")],
                         ids=["sim_camera", "draw_initial_conditions",
                              "sample_initial_conditions"])
def test_default_device_raises_without_cuda(call):
    """The public functions run on the card unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        call()


def test_cli_writes_the_reference_layout_and_resimulates(tmp_path):
    gen_main(["--num_trajectories", "3", "--mode", "intermediate", "--direction", "left_to_right",
              "--folder", str(tmp_path), "--batch", "256", "--device", "cpu"])
    ddir = os.path.join(str(tmp_path), "intermediate", "left_to_right")
    names = sorted(os.listdir(ddir))
    assert names == ["trajectory_0000", "trajectory_0001", "trajectory_0002"]
    files = sorted(os.listdir(os.path.join(ddir, names[0])))
    assert files == sorted(f"{f}.npy" for f in ("positions", "velocities", "rotations", "times",
                                                 "bounces", "Mext", "Mint"))
    pos = np.load(os.path.join(ddir, names[0], "positions.npy"))
    assert pos.shape[1] == 3 and len(pos) >= DG.MIN_TRAJ_LEN_FRAMES
    assert np.load(os.path.join(ddir, names[0], "Mext.npy")).shape == (len(pos), 4, 4)
    assert resimulate_check(ddir, n_check=3, atol=1e-4, device="cpu")
    out = plot_trajectories_3d([pos], save_path=str(tmp_path / "traj.png"))
    assert os.path.exists(out)


def test_generate_dataset_refuses_a_mesh():
    """A mesh needs one generator per dp device (tests/test_torch_parallel.py runs one)."""
    from upliftingtabletennis_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="1 generator"):
        DG.generate_dataset(8, mesh=mesh, generator=[torch.Generator()])
