"""The physics fit of the port (core/fitting.py, TableTennisPipeline.fit_physics) against
the JAX package.

A topspin state (tests/test_fitting.py's GT_TOP) is simulated by the JAX package and
projected through tests/test_fitting.py's broadcast camera; both packages fit the same
track from the same starts. Float64 is where the two are held to the same function
(the JAX fit is jitted whole, the port runs eagerly, so their float32 roundings differ
and a multi-start search may amplify them), with tolerances of rounding size:

- `_loss_terms` and its gradient (JAX: `jax.grad`; port: the S1 autograd Function over
  the plain tangent) at the same starts: 1e-10 relative;
- one LM step and a small `_run_fit` (Adam and LM) fed JAX's own `default_inits`:
  every start's final loss within 1e-9 relative, the winner and its state within 1e-9;
- `inits_from_draws` fed JAX's draws: 1e-12 relative in float64, 1e-5 in float32.

The fit's warm start through `fit_physics` runs in float32 and is judged by outcome, as
tests/test_fitting.py judges the JAX one: mean 3D error under 10 cm and the spin's sign.
Horizons stay at 60-127 frames and budgets at a few steps: the plain physics runs
eagerly on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.core import fitting as JF
from upliftingtabletennis_tpu.core import geometry as JG
from upliftingtabletennis_tpu.core.physics import BallState as JBallState
from upliftingtabletennis_tpu.core.physics import simulate_jit as jax_simulate
from upliftingtabletennis_torch.core import fitting as F
from upliftingtabletennis_torch.core import geometry as G
from upliftingtabletennis_torch.core import physics as P
from upliftingtabletennis_torch.pipeline.interface import TableTennisPipeline

torch.set_num_threads(1)

GT_TOP = ((-1.1, 0.25, 1.05), (7.0, -0.6, 0.8), (5.0, 90.0, -15.0))  # local w_y > 0
N_FRAMES = 60  # the float64 parity fits' horizon
N_STARTS = 4
REL = 1e-9


def _camera():
    """tests/test_fitting.py's broadcast-like camera, in float64 numpy."""
    c = np.array([0.0, -9.0, 2.2])
    f = (np.array([0.0, 0.0, 0.9]) - c) / np.linalg.norm(np.array([0.0, 0.0, 0.9]) - c)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r = r / np.linalg.norm(r)
    Mext = G.get_Mext(*(torch.from_numpy(a) for a in (c, f, r))).numpy()
    Mint = np.array([[2033.0, 0, 960.0], [0, 2180.0, 540.0], [0, 0, 1.0]])
    return Mint, Mext


def _observe(n_obs, stride, n_frames, dtype, jax_truth=True):
    """GT_TOP simulated (by the JAX package, or by the port's plain version) and projected
    at frames 0, stride, ...: (obs, times, mask, Mint, Mext, 3D truth) as numpy of
    `dtype`."""
    Mint, Mext = (a.astype(dtype) for a in _camera())
    idx = np.arange(n_obs) * stride
    if jax_truth:
        with jax.enable_x64(dtype == np.float64):
            traj = jax_simulate(JBallState(*(jnp.asarray(a, dtype) for a in GT_TOP)), n_frames, 2)
            gt3 = np.asarray(traj.r)[idx]
    else:
        gt3 = P.simulate(P.BallState(*(torch.tensor(a, dtype=torch.float32) for a in GT_TOP)),
                         n_frames).r.numpy()[idx]
    obs = G.world2img(*_t(gt3, Mext, Mint)).numpy()
    return obs, (idx / 500.0).astype(dtype), np.ones(n_obs, dtype), Mint, Mext, gt3


@pytest.fixture(scope="module")
def track():
    """The float64 track and JAX's starts for it (PRNGKey(0))."""
    obs, times, mask, Mint, Mext, _ = _observe(8, 8, N_FRAMES, np.float64)
    with jax.enable_x64():
        inits = JF.default_inits(jax.random.PRNGKey(0), *map(jnp.asarray, (obs, times, mask, Mint,
                                                                           Mext)), N_STARTS)
        q0 = np.asarray(JF._state_to_params(inits))
    return obs, times, mask, Mint, Mext, q0


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def test_positions_at_times_matches_jax():
    traj = np.random.default_rng(0).normal(size=(10, 4, 3))
    times = np.array([0.0, 2.5 / 500, 7.99 / 500, 9.0 / 500, 20.0 / 500])
    with jax.enable_x64():
        want = np.asarray(JF.positions_at_times(jnp.asarray(traj), jnp.asarray(times)))
    got = F.positions_at_times(*_t(traj, times))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    ramp = torch.arange(10, dtype=torch.float32)[:, None] * torch.ones(1, 3)
    out = F.positions_at_times(ramp, torch.tensor([2.5 / 500.0]))
    np.testing.assert_allclose(out.numpy(), 2.5 * np.ones((1, 3)), atol=1e-6)


def test_loss_terms_and_adam_gradient_match_jax(track):
    """With the Huber data term (the LM and Adam parity fits below run without it) and
    one start's speed above MAX_SPEED, so the penalty's gradient counts too."""
    huber_px = 3.0
    obs, times, mask, Mint, Mext, q0 = track
    q = q0 + np.random.default_rng(1).normal(0, 0.05, q0.shape)
    q[0, 3:6] = (4.0, 0.5, 0.3)  # 40.4 m/s
    args = (obs, times, mask, Mint, Mext)
    with jax.enable_x64():
        @jax.jit
        def total(qq):
            d, p = JF._loss_terms(qq, *map(jnp.asarray, args), N_FRAMES, 2, 1e-3, huber_px)
            return jnp.sum(d + p), (d, p)

        (_, (jd, jp)), jg = jax.value_and_grad(total, has_aux=True)(jnp.asarray(q))
    qt = torch.tensor(q, requires_grad=True)
    d, p = F._loss_terms(qt, *_t(*args), N_FRAMES, 2, 1e-3, huber_px)
    (g,) = torch.autograd.grad((d + p).sum(), qt)
    assert float(np.asarray(jp)[0]) > 0
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=1e-10)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(jg)).max())


def _compare_fits(got, want):
    np.testing.assert_allclose(got.all_loss.numpy(), want.all_loss, rtol=REL)
    assert int(got.best) == int(want.best)
    for g, w in zip(got.state0, want.state0):
        np.testing.assert_allclose(g.numpy(), w, rtol=REL, atol=REL)
    np.testing.assert_allclose(got.r_world.numpy(), want.r_world, rtol=REL, atol=REL)
    for name in ("loss", "reproj_px", "basin_spread_m"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("adam_steps,lm_steps", [(0, 1), (4, 2)], ids=["one_lm_step", "adam_lm"])
def test_run_fit_matches_jax(track, adam_steps, lm_steps):
    """(0, 1): one LM step from JAX's starts (every start's loss after it, accepted or
    rejected, and the winner); (4, 2): the whole fit at a small budget."""
    obs, times, mask, Mint, Mext, q0 = track
    kw = dict(n_frames=N_FRAMES, substeps=2, dt=1e-3, adam_steps=adam_steps, lm_steps=lm_steps,
              lr=0.03, huber_px=None)
    with jax.enable_x64():
        want = JF._run_fit(*map(jnp.asarray, (q0, obs, times, mask, Mint, Mext)), **kw)
        want = jax.tree.map(np.asarray, want)
    got = F._run_fit(*_t(q0, obs, times, mask, Mint, Mext), **kw)
    _compare_fits(got, want)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_inits_from_jax_draws_match_default_inits(track, dtype, rtol):
    obs, times, mask, Mint, Mext, _ = track
    args = [a.astype(dtype) for a in (obs, times, mask, Mint, Mext)]
    with jax.enable_x64(dtype == np.float64):
        key = jax.random.PRNGKey(3)
        want = JF.default_inits(key, *map(jnp.asarray, args), 8)
        k_z, k_v, k_w, k_m = jax.random.split(key, 4)
        draws = {"z_t": jax.random.uniform(k_z, (8,), dtype, minval=0.85, maxval=1.9),
                 "v_mult": jax.random.uniform(k_m, (8, 1), dtype, minval=0.7, maxval=1.3),
                 "v_noise": jax.random.normal(k_v, (8, 3), dtype),
                 "w_noise": jax.random.normal(k_w, (8, 3), dtype)}
        draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    got = F.inits_from_draws(draws, *_t(*args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=rtol)


def test_draw_inits_seeded_and_in_range():
    a = F.draw_inits(64, torch.Generator().manual_seed(5), device="cpu")
    b = F.draw_inits(64, torch.Generator().manual_seed(5), device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert a["z_t"].shape == (64,) and a["v_mult"].shape == (64, 1)
    assert (a["z_t"] >= 0.85).all() and (a["z_t"] < 1.9).all()
    assert (a["v_mult"] >= 0.7).all() and (a["v_mult"] < 1.3).all()


def test_draw_inits_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        F.draw_inits(4)


def test_fit_trajectory_draws_equal_the_generators():
    """`draws=` (a dict of `draw_inits`) gives the fit the generator's starts."""
    obs, times, mask, Mint, Mext, _ = _observe(6, 8, 48, np.float32, jax_truth=False)
    kw = dict(n_frames=42, n_starts=2, adam_steps=2, lm_steps=1, device="cpu")
    want = F.fit_trajectory(obs, times, mask, Mint, Mext,
                            generator=torch.Generator().manual_seed(7), **kw)
    draws = F.draw_inits(2, torch.Generator().manual_seed(7), device="cpu")
    got = F.fit_trajectory(obs, times, mask, Mint, Mext,
                           draws={k: v.numpy() for k, v in draws.items()}, **kw)
    for g, w in zip((*got.state0, got.r_world, got.all_loss), (*want.state0, want.r_world,
                                                                want.all_loss)):
        assert torch.equal(g, w)


def test_fit_witness_holds_jax_tracks_and_draws():
    """tests/fit_witness_1s.npz (tests/make_fit_witness.py, read by chip_smoke.py's fit
    phase): its tracks are the JAX package's simulation through the simulation camera
    (1e-3 px, 1e-6 m), its draws JAX's from each PRNGKey (1e-6 relative), and its JAX
    fits' spin classes and errors agree with their own positions."""
    import importlib.util
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("make_fit_witness",
                                                  os.path.join(here, "make_fit_witness.py"))
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)
    d = np.load(W.OUT)
    for name in W.STATES:
        obs, times, truth, Mint, Mext = W.track(name)
        np.testing.assert_allclose(d[f"{name}/obs"], obs, atol=1e-3, rtol=0)
        np.testing.assert_allclose(d[f"{name}/truth"], truth, atol=1e-6, rtol=0)
        for k, v in (("times", times), ("Mint", Mint), ("Mext", Mext)):
            np.testing.assert_array_equal(d[f"{name}/{k}"], v)
        assert W.n_frames_of(times) == 502
        for key in W.KEYS:
            p = f"{name}/key{key}/"
            for k, v in W.draws_of(key).items():
                np.testing.assert_allclose(d[p + k], np.asarray(v), rtol=1e-6, atol=1e-6)
            err = 100 * np.linalg.norm(d[p + "r_world"] - truth, axis=-1).mean()
            assert abs(err - float(d[p + "mean_err_cm"])) < 1e-3
            assert float(d[p + "spin_class"]) == W.spin_class(d[p + "state0"][6:],
                                                              d[p + "r_world"])


def test_fit_physics_seed_conversion_matches_jax():
    """`init=(spin_local, pos3d)` -> the seed state, as the JAX fit_physics converts it."""
    rng = np.random.default_rng(0)
    pos3d = (np.linspace([-1.0, 0.2, 1.0], [0.5, -0.1, 0.9], 12)
             + 0.02 * rng.normal(size=(12, 3))).astype(np.float32)
    spin_local = np.array([3.0, 85.0, -10.0], np.float32)
    times = (np.arange(12) * 0.02).astype(np.float32)
    v0 = (pos3d[1] - pos3d[0]) / max(float(times[1] - times[0]), 1e-3)
    w_world = np.asarray(JG.inverse_transform_rotation_axes(jnp.asarray(spin_local),
                                                            jnp.asarray(pos3d)))
    seed = TableTennisPipeline.physics_seed((spin_local, pos3d), times)
    np.testing.assert_array_equal(seed.r.numpy(), pos3d[0])
    np.testing.assert_array_equal(seed.v.numpy(), v0)
    np.testing.assert_allclose(seed.w.numpy(), w_world, rtol=1e-6, atol=1e-5)
    assert TableTennisPipeline.physics_seed((spin_local, pos3d[:1]), times) is None


def test_fit_physics_warm_start_recovers_the_flight():
    """The public warm-start path (seeded with a perturbed truth) converges with a tiny
    budget: tests/test_fitting.py's bounds."""
    obs, times, _, Mint, Mext, gt3 = _observe(12, 10, 125, np.float32, jax_truth=False)
    spin_local = G.transform_rotation_axes(torch.tensor(GT_TOP[2]), torch.tensor(gt3)).numpy()
    pos3d = gt3 + 0.02 * np.random.default_rng(0).normal(size=gt3.shape).astype(np.float32)
    pipe = TableTennisPipeline.__new__(TableTennisPipeline)
    spin_fit, pos_fit, res = pipe.fit_physics(obs, times, Mint, Mext, init=(spin_local, pos3d),
                                              n_starts=6, adam_steps=4, lm_steps=3,
                                              device="cpu")
    err_cm = 100 * np.linalg.norm(pos_fit - gt3, axis=-1)
    assert err_cm.mean() < 10.0, err_cm.mean()
    assert spin_fit.shape == (3,)
    assert np.sign(spin_fit[1]) == np.sign(spin_local[1])
    assert float(res.reproj_px) < 3.0
    assert float(F.spin_class_from_fit(res)) == 1.0


def test_fit_trajectory_batch_runs_every_start_together():
    """Two tracks, seeded: one FitResult of (B, ...) tensors whose rows equal the
    single-track fits of the same starts."""
    obs, times, mask, Mint, Mext, gt3 = _observe(6, 8, 48, np.float32, jax_truth=False)
    seed = F.BallState(*(torch.tensor(a, dtype=torch.float32)[None].repeat(2, 1) for a in GT_TOP))
    kw = dict(n_frames=42, n_starts=2, adam_steps=2, lm_steps=1, device="cpu")
    stack = [np.stack([a, a]) for a in (obs, times, mask, Mint, Mext)]
    res = F.fit_trajectory_batch(*stack, init_state=seed, **kw)
    assert res.r_world.shape == (2, 6, 3) and res.all_loss.shape == (2, 2)
    np.testing.assert_allclose(res.r_world[0].numpy(), res.r_world[1].numpy(), atol=1e-6)
    assert (100 * np.linalg.norm(res.r_world[0].numpy() - gt3, axis=-1)).mean() < 10.0
