"""The parity checks of tests/parity_checks.py reject a wrong port.

`check_peaks` (tests/test_torch_pipeline.py::test_detectors_match_jax_detectors),
`check_hypotheses` (tests/test_torch_calib_tail.py), `check_gradients`
(tests/test_torch_uplifting_train.py::test_full_width_loss_and_gradients_match_jax), the
hybrid basin spread of tests/test_torch_physics_fit_eval.py and `check_witness_track`
(tests/test_torch_fitting.py) hold a quantity that the host's rounding moves at a level
that it does not. Each case here gives one of them the port's own function with one
planted fault (its module's source with one line changed) on the data of the test it
serves, and asserts that the check rejects it; the case `none` gives it the port as it
is, which it must pass:

* peaks, on the b0 table detector's JAX heatmaps: the LM damping update swapped (`lam *
  4.0` after a step that improves the fit, `lam * 0.5` after one that does not); the fit
  window cut one pixel to the left of the argmax;
* hypotheses, on the witness rally 3 (tests/calib_tail_witness.npz), where the two
  packages' LM runs part on some hypotheses: the inlier threshold 0.5 px wider; the winner
  taken by an argmax over the wrong axis (the keypoint that is most often an inlier);
* gradients, on the full-width uplifting batch: the LayerNorm epsilon PyTorch's default
  (1e-5) in place of flax's (1e-6); the regression heads' second ReLU left out;
* the hybrid TT3D fit evaluation: the basin spread taken as the nearest near-tied start's
  distance (`amin`) in place of the farthest's (`amax`);
* the fit witness (no port function: JAX's track against the committed file): the
  committed camera moved by 0.1 mm.
"""
import inspect
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parity_checks import (check_gradients, check_hypotheses, check_peaks,
                           ill_conditioned_peaks, knife_edges)
from test_torch_calib_tail import W as TAIL_WITNESS
from test_torch_calib_tail import _errors
from test_torch_fitting import check_witness_track, witness_maker
from test_torch_physics_fit_eval import SPREAD_ABS_M, _compare, tt3d, tt3d_case  # noqa: F401
from test_torch_uplifting_train import (GRAD_TOL, MAX_KNIFE_EDGES, _as_list, _double,
                                        _torch_batch, full_width, setup)  # noqa: F401
from upliftingtabletennis_tpu.core import calibration as JC
from upliftingtabletennis_tpu.data.image_transforms import normalize_image as jax_normalize
from upliftingtabletennis_tpu.ops.peak import extract_peaks as jax_extract_peaks
from upliftingtabletennis_tpu.ops.resize import resize_bilinear_down as jax_resize
from upliftingtabletennis_tpu.pipeline.interface import TableDetector as JaxTableDetector
from upliftingtabletennis_torch import core
from upliftingtabletennis_torch.core import calibration as C
from upliftingtabletennis_torch.core import fitting
from upliftingtabletennis_torch.core.geometry import TABLE_POINTS
from upliftingtabletennis_torch.eval import run_physics_fit_eval as PF
from upliftingtabletennis_torch.models import uplifting
from upliftingtabletennis_torch.ops import peak
from upliftingtabletennis_torch.train import uplifting_train as UT
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)
RES = (1920, 1080)
RALLY = 3
FAULTS = {
    "peaks": {
        "damping_swapped": ("torch.where(better, lam * 0.5, lam * 4.0)",
                            "torch.where(better, lam * 4.0, lam * 0.5)"),
        "window_shifted": ("cols = (x_max[:, None] + off)[:, None, :]",
                           "cols = (x_max[:, None] + off - 1).clamp(min=0)[:, None, :]"),
    },
    "hypotheses": {
        "inlier_threshold_plus_half": ("(err < INLIER_THRESHOLD)",
                                       "(err < INLIER_THRESHOLD + 0.5)"),
        "argmax_wrong_axis": ("return inliers, n_in, n_in.argmax()",
                              "return inliers, n_in, inliers.sum(0).argmax()"),
    },
    "gradients": {
        "ln_eps_torch_default": ("LN_EPS = 1e-6", "LN_EPS = 1e-5"),
        "head_relu_dropped": ("self.fc3(torch.relu(self.fc2(", "self.fc3((self.fc2("),
    },
    "fit_eval": {
        "spread_nearest_tie": ("torch.zeros_like(r0_d)).amax(1)",
                               "torch.zeros_like(r0_d)).amin(1)"),
    },
    "witness": {"camera_moved_0.1mm": None},
}
MODULES = {"peaks": peak, "hypotheses": C, "gradients": uplifting, "fit_eval": fitting}
CASES = [(check, fault) for check, faults in FAULTS.items() for fault in ("none", *faults)]


def planted(module, check, fault):
    """`module` as it is (fault "none"), or a copy of it built from its source with the
    fault's one change."""
    if fault == "none" or module is None:
        return module
    old, new = FAULTS[check][fault]
    source = inspect.getsource(module)
    assert source.count(old) == 1, (module.__name__, old)
    copy = types.ModuleType(module.__name__ + "_planted")
    copy.__package__ = module.__package__
    exec(compile(source.replace(old, new), module.__file__, "exec"), copy.__dict__)
    return copy


@pytest.fixture(scope="module")
def peak_case():
    """test_detectors_match_jax_detectors' b0 table case: the JAX heatmaps (3, 13, 64, 96)
    of the seeded frames, the JAX peaks at 1920x1080 and the mask of the peaks that are not
    well conditioned."""
    jdet = JaxTableDetector("segformerpp_b0", chunk=2, resolution=(96, 64))
    jdet._ensure_init(3)
    frames = np.random.default_rng(8).integers(0, 256, size=(5, 108, 192, 3), dtype=np.uint8)
    x = jax_normalize(jax_resize(jnp.asarray(frames[:3]), 64, 96, exact=True))
    out = jax.jit(jdet.model.apply)(jdet._variables, x)
    want = np.moveaxis(np.asarray(out[0] if isinstance(out, tuple) else out), -1, 1).copy()

    def jax_peaks(hm):
        return np.asarray(jax_extract_peaks(jnp.asarray(hm), *RES, threshold=0.1))

    return want, jax_peaks(want), ill_conditioned_peaks(jax_peaks, want,
                                                        2e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def hypothesis_case():
    """The witness rally's keypoints, JAX's draws of PRNGKey(42) and the reprojection
    distances of JAX's 100 hypothesis cameras in float64 (as tests/test_torch_calib_tail.py)."""
    kp = TAIL_WITNESS["keypoints"][RALLY]
    with jax.enable_x64():
        keys = jax.random.split(jax.random.PRNGKey(42), C.RANSAC_ITERS)
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (13,)))(keys))
        p3, p2, v = (jnp.asarray(a, jnp.float64) for a in (TABLE_POINTS, kp[:, :2], kp[:, 2]))
        w = jax.vmap(lambda k: JC._sample_hypothesis_weights(k, v))(keys)
        Ki, Ei, _ = jax.jit(jax.vmap(lambda wi: JC.refine_camera_multistart(
            p3, p2, wi, RES, JC.dlt_calib(p3, p2, v))))(w)
    return kp, torch.from_numpy(u), _errors(Ki, Ei, kp[:, :2])


@pytest.fixture(scope="module")
def fit_eval_case(tt3d):
    """test_eval_tt3d_fit_matches_jax[hybrid]'s JAX result, the port's args and the draws."""
    return tt3d_case(tt3d, True)


@pytest.fixture(scope="module")
def witness_case():
    """The first state's track in tests/fit_witness_1s.npz and the JAX package's remake."""
    W = witness_maker()
    name = next(iter(W.STATES))
    d = np.load(W.OUT)
    return {k: d[f"{name}/{k}"] for k in ("obs", "times", "truth", "Mint", "Mext")}, W.track(name)


@pytest.mark.parametrize("check,fault", CASES)
def test_rewritten_check_rejects_planted_fault(check, fault, request, monkeypatch):
    port = planted(MODULES.get(check), check, fault)
    if check == "peaks":
        want, jpos, ill = request.getfixturevalue("peak_case")

        def run():
            pos = port.extract_peaks(torch.from_numpy(want), *RES, threshold=0.1).numpy()
            check_peaks(pos, jpos, want, ill, *RES)
    elif check == "hypotheses":
        kp, u, err_j = request.getfixturevalue("hypothesis_case")
        p3, p2, v = (torch.as_tensor(a, dtype=torch.float64)
                     for a in (TABLE_POINTS, kp[:, :2], kp[:, 2]))
        Ki, Ei, _ = C.refine_camera_multistart(p3, p2, C._sample_hypothesis_weights(u, v), RES,
                                               C.dlt_calib(p3, p2, v))
        n_in_j = ((err_j < JC.INLIER_THRESHOLD) & (kp[:, 2] > 0)).sum(1)

        def run():
            _, n_in, best = port._score_hypotheses(p3, p2, v, Ki, Ei)
            check_hypotheses(_errors(Ki, Ei, kp[:, :2]), err_j, n_in.numpy(), best, n_in_j,
                             JC.INLIER_THRESHOLD)
    elif check == "fit_eval":
        want, args, draws = request.getfixturevalue("fit_eval_case")
        monkeypatch.setattr(core, "fitting", port)  # eval_tt3d_fit imports it when called
        monkeypatch.setitem(sys.modules, fitting.__name__, port)

        def run():
            _compare(PF.eval_tt3d_fit(args, device="cpu", draws=draws), want, SPREAD_ABS_M)
    elif check == "witness":
        saved, made = request.getfixturevalue("witness_case")
        if fault != "none":
            saved = dict(saved, Mext=saved["Mext"].copy())
            saved["Mext"][:3, 3] += 1e-4

        def run():
            check_witness_track(saved, made)
    else:
        _, params, vg = request.getfixturevalue("full_width")
        grads_j = vg(params)[1]
        model = port.get_uplifting_model("connectstage", "large", "dynamic")
        model.load_state_dict(flax_to_torch({"params": jax.device_get(params)}))
        batch = _torch_batch(request.getfixturevalue("setup")[3])

        def run():
            grads = torch.autograd.grad(UT.loss_fn(model, batch)[0], list(model.parameters()))
            names = [n for n, _ in model.named_parameters()]
            units = knife_edges(model.double(), lambda m: UT.loss_fn(m, _double(batch))[0],
                                MAX_KNIFE_EDGES)
            check_gradients(names, [g.numpy() for g in grads],
                            [w.numpy() for w in _as_list(model, grads_j)], units, GRAD_TOL)
    if fault == "none":
        run()
    else:
        with pytest.raises(AssertionError):
            run()
