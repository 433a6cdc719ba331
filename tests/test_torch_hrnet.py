"""The port's HRNet detectors (CPU, folded plain path) against the JAX package.

`WASBNet` and `TableHRNet` of the port, with BatchNorm folded into the convs,
against flax `.apply` (BatchNorm on its running statistics) and against the
JAX package's folded, lane-packed path (`wasb_packed_apply`,
`table_hrnet_packed_apply`). Weights go across through
`utils/convert.py:flax_to_torch` with a strict `load_state_dict`; inputs are
seeded numpy arrays at 64x96, batch 2. Tolerance: max |torch - jax| <= 2e-4 *
max |jax| over the heatmap, the tolerance of tests/test_hrnet_packed.py; both
sides run in fp32 (tests/conftest.py pins JAX matmuls to f32), so what remains
is the folding and summation order through 16 BasicBlocks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.models.hrnet import TableHRNet as FlaxTableHRNet
from upliftingtabletennis_tpu.models.hrnet import WASBNet as FlaxWASBNet
from upliftingtabletennis_tpu.models.hrnet_packed import fold_bn as jax_fold_bn
from upliftingtabletennis_tpu.models.hrnet_packed import (table_hrnet_packed_apply,
                                                          wasb_packed_apply)
from upliftingtabletennis_torch.models import hrnet as port_hrnet
from upliftingtabletennis_torch.models.factory import get_detector
from upliftingtabletennis_torch.models.hrnet import TableHRNet, WASBNet, fold_bn
from upliftingtabletennis_torch.utils.convert import flax_to_torch

torch.set_num_threads(1)
REL_TOL = 2e-4
B, H, W = 2, 64, 96


def _perturbed_variables(model, channels, seed):
    """flax init, then non-trivial BatchNorm statistics and affine parameters.

    The means move both ways and the variances scale by 0.5-1.5, so the folding is
    exercised and the network stays alive: shifting both up, as
    tests/test_hrnet_packed.py does, leaves the table HRNet's heatmap channels almost
    constant (std 3e-7), which would hide a wrong fold."""
    variables = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                                   jnp.zeros((1, H, W, channels))))
    rng = np.random.default_rng(seed)

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

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _heat(out):
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _assert_alive(heat):
    """Every heatmap channel varies over the image (a dead network hides folding faults)."""
    assert heat.std(axis=(0, 1, 2)).min() > 1e-2


@pytest.fixture(scope="module")
def wasb():
    model = FlaxWASBNet()
    variables = _perturbed_variables(model, 9, seed=0)
    x = np.random.default_rng(1).normal(size=(B, H, W, 9)).astype(np.float32)
    apply = jax.jit(model.apply)
    return dict(variables=variables, x=x, apply=apply, want=_heat(apply(variables, x)),
                packed=_heat(jax.jit(wasb_packed_apply)(variables, x)), port=WASBNet)


@pytest.fixture(scope="module")
def table():
    model = FlaxTableHRNet()
    variables = _perturbed_variables(model, 3, seed=2)
    x = np.random.default_rng(3).normal(size=(B, H, W, 3)).astype(np.float32)
    return dict(variables=variables, x=x, want=_heat(jax.jit(model.apply)(variables, x)),
                packed=_heat(jax.jit(table_hrnet_packed_apply)(variables, x)), port=TableHRNet)


def _port_heat(case, variables=None, model=None):
    model = model or case["port"]()
    model.load_state_dict(flax_to_torch(variables or case["variables"]), strict=True)
    model.eval()
    with torch.no_grad():
        return _heat(model(torch.from_numpy(case["x"])))


def _rel_err(got, want):
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", ["wasb", "table"])
@pytest.mark.parametrize("reference", ["want", "packed"])
def test_hrnet_matches_jax(case, reference, request):
    """Against flax `.apply` ("want") and the JAX folded, lane-packed path ("packed")."""
    c = request.getfixturevalue(case)
    _assert_alive(c[reference])
    assert _rel_err(_port_heat(c), c[reference]) <= REL_TOL


def test_wasb_committed_checkpoint_matches_flax(wasb):
    from upliftingtabletennis_tpu.utils.checkpoint import load_checkpoint

    variables, _, info = load_checkpoint("artifacts/closed_loop/ball_detector")
    assert info["model"] == "wasb" and info["task"] == "ball"
    variables = jax.device_get(variables)
    want = _heat(wasb["apply"](variables, wasb["x"]))
    _assert_alive(want)
    model, res = get_detector("wasb", "ball")
    assert res == (1280, 704)
    assert _rel_err(_port_heat(wasb, variables, model), want) <= REL_TOL


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(4)
    kernel = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=16).astype(np.float32) for _ in range(3))
    var = np.abs(rng.normal(size=16)).astype(np.float32) + 0.1
    want_w, want_b = jax_fold_bn(jnp.asarray(kernel), {"scale": scale, "bias": bias},
                                 {"mean": mean, "var": var})
    got_w, got_b = fold_bn(*(torch.from_numpy(a) for a in (kernel, scale, bias, mean, var)))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-6)


def test_forward_refolds_after_new_weights(table):
    """The folded weights follow load_state_dict: no stale fold after new weights."""
    model = TableHRNet()
    first = _port_heat(table, model=model)
    other = _perturbed_variables(FlaxTableHRNet(), 3, seed=5)
    assert _rel_err(_port_heat(table, other, model), first) > 1e-2
    assert _rel_err(_port_heat(table, model=model), first) == 0


@pytest.mark.parametrize("name,task,frames", [("wasb", "ball", 3), ("hrnet", "table", 1)])
def test_conv_routing_counts(monkeypatch, name, task, frames):
    """One forward: 40 stride-1 3x3 convs (18 with a residual) through K5a, 14 1x1 convs
    (1 with a residual) through K5b, 18 stride-2 convs outside the kernels."""
    calls = {3: [], 1: []}

    def spy(ks, fn):
        def wrapped(x, w, b=None, residual=None, **kw):
            calls[ks].append(residual is not None)
            return fn(x, w, b, residual, **kw)
        return wrapped

    monkeypatch.setattr(port_hrnet, "conv3x3_bias_act", spy(3, port_hrnet.conv3x3_bias_act))
    monkeypatch.setattr(port_hrnet, "conv1x1_bias_act", spy(1, port_hrnet.conv1x1_bias_act))
    model, _ = get_detector(name, task)
    with torch.no_grad():
        model.eval()(torch.zeros(1, 32, 32, 3 * frames))
    assert (len(calls[3]), sum(calls[3])) == (40, 18)
    assert (len(calls[1]), sum(calls[1])) == (14, 1)
    strided = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d) and m.stride[0] == 2]
    assert len(strided) == 18


def test_detector_names_and_tasks():
    with pytest.raises(ValueError, match="ball detector"):
        get_detector("wasb", "table")
    with pytest.raises(ValueError, match="table detector"):
        get_detector("hrnet", "ball")
