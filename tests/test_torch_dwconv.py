"""K4 of the port (`ops/dwconv.py`, the CPU path of `depthwise_conv3x3`) against the JAX
`depthwise_conv3x3` (its XLA path on the CPU) and the Pallas kernel `_dw_pallas` in
interpret mode, forward and backward, and the port's autograd Function against
`torch.autograd.gradcheck` in f64. The plain version of the backward kernel,
`dwconv3x3_backward_plain`, against the JAX `_dw_bwd` (through `jax.vjp`) at three
shapes, one ragged (H and W not multiples of the kernels' tiles, C = 136 not a
multiple of their channel groups); the autograd Function's CPU backward returns
exactly its output.

Same seeded numpy inputs; f32; tolerance 1e-5 of the largest |value| per tensor
(the sums are 9 f32 products, or a reduction over B*H*W for dw and db).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.ops.dwconv import _dw_pallas
from upliftingtabletennis_tpu.ops.dwconv import depthwise_conv3x3 as jax_dw
from upliftingtabletennis_torch.ops.dwconv import (depthwise_conv3x3, dwconv3x3_backward_plain,
                                                   dwconv3x3_plain)

torch.set_num_threads(1)
SHAPES = [(2, 8, 12, 16), (1, 7, 9, 8), (1, 5, 3, 128)]


def _inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, C)).astype(np.float32)
    b = rng.normal(0, 0.1, (C,)).astype(np.float32)
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)
    return x, w, b, g


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_k4_plain_matches_jax_xla_and_pallas(shape):
    x, w, b, _ = _inputs(0, *shape)
    got = dwconv3x3_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    jw = jnp.asarray(w)[:, :, None, :]
    _close(got, jax_dw(jnp.asarray(x), jw, jnp.asarray(b)))
    _close(got, _dw_pallas(jnp.asarray(x), jw, jnp.asarray(b), interpret=True))
    # the public entry point takes the plain version for CPU tensors
    same = depthwise_conv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(same.numpy(), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_k4_backward_matches_jax_vjp(shape):
    x, w, b, g = _inputs(1, *shape)
    _, vjp = jax.vjp(jax_dw, jnp.asarray(x), jnp.asarray(w)[:, :, None, :], jnp.asarray(b))
    dx_j, dw_j, db_j = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = depthwise_conv3x3(xt, wt, bt)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    _close(xt.grad.numpy(), dx_j)
    _close(wt.grad.numpy(), np.asarray(dw_j)[:, :, 0])
    _close(bt.grad.numpy(), db_j)


# the ragged shape is chip_smoke.py's K4_RAGGED: 45 rows, 77 columns (8-column tiles),
# 136 channels (groups of 64 and 32)
@pytest.mark.parametrize("shape", [(2, 8, 12, 16), (1, 5, 3, 128), (2, 45, 77, 136)])
def test_k4_backward_plain_matches_jax_dw_bwd(shape):
    x, w, b, g = _inputs(3, *shape)
    _, vjp = jax.vjp(jax_dw, jnp.asarray(x), jnp.asarray(w)[:, :, None, :], jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    got = dwconv3x3_backward_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    assert [t.dtype for t in got] == [torch.float32] * 3
    for a, j in zip(got, (want[0], np.asarray(want[1])[:, :, 0], want[2])):
        assert a.shape == j.shape
        _close(a.numpy(), j)


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.float64])
def test_k4_cpu_backward_is_the_plain_backward(bias_dtype):
    """On CPU tensors the autograd Function's backward returns exactly
    `dwconv3x3_backward_plain`'s (dx, dw, db), db cast to the bias's dtype."""
    x, w, b, g = (torch.from_numpy(a) for a in _inputs(4, 2, 9, 13, 24))
    xt, wt, bt = x.clone().requires_grad_(), w.clone().requires_grad_(), \
        b.to(bias_dtype).requires_grad_()
    depthwise_conv3x3(xt, wt, bt).backward(g)
    dx, dw, db = dwconv3x3_backward_plain(x, w, g)
    for got, want in zip((xt.grad, wt.grad, bt.grad), (dx, dw, db.to(bias_dtype))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_k4_gradcheck_f64():
    rng = np.random.default_rng(2)
    x, w, b = (torch.from_numpy(rng.normal(size=s)).requires_grad_()
               for s in ((2, 4, 5, 8), (3, 3, 8), (8,)))
    assert torch.autograd.gradcheck(depthwise_conv3x3, (x, w, b))


def test_k4_rejects_bad_shapes():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError):
        depthwise_conv3x3(x, torch.zeros(3, 3, 1, 8), torch.zeros(8))
    with pytest.raises(ValueError):
        depthwise_conv3x3(x, torch.zeros(3, 3, 8), torch.zeros(4))
