"""The port's differentiable kernel wrappers against the JAX custom VJPs they port:
`fused_ln_ffn_trainable` (K2), `fused_attention_block_trainable` (K1) and
`flash_cross_attention_diff` (K3), each against `jax.vjp` of the JAX wrapper of the
same name with the Pallas kernel in interpret mode.

Same seeded numpy inputs and cotangent; f32; the forward within 2e-4 (the kernels'
parity tolerance) and the gradient of every input within 1e-4 of its largest |grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.ops import fused_attention as jax_k1
from upliftingtabletennis_tpu.ops import fused_ffn as jax_k2
from upliftingtabletennis_tpu.ops.flash_attention import flash_cross_attention_diff as jax_k3
from upliftingtabletennis_torch.ops.flash_attention import flash_cross_attention_diff
from upliftingtabletennis_torch.ops.fused_attention import fused_attention_block_trainable
from upliftingtabletennis_torch.ops.fused_ffn import fused_ln_ffn_trainable

torch.set_num_threads(1)


def _check(port_fn, jax_fn, inputs, seed):
    """Forward and the gradient of every input: port autograd vs jax.vjp, one cotangent."""
    out_j, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in inputs])
    g = np.random.default_rng(seed).normal(size=out_j.shape).astype(np.float32)
    grads_j = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = port_fn(*ts)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-4, rtol=2e-4)
    out.backward(torch.from_numpy(g))
    for i, (t, gj) in enumerate(zip(ts, grads_j)):
        gj = np.asarray(gj)
        np.testing.assert_allclose(t.grad.numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max(),
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("B,H,W,C", [(2, 8, 6, 16), (1, 4, 7, 32)])
def test_fused_ln_ffn_trainable_matches_jax_vjp(B, H, W, C):
    rng = np.random.default_rng(0)
    HID = 4 * C
    shapes = [(B, H * W, C), (C,), (C,), (C, HID), (HID,), (3, 3, HID), (HID,), (HID, C), (C,)]
    stds = [1.0, 0.1, 0.1, 0.2, 0.1, 0.3, 0.1, 0.1, 0.1]
    inputs = [rng.normal(0, s, sh).astype(np.float32) for sh, s in zip(shapes, stds)]
    inputs[1] += 1.0  # gamma around 1

    def jax_fn(x, *p):
        return jax_k2.fused_ln_ffn_trainable(H, W, True, x, *p)

    _check(lambda x, *p: fused_ln_ffn_trainable(x, H, W, *p), jax_fn, inputs, seed=1)


@pytest.mark.parametrize("B,H,W,C,heads,Nkv", [(2, 4, 6, 32, 2, 12), (1, 5, 5, 16, 1, 7)])
def test_fused_attention_block_trainable_matches_jax_vjp(B, H, W, C, heads, Nkv):
    rng = np.random.default_rng(2)
    hd = C // heads
    shapes = [(B, H * W, C), (C,), (C,), (C, C), (C,), (B, Nkv, heads, hd), (B, Nkv, heads, hd),
              (C, C), (C,)]
    stds = [1.0, 0.1, 0.1, C ** -0.5, 0.1, 1.0, 1.0, C ** -0.5, 0.1]
    inputs = [rng.normal(0, s, sh).astype(np.float32) for sh, s in zip(shapes, stds)]
    inputs[1] += 1.0

    def jax_fn(x, *p):
        return jax_k1.fused_attention_block_trainable(H, W, heads, True, x, *p)

    _check(lambda x, *p: fused_attention_block_trainable(x, H, W, heads, *p), jax_fn, inputs,
           seed=3)


@pytest.mark.parametrize("B,Nq,Nkv,heads,hd,scale", [(2, 37, 19, 2, 16, None), (1, 130, 65, 1, 32, 0.3)])
def test_flash_cross_attention_diff_matches_jax_vjp(B, Nq, Nkv, heads, hd, scale):
    rng = np.random.default_rng(4)
    inputs = [rng.normal(size=(B, n, heads, hd)).astype(np.float32) for n in (Nq, Nkv, Nkv)]
    s = hd ** -0.5 if scale is None else scale

    def jax_fn(q, k, v):
        return jax_k3(q, k, v, s, True)

    _check(lambda q, k, v: flash_cross_attention_diff(q, k, v, scale), jax_fn, inputs, seed=5)
