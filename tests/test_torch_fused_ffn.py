"""K2 of the port (plain PyTorch version, the CPU path of `fused_ln_ffn`) against the
JAX Pallas kernel in interpret mode and against its pure-jnp reference `_ref_ln_ffn`,
and against the two TPU layouts of the same function, `fused_ln_ffn_v2` and
`fused_ln_ffn_v3`, in interpret mode (K2's kernel is their counterpart on the card).

Same seeded numpy inputs; fp32; tolerance 2e-4 as in tests/test_fused_ffn.py.
tile_h=4 with H=8 makes the JAX kernel run its cross-tile halo.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.ops.fused_ffn import _ref_ln_ffn
from upliftingtabletennis_tpu.ops.fused_ffn import fused_ln_ffn as jax_k2
from upliftingtabletennis_tpu.ops.fused_ffn import fused_ln_ffn_v2, fused_ln_ffn_v3
from upliftingtabletennis_torch.ops.fused_ffn import fused_ln_ffn

torch.set_num_threads(1)
ORDER = ("gamma", "beta", "w1", "b1", "dw", "bdw", "w2", "b2")


def _params(rng, C, HID):
    return dict(
        gamma=rng.normal(1, 0.1, (C,)), beta=rng.normal(0, 0.1, (C,)),
        w1=rng.normal(0, 0.1, (C, HID)), b1=rng.normal(0, 0.1, (HID,)),
        dw=rng.normal(0, 0.2, (3, 3, HID)), bdw=rng.normal(0, 0.1, (HID,)),
        w2=rng.normal(0, 0.1, (HID, C)), b2=rng.normal(0, 0.1, (C,)),
    )


def _port(x, H, W, p):
    return fused_ln_ffn(torch.from_numpy(x), H, W, *[torch.from_numpy(p[n]) for n in ORDER]).numpy()


@pytest.mark.parametrize("B,H,W,C,tile_h", [(2, 8, 12, 32, 4), (1, 8, 5, 16, 8), (1, 12, 7, 16, 4)])
def test_k2_plain_matches_jax_kernel(B, H, W, C, tile_h):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H * W, C)).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in _params(rng, C, 4 * C).items()}
    want = jax_k2(jnp.asarray(x), H, W, *[jnp.asarray(p[n]) for n in ORDER], interpret=True,
                  tile_h=tile_h)
    np.testing.assert_allclose(_port(x, H, W, p), np.asarray(want), atol=2e-4, rtol=2e-4)


# tile_h=4 with H=8 or 12 runs the TPU layouts' cross-tile halo
@pytest.mark.parametrize("variant", [fused_ln_ffn_v2, fused_ln_ffn_v3], ids=["v2", "v3"])
@pytest.mark.parametrize("B,H,W,C,tile_h", [(2, 8, 12, 32, 4), (1, 12, 7, 16, 4)])
def test_k2_plain_matches_jax_v2_v3_layouts(variant, B, H, W, C, tile_h):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, H * W, C)).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in _params(rng, C, 4 * C).items()}
    want = variant(jnp.asarray(x), H, W, *[jnp.asarray(p[n]) for n in ORDER], interpret=True,
                   tile_h=tile_h)
    np.testing.assert_allclose(_port(x, H, W, p), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("B,H,W,C", [(2, 8, 12, 32), (1, 7, 9, 16)])
def test_k2_plain_matches_jax_reference(B, H, W, C):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, H * W, C)).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in _params(rng, C, 4 * C).items()}
    want = _ref_ln_ffn(jnp.asarray(x), *[jnp.asarray(p[n]) for n in ORDER], H=H, W=W)
    np.testing.assert_allclose(_port(x, H, W, p), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_k2_border_rows_zero_padded():
    """The depthwise conv zero-pads the hidden tensor at the image border: a constant
    input must not behave periodically, and border rows differ from interior rows."""
    rng = np.random.default_rng(2)
    B, H, W, C = 1, 8, 6, 8
    x = np.ones((B, H * W, C), np.float32)
    p = {k: v.astype(np.float32) for k, v in _params(rng, C, 4 * C).items()}
    want = jax_k2(jnp.asarray(x), H, W, *[jnp.asarray(p[n]) for n in ORDER], interpret=True,
                  tile_h=4)
    got = _port(x, H, W, p)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4, rtol=2e-4)
    img = got.reshape(H, W, C)
    assert np.abs(img[0] - img[3]).max() > 1e-3 and np.abs(img[3] - img[4]).max() < 1e-5
