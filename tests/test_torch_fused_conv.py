"""K5 of the port (the plain versions, the CPU path of `conv3x3_bias_act` and
`conv1x1_bias_act`) against the JAX Pallas kernels in interpret mode and against
`lax.conv_general_dilated`.

Same seeded numpy inputs; fp32; atol = rtol = 2e-4, the tolerance of
tests/test_fused_conv.py. H = 64 makes the Pallas row-tile picker (`_pick_th`)
take 32-row tiles, so the JAX kernel runs its cross-tile halo. The packed weight
layout the CUDA kernel reads is checked by an im2col product in numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.ops.fused_conv import _pick_th
from upliftingtabletennis_tpu.ops.fused_conv import conv1x1_bias_act as jax_k5b
from upliftingtabletennis_tpu.ops.fused_conv import conv3x3_bias_act as jax_k5a
from upliftingtabletennis_torch.ops.fused_conv import (conv1x1_bias_act, conv3x3_bias_act, pack,
                                                      unpack)

torch.set_num_threads(1)
TOL = dict(atol=2e-4, rtol=2e-4)


def _case(seed, ks, B, H, W, Ci, Co, bias, res):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, Ci)).astype(np.float32)
    wshape = (3, 3, Ci, Co) if ks == 3 else (Ci, Co)
    w = rng.normal(0, (ks * ks * Ci) ** -0.5, wshape).astype(np.float32)
    b = rng.normal(size=(Co,)).astype(np.float32) if bias else None
    r = rng.normal(size=(B, H, W, Co)).astype(np.float32) if res else None
    return x, w, b, r


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (Ci, Co, relu, bias, residual): the stems (Ci 9 and 3), the block convs, transition1_0
@pytest.mark.parametrize("Ci,Co,relu,bias,res", [
    (9, 64, True, True, False), (3, 64, True, True, False), (16, 16, True, True, True),
    (16, 16, False, False, False), (32, 32, True, True, True), (128, 16, True, True, False),
    (64, 64, False, True, True),
])
def test_k5a_plain_matches_jax_kernel(Ci, Co, relu, bias, res):
    H, W = 64, 6
    assert _pick_th(H, W, Ci, Co, halo=True) < H  # the JAX kernel runs more than one tile
    x, w, b, r = _case(0, 3, 1, H, W, Ci, Co, bias, res)
    want = jax_k5a(_j(x), _j(w), _j(b), _j(r), relu=relu, interpret=True)
    got = conv3x3_bias_act(_t(x), _t(w), _t(b), _t(r), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (Ci, Co, relu, bias, residual): layer1's 1x1s, the fuse 1x1s, the WASB and table heads
@pytest.mark.parametrize("Ci,Co,relu,bias,res", [
    (64, 32, True, True, False), (32, 128, True, True, True), (128, 16, False, True, False),
    (16, 3, False, True, False), (16, 13, False, True, False), (64, 16, True, False, True),
])
def test_k5b_plain_matches_jax_kernel(Ci, Co, relu, bias, res):
    x, w, b, r = _case(1, 1, 2, 64, 5, Ci, Co, bias, res)
    want = jax_k5b(_j(x), _j(w), _j(b), _j(r), relu=relu, interpret=True)
    got = conv1x1_bias_act(_t(x), _t(w), _t(b), _t(r), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ks,Ci,Co", [(3, 9, 64), (3, 16, 16), (1, 32, 16), (1, 16, 13)])
def test_k5_plain_matches_lax_conv_at_ragged_shape(ks, Ci, Co):
    x, w, b, r = _case(2, ks, 2, 13, 11, Ci, Co, True, True)
    w4 = w if ks == 3 else w[None, None]
    y = jax.lax.conv_general_dilated(_j(x), _j(w4), (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = jax.nn.relu(y + b + r)
    fn = conv3x3_bias_act if ks == 3 else conv1x1_bias_act
    got = fn(_t(x), _t(w), _t(b), _t(r), relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ks,Ci,Co", [(3, 9, 64), (3, 3, 64), (3, 32, 32), (1, 16, 3),
                                      (1, 64, 128)])
def test_packed_layout_is_the_kernels_im2col_order(ks, Ci, Co):
    """pack(w, b) gives (round16(Co), round16(taps * Cp)) with column (dy * ks + dx) * Cp
    + ci, zero-padded, and an f32 bias, where Cp = max(Ci, 16) for a 3x3 conv (a stem's
    taps widened to 16 channels, as its halo tile is) and Ci for a 1x1 conv: an im2col
    product with it, of x widened to Cp channels, is the conv."""
    x, w, b, _ = _case(3, ks, 1, 7, 9, Ci, Co, True, False)
    p = pack(torch.from_numpy(w), torch.from_numpy(b))
    Cp = max(Ci, 16) if ks == 3 else Ci
    K = ks * ks * Cp
    assert p.weight.dtype == torch.bfloat16 and p.bias.dtype == torch.float32
    assert p.weight.shape == (Co + -Co % 16, K + -K % 16)
    wk = p.weight.float().numpy()
    assert not wk[Co:].any() and not wk[:, K:].any()
    assert not wk[:, :K].reshape(-1, ks * ks, Cp)[..., Ci:].any()  # the widened channels
    h = ks // 2
    xp = np.pad(x, ((0, 0), (h, h), (h, h), (0, Cp - Ci)))
    cols = np.concatenate([xp[:, dy:dy + 7, dx:dx + 9] for dy in range(ks) for dx in range(ks)],
                          axis=-1)
    got = cols @ wk[:Co, :K].T + p.bias.numpy()
    wq = torch.from_numpy(w).to(torch.bfloat16).float()  # the kernel's bf16 weights
    fn = conv3x3_bias_act if ks == 3 else conv1x1_bias_act
    want = fn(torch.from_numpy(x), wq, torch.from_numpy(b), relu=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("ks,Ci,Co", [(3, 9, 64), (3, 16, 13), (1, 32, 16), (1, 16, 3)])
def test_packed_operands_run_the_plain_version_on_cpu(ks, Ci, Co):
    """Given `pack(w, b)` in place of (w, b), a CPU tensor takes the plain version with
    the unpacked (bf16) weight: the same result as the bf16 weight itself."""
    x, w, b, r = _case(4, ks, 2, 5, 6, Ci, Co, True, True)
    wt = torch.from_numpy(w)
    p = pack(wt, torch.from_numpy(b))
    w_back, b_back = unpack(p)
    assert torch.equal(w_back, wt.to(torch.bfloat16)) and torch.equal(b_back, _t(b))
    fn = conv3x3_bias_act if ks == 3 else conv1x1_bias_act
    got = fn(_t(x), p, None, _t(r), relu=True)
    want = fn(_t(x), w_back.float(), _t(b), _t(r), relu=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="carry their bias"):
        fn(_t(x), p, _t(b))
    other = conv1x1_bias_act if ks == 3 else conv3x3_bias_act
    with pytest.raises(ValueError, match="packed for ks"):
        other(_t(x), p)
