"""K3 of the port (`cross_attention_plain`, the CPU path of `flash_cross_attention`)
against the JAX Pallas kernel in interpret mode and against its dense XLA reference.

Same seeded numpy inputs; fp32; tolerance 3e-4 as K1's (tests/test_torch_fused_attention.py).
Nq and Nkv are not multiples of 128, so the JAX kernel pads queries and masks keys.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.ops.flash_attention import dense_cross_attention
from upliftingtabletennis_tpu.ops.flash_attention import flash_cross_attention as jax_k3
from upliftingtabletennis_torch.ops.flash_attention import (CHUNK, STAGES, cross_attention_plain,
                                                            flash_cross_attention)

torch.set_num_threads(1)
TOL = 3e-4


def _qkv(B, Nq, Nkv, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, Nq, h, hd), (B, Nkv, h, hd), (B, Nkv, h, hd))]


# (B, Nq, Nkv, h, hd, scale): head dims of b0 (32) and b2 (64), an explicit scale
@pytest.mark.parametrize("B,Nq,Nkv,h,hd,scale", [
    (2, 100, 70, 2, 32, None),
    (1, 130, 200, 1, 64, None),
    (1, 77, 129, 5, 64, 0.3),
    (2, 200, 9, 3, 32, 0.125),
])
def test_k3_plain_matches_jax(B, Nq, Nkv, h, hd, scale):
    q, k, v = _qkv(B, Nq, Nkv, h, hd)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = cross_attention_plain(*map(torch.from_numpy, (q, k, v)), scale)
    assert got.dtype == torch.float32 and got.shape == (B, Nq, h, hd)
    want = jax_k3(jq, jk, jv, scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    dense = dense_cross_attention(jq, jk, jv, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=TOL, rtol=TOL)
    # the wrapper takes the plain version for CPU tensors
    wrapped = flash_cross_attention(*map(torch.from_numpy, (q, k, v)), scale)
    assert torch.equal(wrapped, got)


def _k3_limit(q, k, v, want):
    """K3's card limit (tests/test_torch_cuda_kernels.py, chip_smoke.py): the bound of its
    bf16 roundings, 2^-8 (|plain| + softmax(q kᵀ) |v|) per element."""
    return 2.0 ** -8 * (want.abs() + cross_attention_plain(q, k, v.abs()))


# the kernel's rounding (bf16 probabilities and output), a 64-key chunk skipped, the
# last 128-key chunk's 119 zero-filled keys left unmasked (logit 0), and one chunk read
# from the ring stage a ring depth earlier (a wrong mbarrier parity)
@pytest.mark.parametrize("fault", ["none", "chunk", "tail", "stale"])
def test_k3_limit_admits_bf16_roundings_and_rejects_faults(fault):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2, 300, 777, 2, 64, seed=3))
    want = cross_attention_plain(q.float(), k.float(), v.float())
    if fault == "none":
        got = cross_attention_plain(q, k, v)  # f32 softmax, bf16 weights, bf16 output
    elif fault == "chunk":
        keep = torch.cat([torch.arange(64), torch.arange(128, 777)])
        got = cross_attention_plain(q, k[:, keep], v[:, keep])
    elif fault == "tail":
        pad = torch.zeros(2, -777 % CHUNK, 2, 64, dtype=torch.bfloat16)
        got = cross_attention_plain(q, torch.cat([k, pad], 1), torch.cat([v, pad], 1))
    else:
        stale = torch.arange(777)
        stale[CHUNK * STAGES:CHUNK * (STAGES + 1)] = torch.arange(CHUNK)
        got = cross_attention_plain(q, k[:, stale], v[:, stale])
    within = bool(((got.float() - want).abs() <= _k3_limit(q.float(), k.float(), v.float(),
                                                           want)).all())
    assert within == (fault == "none")


def test_k3_rejects_mismatched_shapes():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 5, 2, 32))
    with pytest.raises(ValueError):
        flash_cross_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError):
        flash_cross_attention(q, k, v[:, :4])
