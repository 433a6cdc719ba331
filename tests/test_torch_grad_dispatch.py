"""Every CUDA kernel wrapper of the port is either differentiable or refuses a call that
autograd would record: K1, K2, K3 and K4 run through their autograd Functions, K5a and
K5b raise. Run here with no card: the kernel path is faked, each wrapper's `_launch`
(and K4's `_launch_backward`) replaced by its plain version behind a guard that refuses
operands autograd would record (the real launch returns a tensor with no `grad_fn`,
which silently drops the gradient).

The gradients through the faked kernel path must equal those of the plain versions,
also for a whole SegFormer-b0 in training mode (every parameter gets one).
"""
import pytest
import torch

from upliftingtabletennis_torch.models.segformer import SegFormerNet
from upliftingtabletennis_torch.ops import _build
from upliftingtabletennis_torch.ops import dwconv, flash_attention, fused_attention, fused_conv
from upliftingtabletennis_torch.ops import fused_ffn

torch.set_num_threads(1)


def _refusing(plain, calls):
    def launch(*args):
        if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                           for a in args):
            raise AssertionError("the kernel got operands that autograd would record")
        calls.append(plain)
        return plain(*args)
    return launch


def _dw_backward_plain(x, taps, g):
    """K4's backward kernel faked: its operands are dx's taps (the flipped kernel), not w."""
    return dwconv.dwconv3x3_backward_plain(x, dwconv._dx_taps(taps), g)


def _conv_plain(wrapper, x, p, residual, relu):
    w, b = fused_conv.unpack(p)
    plain = fused_conv.conv3x3_bias_act_plain if p.ks == 3 else fused_conv.conv1x1_bias_act_plain
    return plain(x, w, b, residual, relu=relu)


@pytest.fixture
def fake_card(monkeypatch):
    """The kernel path on CPU tensors; returns the list of faked launches."""
    calls = []
    monkeypatch.setattr(_build, "uses_kernel", lambda t, name: True)
    monkeypatch.setattr(fused_attention, "_launch",
                        _refusing(fused_attention.attention_block_plain, calls))
    monkeypatch.setattr(fused_ffn, "_launch", _refusing(fused_ffn.ln_ffn_plain, calls))
    monkeypatch.setattr(flash_attention, "_launch",
                        _refusing(flash_attention.cross_attention_plain, calls))
    monkeypatch.setattr(dwconv, "_launch", _refusing(dwconv.dwconv3x3_plain, calls))
    monkeypatch.setattr(dwconv, "_launch_backward", _refusing(_dw_backward_plain, calls))
    monkeypatch.setattr(fused_conv, "_launch", _refusing(_conv_plain, calls))
    return calls


def _leaves(gen, *shapes, std=0.3):
    return [(torch.randn(*s, generator=gen) * std).requires_grad_() for s in shapes]


def _grads_match(fn, plain, leaves):
    out = fn(*leaves)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(plain(*leaves), leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_k1_k2_k3_k4_are_differentiable_on_the_kernel_path(fake_card):
    gen = torch.Generator().manual_seed(0)
    B, H, W, C, heads, Nkv = 2, 4, 5, 16, 2, 6
    HID = 4 * C
    _grads_match(lambda x, *p: fused_ffn.fused_ln_ffn(x, H, W, *p),
                 lambda x, *p: fused_ffn.ln_ffn_plain(x, H, W, *p),
                 _leaves(gen, (B, H * W, C), (C,), (C,), (C, HID), (HID,), (3, 3, HID), (HID,),
                         (HID, C), (C,)))
    _grads_match(lambda x, *p: fused_attention.fused_attention_block(x, H, W, heads, *p),
                 lambda x, *p: fused_attention.attention_block_plain(x, heads, *p),
                 _leaves(gen, (B, H * W, C), (C,), (C,), (C, C), (C,), (B, Nkv, heads, C // heads),
                         (B, Nkv, heads, C // heads), (C, C), (C,)))
    _grads_match(flash_attention.flash_cross_attention, flash_attention.cross_attention_plain,
                 _leaves(gen, (B, 11, heads, 8), (B, Nkv, heads, 8), (B, Nkv, heads, 8)))
    _grads_match(dwconv.depthwise_conv3x3, dwconv.dwconv3x3_plain,
                 _leaves(gen, (B, H, W, C), (3, 3, C), (C,)))
    kinds = {f.__name__ for f in fake_card}
    # K2's backward recomputes through K4: its forward kernel, then its backward kernel
    assert kinds == {"ln_ffn_plain", "attention_block_plain", "cross_attention_plain",
                     "dwconv3x3_plain", "_dw_backward_plain"}


def test_k5_raises_under_grad_on_the_kernel_path(fake_card):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 5, 6, 16, generator=gen)
    w3, w1 = _leaves(gen, (3, 3, 16, 16), (16, 16))
    for fn, w in ((fused_conv.conv3x3_bias_act, w3), (fused_conv.conv1x1_bias_act, w1)):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x, w)
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x, fused_conv.pack(w))  # packed from a parameter that requires grad
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x.requires_grad_(), w.detach())
        x = x.detach()
        with torch.no_grad():
            fn(x, w)
    assert len(fake_card) == 2


def test_segformer_backward_reaches_every_parameter_on_the_kernel_path(fake_card):
    torch.manual_seed(0)
    net = SegFormerNet(1, 3, "b0", train=True)
    ref = SegFormerNet(1, 3, "b0", train=True, kernels=False)
    ref.load_state_dict(net.state_dict())
    x = torch.randn(2, 64, 96, 9, generator=torch.Generator().manual_seed(2))
    net(x)[0].square().mean().backward()
    ref(x)[0].square().mean().backward()
    assert fake_card, "the kernel path was not taken"
    for (name, p), q in zip(net.named_parameters(), ref.parameters()):
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, q.grad, atol=1e-6, rtol=2e-4, msg=name)
