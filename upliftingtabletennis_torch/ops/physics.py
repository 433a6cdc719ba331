"""S1: the ball-flight integrator, forward and tangent modes.

The JAX package runs `core/physics.py:simulate` as one `lax.scan` that XLA fuses; run
eagerly one PyTorch operation at a time, a 1,000-step simulate is some 300,000 launches.
Here every simulate is one launch of the hand-written Hopper kernel of `csrc/physics.cu`
on CUDA tensors, and the plain PyTorch version on CPU tensors:

- `simulate(state0, n_frames, substeps, dt, first_step)`: r, v and w at every saved
  frame, as `core.physics.simulate` (its plain version) gives them. Datagen, the
  re-simulation check and the fit's final projection run it.
- `simulate_tangent(state0, ..., v_scale, w_scale)`: r and dr/dq (F, ..., 3, 9) for
  q = (r0, v0 / v_scale, w0 / w_scale), the exact derivative of the same arithmetic;
  plain version `core.physics.simulate_tangent` (dual numbers). The LM phase of the fit
  reads the tangents as its Jacobian.
- `trajectory_positions(q, ...)`: r as a differentiable function of q (a
  `torch.autograd.Function` over the tangent mode whose backward is
  einsum(grad_r, dr/dq), the reverse-mode gradient of the same arithmetic). The Adam
  phase of the fit differentiates through it.

The kernel computes in float32; the plain version follows the input's dtype. A build or
launch failure raises; nothing falls back to the plain version on CUDA.
"""
from __future__ import annotations

import ctypes

import torch

from upliftingtabletennis_torch.core import physics as P
from upliftingtabletennis_torch.ops import _build

__all__ = ["simulate", "simulate_tangent", "trajectory_positions", "kernel_const_names"]

_SOURCE = "physics.cu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
N_DIR = 9  # tangent directions: r0, v0 / v_scale, w0 / w_scale


def _lib():
    lib = _build.library(_SOURCE)
    if lib.uttk_physics_forward.argtypes is None:
        lib.uttk_physics_forward.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P]
        lib.uttk_physics_forward.restype = _I
        lib.uttk_physics_tangent.argtypes = [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P, _P,
                                             _P]
        lib.uttk_physics_tangent.restype = _I
        lib.uttk_physics_n_consts.argtypes = []
        lib.uttk_physics_n_consts.restype = _I
        lib.uttk_physics_const_name.argtypes = [_I]
        lib.uttk_physics_const_name.restype = ctypes.c_char_p
    return lib


def kernel_const_names() -> list:
    """The kernel's constants in its order (enum Const of csrc/physics.cu), read from the
    built library."""
    lib = _lib()
    return [lib.uttk_physics_const_name(i).decode() for i in range(lib.uttk_physics_n_consts())]


_consts_cache = {}


def _consts(dt: float):
    """The kernel's constants for step dt, a host array of float32 (ctypes rounds each
    Python float to the nearest float32, as PyTorch rounds a scalar operand)."""
    arr = _consts_cache.get(dt)
    if arr is None:
        vals = P.kernel_constants(dt)
        arr = _consts_cache[dt] = (ctypes.c_float * len(vals))(*vals)
    return arr


def _operands(state0: P.BallState, name: str):
    """(r0, v0, w0) as contiguous (N, 3) float32 CUDA tensors, and the batch shape."""
    r0 = state0.r
    _build.uses_kernel(r0, name)
    batch = r0.shape[:-1]
    out = []
    for t, what in zip(state0, ("r", "v", "w")):
        if t.shape != r0.shape or t.shape[-1:] != (3,):
            raise ValueError(f"{name}: state0.{what} of shape {tuple(t.shape)}, expected "
                             f"{tuple(r0.shape)} ending in 3")
        if t.device != r0.device:
            raise ValueError(f"{name}: state0.{what} on {t.device}, r on {r0.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype} for state0.{what}")
        out.append(t.reshape(-1, 3).contiguous())
    if out[0].shape[0] == 0:
        raise ValueError(f"{name}: empty batch")
    return out, batch


def simulate(state0: P.BallState, n_frames: int = 500, substeps: int = 2, dt: float = P.DT,
             first_step: bool = True) -> P.BallState:
    """S1 forward mode: the BallState of (n_frames, ..., 3) tensors that
    `core.physics.simulate` returns, in one launch on CUDA."""
    if state0.r.device.type == "cpu":
        return P.simulate(state0, n_frames, substeps, dt, first_step)
    (r0, v0, w0), batch = _operands(state0, "S1 simulate")
    n = r0.shape[0]
    out = torch.empty(3, n_frames, n, 3, dtype=torch.float32, device=r0.device)
    lib = _lib()
    status = _build.call_on_device(r0, lambda stream: lib.uttk_physics_forward(
        r0.data_ptr(), v0.data_ptr(), w0.data_ptr(), n, n_frames, substeps, int(first_step),
        _consts(dt), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream))
    _build.check(lib, status, "S1 simulate")
    simulate.launches += 1
    return P.BallState(*(o.view(n_frames, *batch, 3) for o in out))


def simulate_tangent(state0: P.BallState, n_frames: int, substeps: int = 2, dt: float = P.DT,
                     v_scale: float = 1.0, w_scale: float = 1.0, first_step: bool = True):
    """S1 tangent mode: (r (n_frames, ..., 3), dr/dq (n_frames, ..., 3, 9)) for
    q = (r0, v0 / v_scale, w0 / w_scale), in one launch on CUDA."""
    if state0.r.device.type == "cpu":
        return P.simulate_tangent(state0, n_frames, substeps, dt, v_scale, w_scale, first_step)
    (r0, v0, w0), batch = _operands(state0, "S1 simulate_tangent")
    n = r0.shape[0]
    r = torch.empty(n_frames, n, 3, dtype=torch.float32, device=r0.device)
    jac = torch.empty(n_frames, n, 3, N_DIR, dtype=torch.float32, device=r0.device)
    lib = _lib()
    status = _build.call_on_device(r0, lambda stream: lib.uttk_physics_tangent(
        r0.data_ptr(), v0.data_ptr(), w0.data_ptr(), n, n_frames, substeps, int(first_step),
        float(v_scale), float(w_scale), _consts(dt), r.data_ptr(), jac.data_ptr(), stream))
    _build.check(lib, status, "S1 simulate_tangent")
    simulate_tangent.launches += 1
    return r.view(n_frames, *batch, 3), jac.view(n_frames, *batch, 3, N_DIR)


simulate.launches = 0
simulate_tangent.launches = 0


def params_to_state(q: torch.Tensor, v_scale: float, w_scale: float) -> P.BallState:
    """(..., 9) q = (r0, v0 / v_scale, w0 / w_scale) -> the initial BallState."""
    return P.BallState(q[..., 0:3], q[..., 3:6] * v_scale, q[..., 6:9] * w_scale)


class _Positions(torch.autograd.Function):
    """r(q) through the tangent mode; the backward contracts the cotangent of r with
    the saved dr/dq."""

    @staticmethod
    def forward(ctx, q, n_frames, substeps, dt, v_scale, w_scale):
        r, jac = simulate_tangent(params_to_state(q.detach(), v_scale, w_scale), n_frames,
                                  substeps, dt, v_scale, w_scale)
        ctx.save_for_backward(jac)
        return r

    @staticmethod
    def backward(ctx, grad_r):
        (jac,) = ctx.saved_tensors
        return torch.einsum("f...i,f...ik->...k", grad_r, jac), None, None, None, None, None


def trajectory_positions(q: torch.Tensor, n_frames: int, substeps: int = 2, dt: float = P.DT,
                         v_scale: float = 1.0, w_scale: float = 1.0) -> torch.Tensor:
    """Positions (n_frames, ..., 3) of the trajectories whose initial state is
    q (..., 9) = (r0, v0 / v_scale, w0 / w_scale), differentiable in q."""
    return _Positions.apply(q, n_frames, substeps, dt, v_scale, w_scale)
