"""Ball-flight physics: implicit-in-velocity Euler flight and event-based contacts.

Port of `upliftingtabletennis_tpu/core/physics.py`, the plain PyTorch version. The force
model, the MuJoCo-fitted contact maps and the save grid are the JAX module's (see its
docstring for where each coefficient comes from):

  a     = -k_q |v| v - k_s v + k_m (omega x v) - g zhat,   alpha = -k_w omega

integrated by one linearised implicit solve per step, (I - dt J) dv = dt a(v), with the
analytic velocity Jacobian J, then r' = r + dt v'; a crossing of the table top, one of
the table box's side faces, the net box or the floor selects ONE surface by priority
and applies one impulse map plus the reflection of the overshoot.

Everything follows the input's dtype, so the tests can run it in float64, and works on
any device: on the card it is the yardstick of the S1 kernel (`ops/csrc/physics.cu`,
wrapper `ops/physics.py`), which runs the same arithmetic. The order of every rounded
operation here is the kernel's: products, sums and quotients are single elementwise
operations (no fused cross, norm or matrix product), and a 3-vector sum is taken as
(x + y) + z. Both read one table of constants (`kernel_constants`), rounded to the
state's dtype as the JAX module rounds its Python scalars.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from upliftingtabletennis_torch.core.geometry import TABLE_HEIGHT, TABLE_LENGTH, TABLE_WIDTH

__all__ = ["BALL_MASS", "BALL_RADIUS", "AIR_DENSITY", "AIR_VISCOSITY", "GRAVITY", "DT", "FPS",
           "MAX_SIMULATION_TIME", "K_QUAD", "K_STOKES", "K_MAGNUS", "K_SPIN", "E_TABLE",
           "E_NET", "E_GROUND_BASE", "E_GROUND_SLIP", "E_GROUND_MAX", "GROUND_MU",
           "GROUND_FRIC_DECAY", "NET_HALF_THICKNESS", "NET_Y_HALF", "NET_Z_BOTTOM",
           "NET_Z_TOP", "FRICTION_MU", "FRIC_DECAY", "CONTACT_Z_TABLE", "CONTACT_Z_GROUND",
           "BallState", "Dual", "flight_accel", "step", "simulate", "simulate_tangent",
           "kernel_constants",
           "KERNEL_CONSTANTS"]

# --- physical constants (the reference's MuJoCo world) ------------------------
BALL_MASS = 0.0027  # kg
BALL_RADIUS = 0.02  # m
AIR_DENSITY = 1.225  # kg/m^3
AIR_VISCOSITY = 1.8e-5  # Pa s
GRAVITY = 9.81
DT = 1e-3  # integrator step
FPS = 500  # save rate
MAX_SIMULATION_TIME = 1.0  # seconds

_BALL_INERTIA = 0.4 * BALL_MASS * BALL_RADIUS**2  # solid sphere
_AREA = math.pi * BALL_RADIUS**2
_VOLUME = 4.0 / 3.0 * math.pi * BALL_RADIUS**3

K_QUAD = AIR_DENSITY * 0.235 * _AREA / BALL_MASS
K_STOKES = 6.0 * math.pi * AIR_VISCOSITY * BALL_RADIUS / BALL_MASS
K_MAGNUS = AIR_DENSITY * _VOLUME / (2.0 * BALL_MASS)
K_SPIN = 8.0 * math.pi * AIR_VISCOSITY * BALL_RADIUS**3 / _BALL_INERTIA

# --- contact coefficients (fitted to MuJoCo's constraint solver) ------------
E_TABLE = 0.99
E_NET = 0.99
E_GROUND_BASE = 0.04  # the floor: slip-dependent restitution, strong friction
E_GROUND_SLIP = 0.022  # d e / d |slip| (1 / (m/s))
E_GROUND_MAX = 0.25
GROUND_MU = 1.0
GROUND_FRIC_DECAY = 1.0
# The net box: half thickness 0.02 in x; it reaches below the table top.
NET_HALF_THICKNESS = 0.02
NET_Y_HALF = TABLE_HEIGHT + 0.1525
NET_Z_BOTTOM = TABLE_HEIGHT - 0.1525
NET_Z_TOP = TABLE_HEIGHT + 0.1525
FRICTION_MU = 0.1
# 1 - exp(-200 * 3 ms), evaluated in float32 as the JAX module evaluates it at import
FRIC_DECAY = float(np.float32(1.0) - np.float32(np.exp(-200.0 * 3e-3)))
_SLIP_RATIO = 1.0 + BALL_MASS * BALL_RADIUS**2 / _BALL_INERTIA  # = 3.5
_SPIN_IMPULSE = BALL_MASS * BALL_RADIUS / _BALL_INERTIA

CONTACT_Z_TABLE = TABLE_HEIGHT + BALL_RADIUS
CONTACT_Z_GROUND = BALL_RADIUS
# contact planes of the table's side faces and of the net's faces
_CX = TABLE_LENGTH / 2 + BALL_RADIUS
_CY = TABLE_WIDTH / 2 + BALL_RADIUS
_CN = NET_HALF_THICKNESS + BALL_RADIUS


class BallState(NamedTuple):
    r: torch.Tensor  # (..., 3) position
    v: torch.Tensor  # (..., 3) velocity
    w: torch.Tensor  # (..., 3) angular velocity


# --- scalar arithmetic shared by tensors and dual numbers -------------------------
# The step below is written once over "scalars": tensors of the batch shape (the plain
# forward), or `Dual`s carrying tangents (the plain tangent mode), as the kernel's step
# is written once over float and its dual type. Vectors are 3-tuples of scalars, and
# the constants come from the table the kernel is given (`kernel_constants`), as 0-dim
# tensors of the state's dtype on its device.


class Dual:
    """A forward-mode dual number: value v (...) and tangents t (K, ...), one row per
    direction. The derivative rules are JAX's (a `where` passes the selected branch's
    tangent, sign has none, a tie of min or max gives each side half), in the kernel's
    order of roundings (ops/csrc/physics.cu, struct Dual)."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    @staticmethod
    def _split(o):
        return (o.v, o.t) if isinstance(o, Dual) else (o, None)

    def __add__(self, o):
        ov, ot = Dual._split(o)
        return Dual(self.v + ov, self.t if ot is None else self.t + ot)

    __radd__ = __add__

    def __sub__(self, o):
        ov, ot = Dual._split(o)
        return Dual(self.v - ov, self.t if ot is None else self.t - ot)

    def __rsub__(self, o):  # o is not a Dual
        return Dual(o - self.v, -self.t)

    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __mul__(self, o):
        ov, ot = Dual._split(o)
        if ot is None:
            return Dual(self.v * ov, self.t * ov)
        return Dual(self.v * ov, self.t * ov + ot * self.v)

    __rmul__ = __mul__

    def __truediv__(self, o):
        ov, ot = Dual._split(o)
        c = self.v / ov
        if ot is None:
            return Dual(c, self.t / ov)
        return Dual(c, (self.t - ot * c) / ov)

    def sqrt(self):
        c = torch.sqrt(self.v)
        return Dual(c, self.t / (2.0 * c))

    def abs(self):
        return Dual(torch.abs(self.v), self.t * torch.sign(self.v))

    @staticmethod
    def lift(a, like):
        """a (a Dual or a tensor) as a Dual shaped like the Dual `like`."""
        if isinstance(a, Dual):
            return a
        return Dual(a.expand_as(like.v), torch.zeros_like(like.t))


def _val(a):
    return a.v if isinstance(a, Dual) else a


def _sqrt(a):
    return a.sqrt() if isinstance(a, Dual) else torch.sqrt(a)


def _abs(a):
    return a.abs() if isinstance(a, Dual) else torch.abs(a)


def _duals(a, b):
    like = a if isinstance(a, Dual) else b
    return Dual.lift(a, like), Dual.lift(b, like)


def _where(c, a, b):
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return torch.where(c, a, b)
    a, b = _duals(a, b)
    return Dual(torch.where(c, a.v, b.v), torch.where(c, a.t, b.t))


def _minimum(a, b):
    """min(a, b); a tie takes half of each tangent (JAX's rule)."""
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return torch.minimum(a, b)
    a, b = _duals(a, b)
    return Dual(torch.minimum(a.v, b.v),
                torch.where(a.v < b.v, a.t, torch.where(a.v > b.v, b.t, 0.5 * (a.t + b.t))))


def _maximum(a, b):
    """max(a, b); a tie takes half of each tangent (JAX's rule)."""
    if not (isinstance(a, Dual) or isinstance(b, Dual)):
        return torch.maximum(a, b)
    a, b = _duals(a, b)
    return Dual(torch.maximum(a.v, b.v),
                torch.where(a.v > b.v, a.t, torch.where(a.v < b.v, b.t, 0.5 * (a.t + b.t))))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _norm(a):
    return _sqrt(_dot(a, a))


_tables = {}


def _table(dtype, device, dt) -> SimpleNamespace:
    """The kernel's constants for step dt as 0-dim tensors of `dtype` on `device` (a
    division by one is a true division on every device, as the kernel's)."""
    key = (dtype, str(device), dt)
    tab = _tables.get(key)
    if tab is None:
        vals = torch.tensor(kernel_constants(dt), dtype=torch.float64).to(dtype)
        tab = _tables[key] = SimpleNamespace(**dict(zip(KERNEL_CONSTANTS,
                                                         vals.to(device).unbind())))
    return tab


def _flight_accel(v, w, k):
    """(a, alpha, |v|) of 3-tuples v, w."""
    speed = _norm(v)
    t = k.NEG_K_QUAD * speed
    c = _cross(w, v)
    a = [t * vi - k.K_STOKES * vi + k.K_MAGNUS * ci for vi, ci in zip(v, c)]
    a[2] = a[2] - k.GRAVITY
    return tuple(a), tuple(k.NEG_K_SPIN * wi for wi in w), speed


def flight_accel(v: torch.Tensor, w: torch.Tensor):
    """Smooth-flight accelerations (a, alpha) for velocity and spin (..., 3)."""
    a, alpha, _ = _flight_accel(v.unbind(-1), w.unbind(-1), _table(v.dtype, v.device, DT))
    return torch.stack(a, -1), torch.stack(alpha, -1)


def _solve3x3(A, b):
    """A (3x3 nested tuples) x = b through the adjugate, no pivoting: the integrator's
    matrices I - dt J are strongly diagonally dominant."""
    (a00, a01, a02), (a10, a11, a12), (a20, a21, a22) = A
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b
    return ((c00 * b0 + c10 * b1 + c20 * b2) / det,
            (c01 * b0 + c11 * b1 + c21 * b2) / det,
            (c02 * b0 + c12 * b1 + c22 * b2) / det)


def _implicit_velocity_update(v, w, k):
    """One implicit-in-velocity Euler update of (v, w), MuJoCo-style: (I6 - dt J) dvel =
    dt accel with J = [[Jvv, Jvw], [0, -K_SPIN I]] block upper triangular. The spin
    block is solved in closed form, then one 3x3 adjugate solve gives dv; Jvw dw is
    written as K_MAGNUS (dw x v)."""
    a, alpha, speed = _flight_accel(v, w, k)
    safe = _maximum(speed, k.SAFE_NORM)
    # d a / d v = -K_QUAD (|v| I + v v^T / |v|) - K_STOKES I + K_MAGNUS [w]x
    o01 = k.NEG_K_QUAD * (v[0] * v[1] / safe)
    o02 = k.NEG_K_QUAD * (v[0] * v[2] / safe)
    o12 = k.NEG_K_QUAD * (v[1] * v[2] / safe)
    d = [k.NEG_K_QUAD * (speed + vi * vi / safe) - k.K_STOKES for vi in v]
    m0, m1, m2 = (k.K_MAGNUS * wi for wi in w)
    J = ((d[0], o01 - m2, o02 + m1),
         (o01 + m2, d[1], o12 - m0),
         (o02 - m1, o12 + m0, d[2]))
    dw = tuple(k.DT * al / k.SPIN_DENOM for al in alpha)
    cw = _cross(dw, v)
    bv = tuple(k.DT * ai + k.DT * (k.K_MAGNUS * ci) for ai, ci in zip(a, cw))
    ndt = -k.DT
    A = tuple(tuple(1.0 - k.DT * J[i][j] if i == j else ndt * J[i][j] for j in range(3))
              for i in range(3))
    dv = _solve3x3(A, bv)
    return (tuple(vi + dvi for vi, dvi in zip(v, dv)),
            tuple(wi + dwi for wi, dwi in zip(w, dw)))


def _bounce_impulse(v, w, n, e_n, mu, fric_decay, k):
    """Impulse map of a bounce off a plane with unit normal n (a 3-tuple): normal
    restitution e_n; the contact point's tangential slip reduced by `fric_decay`,
    capped by the Coulomb cone; the spin from the rigid-body impulse relation."""
    v_n = _dot(v, n)  # negative approaching
    v_t = tuple(vi - v_n * ni for vi, ni in zip(v, n))
    # the contact point at -R n: u = v_t + w x (-R n), tangential part
    u = tuple(a + b for a, b in zip(v_t, _cross(w, tuple(k.NEG_RADIUS * ni for ni in n))))
    u_n = _dot(u, n)
    u = tuple(ui - u_n * ni for ui, ni in zip(u, n))
    u_norm = _norm(u)
    den = _maximum(u_norm, k.SAFE_NORM)
    dv_t_mag = _minimum(fric_decay * u_norm / k.SLIP_RATIO, mu * (1.0 + e_n) * _abs(v_n))
    dv_t = tuple(-dv_t_mag * (ui / den) for ui in u)
    ev = e_n * v_n
    v_out = tuple(a + b - ev * ni for a, b, ni in zip(v_t, dv_t, n))
    w_out = tuple(wi + k.NEG_SPIN_IMPULSE * ci for wi, ci in zip(w, _cross(n, dv_t)))
    return v_out, w_out


def _ground_restitution(v, w, k):
    """Slip-dependent floor restitution (E_GROUND_*), clipped to [base, max]: the
    contact point's slip is (v_x - R w_y, v_y + R w_x)."""
    ux = v[0] - k.RADIUS * w[1]
    uy = v[1] + k.RADIUS * w[0]
    slip = _sqrt(ux * ux + uy * uy)
    return _minimum(_maximum(k.E_GROUND_SLIP * slip + k.E_GROUND_BASE, k.E_GROUND_BASE),
                    k.E_GROUND_MAX)


def _step(r, v, w, k):
    """`step` on 3-tuples of scalars (tensors or Duals) with the constant table k."""
    v1, w1 = _implicit_velocity_update(v, w, k)
    r1 = tuple(ri + k.DT * vi for ri, vi in zip(r, v1))

    x0, y0, z0 = (_val(c) for c in r)
    x, y, z = (_val(c) for c in r1)
    vx, vy, vz = (_val(c) for c in v1)

    hit_top = ((z0 >= k.CONTACT_Z_TABLE) & (z < k.CONTACT_Z_TABLE) & (vz < 0)
               & (torch.abs(x) < k.HALF_LENGTH) & (torch.abs(y) < k.HALF_WIDTH))
    below_top = z < k.TABLE_HEIGHT
    sx = torch.sign(x0)
    hit_sx = ((torch.abs(x0) >= k.CX) & ((x - sx * k.CX) * sx < 0) & (vx * sx < 0)
              & (torch.abs(y) < k.HALF_WIDTH_R) & below_top)
    sy = torch.sign(y0)
    hit_sy = ((torch.abs(y0) >= k.CY) & ((y - sy * k.CY) * sy < 0) & (vy * sy < 0)
              & (torch.abs(x) < k.HALF_LENGTH_R) & below_top)
    hit_gnd = (z0 >= k.CONTACT_Z_GROUND) & (z < k.CONTACT_Z_GROUND) & (vz < 0)
    hit_net = ((torch.abs(x0) >= k.CN) & ((x - sx * k.CN) * sx < 0) & (vx * sx < 0)
               & (torch.abs(y) < k.NET_Y_R) & (z < k.NET_TOP_R) & (z > k.NET_BOTTOM_R))

    # priority: top, side x, side y, floor, net
    hit_sx = hit_sx & ~hit_top
    hit_sy = hit_sy & ~(hit_top | hit_sx)
    hit_gnd = hit_gnd & ~(hit_top | hit_sx | hit_sy)
    hit_net = hit_net & ~(hit_top | hit_sx | hit_sy | hit_gnd)
    hit_any = hit_top | hit_sx | hit_sy | hit_gnd | hit_net

    # the selected surface: its axis (x for the side x faces and the net, y for the
    # side y faces, z otherwise) as a one-hot, the sign of its normal and its plane
    ax0 = hit_sx | hit_net
    ax1 = hit_sy
    onehot = tuple(h.to(x.dtype) for h in (ax0, ax1, ~(ax0 | ax1)))
    sgn = torch.where(ax0, sx, torch.where(ax1, sy, torch.ones_like(sx)))
    c_sel = torch.where(hit_top, k.CONTACT_Z_TABLE,
                        torch.where(hit_sx, sx * k.CX,
                                    torch.where(hit_sy, sy * k.CY,
                                                torch.where(hit_net, sx * k.CN,
                                                            k.CONTACT_Z_GROUND))))
    n = tuple(sgn * o for o in onehot)
    e_sel = _where(hit_gnd, _ground_restitution(v1, w1, k),
                   torch.where(hit_net, k.E_NET, k.E_TABLE).expand_as(x))
    mu_sel = torch.where(hit_gnd, k.GROUND_MU, k.FRICTION_MU)
    dec_sel = torch.where(hit_gnd, k.GROUND_FRIC_DECAY, k.FRIC_DECAY)

    v_b, w_b = _bounce_impulse(v1, w1, n, e_sel, mu_sel, dec_sel, k)
    # reflect the overshoot past the contact plane on the selected axis
    r_ref = c_sel - e_sel * (_dot(r1, onehot) - c_sel)
    r_b = tuple(ri * (1.0 - o) + r_ref * o for ri, o in zip(r1, onehot))

    return tuple(tuple(_where(hit_any, b, a) for a, b in zip(s1, sb))
                 for s1, sb in ((r1, r_b), (v1, v_b), (w1, w_b)))


def step(state: BallState, dt: float = DT) -> BallState:
    """One physics step: implicit flight, then the contacts of the post-flight state.

    The contact surfaces (the table top, the four side faces of the solid table box
    below the top, the floor, the net box's faces) are plane crossings between the
    step's start and the post-flight position. At most one surface can be crossed per
    step at dt = 1 ms, so one surface is selected by priority (top, side x, side y,
    floor, net) and one impulse map plus the reflection of the overshoot runs.
    """
    k = _table(state.r.dtype, state.r.device, dt)
    out = _step(*(t.unbind(-1) for t in state), k)
    return BallState(*(torch.stack(c, -1) for c in out))


def _leaves(state):
    """The tensors of a state of 3-tuples of scalars (tensors or Duals), in order."""
    return [x for vec in state for c in vec
            for x in ((c.v, c.t) if isinstance(c, Dual) else (c,))]


def _static_stepper(state, k):
    """(the current state, advance) over static buffers: `advance` runs one step that
    reads the buffers and writes its result back into them. On a CUDA device that step
    is captured once as a CUDA graph and replayed, so the host issues one launch per step
    instead of each of its few hundred operations; the graph holds the same kernels on
    the same values, so every frame is the eager loop's bit for bit. On the CPU the step
    runs eagerly into the same buffers."""
    bufs = [x.clone(memory_format=torch.contiguous_format) for x in _leaves(state)]
    it = iter(bufs)
    static = tuple(tuple(Dual(next(it), next(it)) if isinstance(c, Dual) else next(it)
                         for c in vec) for vec in state)

    def step_into():
        for b, x in zip(bufs, _leaves(_step(*static, k))):
            b.copy_(x)

    if not bufs[0].is_cuda:
        return static, step_into
    side = torch.cuda.Stream()  # warm up off the default stream, as capture asks
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _step(*static, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step_into()
    return static, graph.replay


def _run(r, v, w, n_frames, substeps, k, first_step, save, graph=False):
    """The save loop over 3-tuples of scalars; save(r, v, w) is called per frame. With
    `graph`, the steps run over static buffers (`_static_stepper`)."""
    if graph:
        static, advance = _static_stepper((r, v, w), k)

        def current():
            return static
    else:
        state = [(r, v, w)]

        def advance():
            state[0] = _step(*state[0], k)

        def current():
            return state[0]
    if first_step:
        advance()
    for f in range(n_frames):
        if f:
            for _ in range(substeps):
                advance()
        save(*current())


def simulate(state0: BallState, n_frames: int = int(MAX_SIMULATION_TIME * FPS),
             substeps: int = int(round(1.0 / (FPS * DT))), dt: float = DT,
             first_step: bool = True, graph: bool = False) -> BallState:
    """Simulate and save `n_frames` frames on the FPS grid: frame k is the state after
    1 + k * substeps steps (the reference's one step before its save loop), or after
    k * substeps steps with `first_step=False` (re-simulation from a saved frame).
    Returns a BallState of (n_frames, ..., 3) tensors; leading batch dims are kept.
    `graph=True` replays one captured step on a CUDA device (`_static_stepper`): the same
    values, without the host's launches of each operation. It is a timing aid for the
    plain reference (the smoke script and the card tests set it); no path of the package
    does."""
    frames = []
    k = _table(state0.r.dtype, state0.r.device, dt)
    _run(*(t.unbind(-1) for t in state0), n_frames, substeps, k, first_step,
         lambda *s: frames.append(tuple(torch.stack(c, -1) for c in s)), graph)
    return BallState(*(torch.stack(f) for f in zip(*frames)))


def simulate_tangent(state0: BallState, n_frames: int, substeps: int = 2, dt: float = DT,
                     v_scale: float = 1.0, w_scale: float = 1.0, first_step: bool = True,
                     graph: bool = False):
    """Positions and their tangents by forward-mode dual numbers: r (n_frames, ..., 3) as
    `simulate` gives them, and dr/dq (n_frames, ..., 3, 9) for the 9 parameters
    q = (r0, v0 / v_scale, w0 / w_scale) of the initial state. The plain version of the
    S1 kernel's tangent mode; `graph` as in `simulate`."""
    r0, v0, w0 = state0
    seeds = torch.eye(9, dtype=r0.dtype, device=r0.device)
    seeds[3:6] *= v_scale
    seeds[6:] *= w_scale
    batch = r0.shape[:-1]
    comps = [Dual(x[..., i], seeds[3 * b + i].reshape(9, *(1,) * len(batch)).expand(9, *batch))
             for b, x in enumerate((r0, v0, w0)) for i in range(3)]
    rs, ts = [], []

    def save(r, v, w):
        rs.append(torch.stack([c.v for c in r], -1))
        ts.append(torch.stack([c.t for c in r], -1))

    _run(comps[0:3], comps[3:6], comps[6:9], n_frames, substeps,
         _table(r0.dtype, r0.device, dt), first_step, save, graph)
    return torch.stack(rs), torch.stack(ts).movedim(1, -1)


# The constants of `step`, in the order of the S1 kernel's enum Const (ops/csrc/physics.cu),
# which reads them as float32; the plain version reads them through `_table`.
KERNEL_CONSTANTS = (
    "NEG_K_QUAD", "K_STOKES", "K_MAGNUS", "NEG_K_SPIN", "GRAVITY", "SAFE_NORM", "DT",
    "SPIN_DENOM", "CONTACT_Z_TABLE", "HALF_LENGTH", "HALF_WIDTH", "TABLE_HEIGHT", "CX", "CY",
    "CN", "HALF_WIDTH_R", "HALF_LENGTH_R", "CONTACT_Z_GROUND", "NET_Y_R", "NET_TOP_R",
    "NET_BOTTOM_R", "E_TABLE", "E_NET", "E_GROUND_BASE", "E_GROUND_SLIP", "E_GROUND_MAX",
    "GROUND_MU", "FRICTION_MU", "GROUND_FRIC_DECAY", "FRIC_DECAY", "NEG_RADIUS", "RADIUS",
    "SLIP_RATIO", "NEG_SPIN_IMPULSE",
)


def kernel_constants(dt: float = DT) -> list:
    """The values of KERNEL_CONSTANTS (Python floats; the kernel rounds them to f32)."""
    vals = dict(
        NEG_K_QUAD=-K_QUAD, K_STOKES=K_STOKES, K_MAGNUS=K_MAGNUS, NEG_K_SPIN=-K_SPIN,
        GRAVITY=GRAVITY, SAFE_NORM=1e-9, DT=dt, SPIN_DENOM=1.0 + dt * K_SPIN,
        CONTACT_Z_TABLE=CONTACT_Z_TABLE, HALF_LENGTH=TABLE_LENGTH / 2,
        HALF_WIDTH=TABLE_WIDTH / 2, TABLE_HEIGHT=TABLE_HEIGHT, CX=_CX, CY=_CY, CN=_CN,
        HALF_WIDTH_R=TABLE_WIDTH / 2 + BALL_RADIUS, HALF_LENGTH_R=TABLE_LENGTH / 2 + BALL_RADIUS,
        CONTACT_Z_GROUND=CONTACT_Z_GROUND, NET_Y_R=NET_Y_HALF + BALL_RADIUS,
        NET_TOP_R=NET_Z_TOP + BALL_RADIUS, NET_BOTTOM_R=NET_Z_BOTTOM - BALL_RADIUS,
        E_TABLE=E_TABLE, E_NET=E_NET, E_GROUND_BASE=E_GROUND_BASE,
        E_GROUND_SLIP=E_GROUND_SLIP, E_GROUND_MAX=E_GROUND_MAX, GROUND_MU=GROUND_MU,
        FRICTION_MU=FRICTION_MU, GROUND_FRIC_DECAY=GROUND_FRIC_DECAY, FRIC_DECAY=FRIC_DECAY,
        NEG_RADIUS=-BALL_RADIUS, RADIUS=BALL_RADIUS, SLIP_RATIO=_SLIP_RATIO,
        NEG_SPIN_IMPULSE=-_SPIN_IMPULSE)
    return [vals[k] for k in KERNEL_CONSTANTS]
