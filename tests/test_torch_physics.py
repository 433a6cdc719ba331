"""Ball-flight physics of the port (core/physics.py, and ops/physics.py's CPU path, the
plain versions of the S1 kernel) against the JAX package.

The same initial states (numpy, from seeds or from JAX's own datagen sampler) go through
`upliftingtabletennis_tpu.core.physics` and the port. Tolerances, with their reasons:

- float64, whole trajectories with contacts: 1e-9 m, 1e-8 m/s, 1e-6 rad/s on the
  states of one surface each (rounding only: the two implementations order a few sums
  and products differently), and 1e-7 m, 1e-6 m/s, 1e-4 rad/s on 64 sampled
  candidates over 200 frames, where a floor contact's friction and spin impulse amplify
  those roundings (the largest seen: 5e-9 m over 500 frames).
- float32, the frames before the first contact: 2e-5 m, 1e-4 m/s and 1e-3 rad/s (a few
  hundred steps of float32 rounding); a contact that one implementation sees a step
  later than the other would differ by meters per second, so later frames are held in
  float64 only.
- the tangent (dr/dq) against `jax.jacfwd` in float64 over 30 frames with contacts:
  1e-7 relative plus 1e-9 of the largest |dr/dq| (the floor contact's friction
  amplifies the roundings, as above; 1.7e-8 relative seen).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from upliftingtabletennis_tpu.core import physics as JP
from upliftingtabletennis_tpu.data import datagen as JDG
from upliftingtabletennis_torch.core import physics as P
from upliftingtabletennis_torch.ops import _build
from upliftingtabletennis_torch.ops import physics as S1

torch.set_num_threads(1)

F64_ATOL = (1e-9, 1e-8, 1e-6)  # r, v, w on the single-surface states
F64_BATCH_ATOL = (1e-7, 1e-6, 1e-4)  # r, v, w on sampled candidates, 200 frames
F32_ATOL = (2e-5, 1e-4, 1e-3)  # r, v, w before the first contact
TANGENT_RTOL, TANGENT_ATOL = 1e-7, 1e-9  # the latter relative to max |dr/dq|

# (r, v, w) of states that cross one surface each within 30 frames, and the velocity
# component whose sign the contact flips
SURFACES = {
    "flight": ((-1.0, 0.2, 1.3), (6.0, 0.5, 1.0), (10.0, 50.0, -20.0), None),
    "table_top": ((0.5, 0.1, 0.9), (2.0, 0.0, -3.0), (20.0, -80.0, 10.0), 2),
    "side_x": ((1.6, 0.1, 0.5), (-5.0, 0.0, 0.5), (0.0, 30.0, 0.0), 0),
    "side_y": ((0.3, 1.0, 0.5), (0.2, -5.0, 0.3), (40.0, 0.0, 5.0), 1),
    "net": ((-0.3, 0.2, 0.85), (8.0, 0.0, 0.5), (0.0, -60.0, 0.0), 0),
    "floor": ((2.5, 1.5, 0.1), (1.0, 0.0, -3.0), (5.0, 150.0, -5.0), 2),
}


def _states(names, dtype):
    r, v, w = (np.array([SURFACES[n][i] for n in names], dtype) for i in range(3))
    return r, v, w


_jax_step = jax.jit(JP.step)


def _jax_sim(r, v, w, n_frames, first_step=True):
    state = JP.BallState(*(jnp.asarray(a) for a in (r, v, w)))
    if first_step:
        return [np.asarray(a) for a in JP.simulate_jit(state, n_frames, 2)]
    frames = [state]
    for _ in range(n_frames - 1):
        for _ in range(2):
            state = _jax_step(state)
        frames.append(state)
    return [np.stack([np.asarray(f[i]) for f in frames]) for i in range(3)]


def _port_sim(r, v, w, n_frames, **kw):
    out = P.simulate(P.BallState(*(torch.tensor(a) for a in (r, v, w))), n_frames, 2, **kw)
    return [a.numpy() for a in out]


def _first_contact(v):
    """(B,) the first frame whose velocity jumps by more than flight can change it
    between two frames (2 ms): a contact."""
    jump = np.abs(np.diff(v, axis=0)).max(-1) > 0.5  # (F - 1, B)
    return np.where(jump.any(0), jump.argmax(0) + 1, v.shape[0])


def test_constants_match_jax():
    for name in ("K_QUAD", "K_STOKES", "K_MAGNUS", "K_SPIN", "E_TABLE", "E_NET", "GROUND_MU",
                 "FRICTION_MU", "CONTACT_Z_TABLE", "CONTACT_Z_GROUND", "NET_Y_HALF",
                 "NET_Z_BOTTOM", "NET_Z_TOP", "_SLIP_RATIO", "_BALL_INERTIA"):
        assert getattr(P, name) == getattr(JP, name), name
    assert P.FRIC_DECAY == float(JP.FRIC_DECAY)


def test_kernel_constant_order_matches_the_cuda_source():
    """The wrapper passes kernel_constants() in KERNEL_CONSTANTS order; csrc/physics.cu
    reads them by its enum Const and names them in kConstNames: all three agree."""
    src = (_build.CSRC / "physics.cu").read_text()
    enum = re.search(r"enum Const : int \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "N_CONST" and names[:-1] == list(P.KERNEL_CONSTANTS)
    listed = re.search(r"kConstNames\[N_CONST\] = \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r'"(\w+)"', listed) == list(P.KERNEL_CONSTANTS)
    assert len(P.kernel_constants()) == len(P.KERNEL_CONSTANTS)
    assert "physics.cu" in _build.SOURCES


def test_flight_accel_matches_jax():
    rng = np.random.default_rng(0)
    v, w = rng.normal(0, 8, (2, 16, 3)), rng.normal(0, 200, (16, 3))
    with jax.enable_x64():
        ja, jalpha = (np.asarray(a) for a in JP.flight_accel(jnp.asarray(v), jnp.asarray(w)))
    pa, palpha = P.flight_accel(torch.from_numpy(v), torch.from_numpy(w))
    np.testing.assert_allclose(pa.numpy(), ja, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(palpha.numpy(), jalpha, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("surface", list(SURFACES))
def test_step_and_simulate_hit_each_surface_like_jax(surface):
    """Each state crosses its surface (the flipped velocity component shows it), and the
    whole trajectory matches JAX in float64; in float32 the frames before the contact."""
    axis = SURFACES[surface][3]
    r, v, w = _states([surface], np.float64)
    with jax.enable_x64():
        want = _jax_sim(r, v, w, 30)
        want_step = [np.asarray(a) for a in JP.step(JP.BallState(*map(jnp.asarray, (r, v, w))))]
    got = _port_sim(r, v, w, 30)
    got_step = P.step(P.BallState(*(torch.from_numpy(a) for a in (r, v, w))))
    for g, j, tol in zip(got_step, want_step, F64_ATOL):
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=tol)
    for g, j, tol in zip(got, want, F64_ATOL):
        np.testing.assert_allclose(g, j, rtol=0, atol=tol)
    vj = want[1][:, 0]
    contact = _first_contact(want[1])[0]
    if axis is None:
        assert contact == 30
    else:
        assert contact < 30 and np.sign(vj[contact - 1, axis]) != np.sign(vj[contact + 1, axis])

    r32, v32, w32 = (a.astype(np.float32) for a in (r, v, w))
    want32 = _jax_sim(r32, v32, w32, 30)
    got32 = _port_sim(r32, v32, w32, 30)
    for g, j, tol in zip(got32, want32, F32_ATOL):
        np.testing.assert_allclose(g[:contact], j[:contact], rtol=0, atol=tol)


@pytest.fixture(scope="module")
def sampled():
    """64 intermediate-mode candidates from JAX's datagen sampler (float64 draws)."""
    with jax.enable_x64():
        s = JDG._sample_initial_conditions_core(jax.random.PRNGKey(0), 64, jnp.asarray(False),
                                                jnp.asarray(1.0))
        return [np.asarray(a, np.float64) for a in s]


def test_simulate_on_sampled_candidates_matches_jax(sampled):
    r, v, w = sampled
    with jax.enable_x64():
        want = _jax_sim(r, v, w, 200)
    got = _port_sim(r, v, w, 200)
    assert (_first_contact(want[1]) < 200).sum() >= 32  # most of them bounce
    for g, j, tol in zip(got, want, F64_BATCH_ATOL):
        np.testing.assert_allclose(g, j, rtol=0, atol=tol)

    r32, v32, w32 = (a.astype(np.float32) for a in sampled)
    want32 = _jax_sim(r32, v32, w32, 200)
    got32 = _port_sim(r32, v32, w32, 200)
    first = np.minimum(_first_contact(want32[1]), _first_contact(got32[1]))
    for g, j, tol in zip(got32, want32, F32_ATOL):
        for b in range(64):
            np.testing.assert_allclose(g[:first[b], b], j[:first[b], b], rtol=0, atol=tol)


def test_resimulation_from_a_saved_frame_matches_jax():
    """first_step=False: frame k is k * substeps steps after the given state (the
    re-simulation check's convention, JAX's loop of `step`)."""
    r, v, w = _states(["table_top", "net"], np.float64)
    with jax.enable_x64():
        want = _jax_sim(r, v, w, 12, first_step=False)
    got = _port_sim(r, v, w, 12, first_step=False)
    for g, j, tol in zip(got, want, F64_ATOL):
        np.testing.assert_allclose(g, j, rtol=0, atol=tol)


def test_tangent_matches_jax_jacfwd():
    """dr/dq of the dual-number plain version against jax.jacfwd of the JAX simulate, for
    q = (r0, v0 / 10, w0 / 100), on the surface states (contacts included)."""
    names = list(SURFACES)
    r, v, w = _states(names, np.float64)
    q = np.concatenate([r, v / 10.0, w / 100.0], -1)
    with jax.enable_x64():
        def positions(qq):
            st = JP.BallState(qq[:, :3], qq[:, 3:6] * 10.0, qq[:, 6:] * 100.0)
            return JP.simulate(st, 30, 2).r

        jac = np.asarray(jax.jacfwd(positions)(jnp.asarray(q)))  # (F, B, 3, B, 9)
    want = np.stack([jac[:, b, :, b, :] for b in range(len(names))], 1)
    rr, got = P.simulate_tangent(P.BallState(*(torch.from_numpy(a) for a in (r, v, w))), 30, 2,
                                 v_scale=10.0, w_scale=100.0)
    assert got.shape == (30, len(names), 3, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=TANGENT_RTOL,
                               atol=TANGENT_ATOL * np.abs(want).max())
    np.testing.assert_array_equal(rr.numpy(), _port_sim(r, v, w, 30)[0])


@pytest.mark.parametrize("frames,substeps,first_step", [(30, 2, True), (12, 1, False),
                                                        (5, 0, True), (1, 3, False)])
def test_static_buffer_loop_matches_the_eager_loop(sampled, frames, substeps, first_step):
    """`graph=True`: the steps over static buffers (on the card, one captured step
    replayed) give the eager loop's frames and tangents bit for bit, on the surface states
    and on sampled float32 candidates (contacts included)."""
    r, v, w = (torch.from_numpy(a) for a in _states(list(SURFACES), np.float64))
    for s0 in (P.BallState(r, v, w),
               P.BallState(*(torch.from_numpy(a.astype(np.float32)) for a in sampled))):
        for a, b in zip(P.simulate(s0, frames, substeps, first_step=first_step),
                        P.simulate(s0, frames, substeps, first_step=first_step, graph=True)):
            assert torch.equal(a, b)
        args = (frames, substeps, P.DT, 10.0, 100.0, first_step)
        for a, b in zip(P.simulate_tangent(s0, *args),
                        P.simulate_tangent(s0, *args, graph=True)):
            assert torch.equal(a, b)


def test_s1_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the S1 wrappers are the plain versions and launch nothing; the
    autograd Function's backward (einsum of the cotangent with dr/dq) is the reverse-mode
    gradient through the plain simulate."""
    r, v, w = (torch.from_numpy(a) for a in _states(list(SURFACES), np.float64))
    before = (S1.simulate.launches, S1.simulate_tangent.launches)
    got = S1.simulate(P.BallState(r, v, w), 20)
    for g, j in zip(got, P.simulate(P.BallState(r, v, w), 20)):
        assert torch.equal(g, j)
    q = torch.cat([r, v / 10.0, w / 100.0], -1).requires_grad_(True)
    pos = S1.trajectory_positions(q, 20, 2, v_scale=10.0, w_scale=100.0)
    cot = torch.from_numpy(np.random.default_rng(1).normal(size=tuple(pos.shape)))
    (g_fn,) = torch.autograd.grad((pos * cot).sum(), q)
    ref = P.simulate(S1.params_to_state(q, 10.0, 100.0), 20).r
    (g_ref,) = torch.autograd.grad((ref * cot).sum(), q)
    torch.testing.assert_close(pos, ref, rtol=0, atol=0)
    torch.testing.assert_close(g_fn, g_ref, rtol=1e-10, atol=1e-10)
    assert (S1.simulate.launches, S1.simulate_tangent.launches) == before


def test_s1_refuses_a_device_without_a_kernel():
    s = P.BallState(*(torch.zeros(2, 3, device="meta") for _ in range(3)))
    with pytest.raises(RuntimeError, match="no kernel"):
        S1.simulate(s, 4)


def test_s1_chain_counts_the_flight_step():
    """chip_smoke.py's serial floor of S1, worked out from the plain flight step: at unit
    latencies a forward step is a chain of 17 dependent operations (2 of them divides, 1 a
    square root) out of 169; each extra cycle of divide latency lengthens the chain by 2
    cycles per step, of square root by 1. The tangent's chain is longer, its thread does
    more operations, and the chain is the same for any state (it is the code's)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    unit = {"add": 1.0, "mul": 1.0, "div": 1.0, "sqrt": 1.0}
    assert chip_smoke.s1_chain(unit, "forward") == (17.0, 169)
    slow_div = dict(unit, div=11.0)
    slow_sqrt = dict(unit, sqrt=11.0)
    assert chip_smoke.s1_chain(slow_div, "forward")[0] == 17.0 + 2 * 10
    assert chip_smoke.s1_chain(slow_sqrt, "forward")[0] == 17.0 + 10
    tan_cycles, tan_ops = chip_smoke.s1_chain(unit, "tangent")
    assert tan_cycles > 17.0 and tan_ops > 169
    bound = chip_smoke.s1_bound("forward", 8192, 999, 9 * 500 * 8192 * 4, 9 * 8192 * 4,
                                dict(unit, add=4.0, mul=4.0, div=40.0, sqrt=40.0))
    assert bound["bound_term"] == "serial_chain" and bound["bound_by"] == "operations"
    assert bound["bound_ms"] == max(bound["bytes_ms"], bound["ops_ms"], bound["chain_ms"])


def _chip_smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def test_s1_ptxas_report_is_read_per_kernel():
    """chip_smoke.py's reading of nvcc's -Xptxas -v report for physics.cu: registers,
    spills and stack of each kernel and of each out-of-line exact step, by short name."""
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N_14forward_kernelEPKfS1_S1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N_14forward_kernelEPKfS1_S1_iiii
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 16 bytes cumulative stack size, 520 bytes cmem[0]
ptxas info    : Function properties for _ZN46_GLOBAL__N_110exact_stepINS_4DualEEENS_5StateIT_EES4_PKf
    120 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N_114tangent_kernelEPKfS1_S1_iiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N_114tangent_kernelEPKfS1_S1_iiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 520 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N_117op_latency_kernelEffiPfPy' for 'sm_90a'
ptxas info    : Used 12 registers, used 0 barriers, 384 bytes cmem[0]
"""
    got = _chip_smoke().s1_ptxas(report)
    assert got == {
        "forward_kernel": {"stack": 16, "spill_stores": 0, "spill_loads": 0, "registers": 64},
        "exact_step<Dual>": {"stack": 120, "spill_stores": 8, "spill_loads": 12},
        "tangent_kernel": {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 96}}


def _sass_line(addr, text):
    return (f"        /*{addr:04x}*/                   {text} ;"
            f"                  /* 0x000fe20000000800 */\n"
            f"                                                               /* 0x0 */")


def test_s1_sass_facts_find_the_step_loop():
    """chip_smoke.py's SASS facts: the step loop is the innermost backward branch whose
    span holds at least 100 float instructions, whether cuobjdump prints its target as a
    label or as an address; its kinds are counted, constant-bank operands apart from
    LDC/ULDC."""
    cs = _chip_smoke()
    lines = ["\t\tFunction : _ZN46_GLOBAL__N_114tangent_kernelEPKfS1_S1_iiiiff",
             _sass_line(0x0, "LDC R1, c[0x0][0x28]")]
    addr = 0x10
    outer = addr
    for _ in range(3):
        lines.append(_sass_line(addr, "STG.E [R2.64], R5"))
        addr += 16
    lines.append(".L_x_7:")
    inner = addr
    for i in range(120):
        op = ("FFMA R4, R5, c[0x0][0x230], R6" if i % 3 == 0 else "FMUL R4, R5, R6"
              if i % 3 == 1 else "FADD R4, -R5, R6")
        lines.append(_sass_line(addr, op))
        addr += 16
    for text in ("MUFU.RCP R7, R8", "@P0 CALL.REL.NOINC 0x2000", "ULDC.64 UR4, c[0x0][0x208]",
                 "LDL R9, [R1+0x4]", "@!P1 BRA `(.L_x_7)"):
        lines.append(_sass_line(addr, text))
        addr += 16
    lines.append(_sass_line(addr, f"@P2 BRA 0x{outer:x}"))
    lines.append(_sass_line(addr + 16, "EXIT"))
    lines.append("\t\tFunction : _ZN46_GLOBAL__N_117op_latency_kernelEffiPfPy")
    lines.append(_sass_line(0x0, "EXIT"))
    facts = cs.s1_sass_facts("\n".join(lines))
    assert set(facts) == {"tangent_kernel"}
    loop = facts["tangent_kernel"]["step_loop"]
    assert facts["tangent_kernel"]["instructions"] == 1 + 3 + 120 + 5 + 2
    assert loop["bytes"] == 125 * 16 and loop["instructions"] == 125
    assert (loop["FFMA"], loop["FMUL"], loop["FADD"]) == (40, 40, 40)
    assert (loop["MUFU"], loop["CALL"], loop["ULDC"], loop["LDL"], loop["BRA"]) == (1, 1, 1, 1, 1)
    assert loop["STG"] == 0 and loop["const_operands"] == 40


def test_s1_cycles_per_step_at_the_boost_clock():
    cs = _chip_smoke()
    got = cs.s1_cycles_per_step({"ms": 1.0, "ms_pipelined": 0.5}, 1980)
    assert got == {"cycles_per_step": 1000.0, "cycles_per_step_pipelined": 500.0}
