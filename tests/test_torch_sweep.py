"""Policy sweeps on the CPU: the port's `api.sweep` (its batched lane and
its loop lane) and `stack_states` against the JAX package's, on the
fleet of `test_torch_solve.py`, and the pieces of the batched lane (the
al_step plain version with a lane axis, the fused callback, the
projection, the penalties, the engine's stacked state) against their
one-lane selves.

Tolerances: the port against the JAX package at `PP` = 0.05 pp of carbon
and penalty, the bound `test_torch_solve.py::test_solve_matches_jax`
holds the same policies to (the JAX side runs its generic engine: its
interpret-mode kernel under vmap compiles per solve); the port's batched
lane against its own loop lane within 0.01 pp on every lane, the JAX
package's contract (`tests/test_ensemble.py`); the plain al_step with
lanes against per-lane calls bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.penalty as jpen
from repro.core import api as japi
from repro.core.fleet_solver import synthetic_fleet
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import penalty as tpen
from repro_torch.core.engine import EngineState
from repro_torch.core.fleet_solver import (_bounds, _enter_tick,
                                           device_view, fleet_penalties,
                                           project_days)
from repro_torch.kernels.al_step.ops import make_fused_inner, pack_rows
from repro_torch.kernels.al_step.ref import al_step_ref

PP = 0.05
LANE_PP = 0.01
CR1_GRID = (1.0, 1.45, 2.2)
CR2_GRID = (0.74, 0.82)
STEPS = {"cr1": 200, "cr2": 120}


def _carry(p):
    return convert.fleet_problem_from_arrays(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


@pytest.fixture(scope="module")
def fleet16():
    """`synthetic_fleet(16, hours=48, seed=0)` of the JAX package, cloned
    from its paper fleet calibrated small, with the port's stable
    `name_hash` for the job traces (as in `test_torch_solve.py`)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpen, "hash", tpen.name_hash, raising=False)
    try:
        templates = jpen.build_paper_fleet(num_samples=32, num_jobs=1000)
    finally:
        mp.undo()
    p = synthetic_fleet(16, hours=48, seed=0, templates=templates)
    return p, _carry(p)


def _grid(mod, policy):
    if policy == "cr1":
        return [mod.CR1(lam=lam) for lam in CR1_GRID]
    return [mod.CR2(cap_frac=c, outer=3) for c in CR2_GRID]


def _ctx(use_kernel, **kw):
    return tapi.SolveContext(device="cpu", use_kernel=use_kernel, **kw)


def _close_pp(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.iters == w.iters
        assert abs(g.carbon_reduction_pct - w.carbon_reduction_pct) < tol
        assert abs(g.total_penalty_pct - w.total_penalty_pct) < tol


@pytest.fixture(scope="module", params=["cr1", "cr2"])
def jax_sweeps(request, fleet16):
    """The JAX package's cold sweep of a grid (its batched lane) and the
    warm refinement through `stack_states`, generic engine."""
    p, _ = fleet16
    policy = request.param
    steps = STEPS[policy]
    pols = _grid(japi, policy)
    cold = japi.sweep(p, pols, ctx=japi.SolveContext(use_kernel=False,
                                                     steps=steps))
    warm = japi.sweep(p, pols, ctx=japi.SolveContext(
        use_kernel=False, steps=steps // 4,
        warm=japi.stack_states([r.state for r in cold])))
    return policy, cold, warm


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sweep_matches_reference(fleet16, jax_sweeps, use_kernel):
    """The cold grid, then the refinement warm from each lane's own
    state, through the port's batched lane (generic or fused) against
    the JAX package's, and against the port's own loop lane."""
    _, tp = fleet16
    policy, want_cold, want_warm = jax_sweeps
    steps = STEPS[policy]
    pols = _grid(tapi, policy)
    cold = tapi.sweep(tp, pols, ctx=_ctx(use_kernel, steps=steps))
    _close_pp(cold, want_cold, PP)
    loop = [tapi.solve(tp, pl, ctx=_ctx(use_kernel, steps=steps))
            for pl in pols]
    _close_pp(cold, loop, LANE_PP)
    warm_state = tapi.stack_states([r.state for r in cold])
    assert warm_state.lanes == len(pols)
    warm = tapi.sweep(tp, pols, ctx=_ctx(use_kernel, steps=steps // 4,
                                         warm=warm_state))
    _close_pp(warm, want_warm, PP)
    loop_warm = [tapi.solve(tp, pl, ctx=_ctx(use_kernel, steps=steps // 4,
                                              warm=r.state))
                 for pl, r in zip(pols, loop)]
    _close_pp(warm, loop_warm, LANE_PP)
    for r in cold + warm:
        assert r.D.shape == (16, 48) and np.isfinite(r.D).all()
        assert r.preservation_violation < 1e-3
        assert r.state.x.shape == (16, 48) and r.state.mu.dim() == 0


def test_results_come_back_in_policy_order(fleet16):
    _, tp = fleet16
    pols = [tapi.CR1(lam=lam) for lam in (2.2, 1.0, 1.45)]
    ctx = _ctx(True, steps=24)
    got = tapi.sweep(tp, pols, ctx=ctx)
    for pl, r in zip(pols, got):
        one = tapi.solve(tp, pl, ctx=ctx)
        np.testing.assert_array_equal(r.D, one.D)


@pytest.mark.parametrize("case", ["mixed", "outer", "donate", "shift",
                                  "shared_warm", "stacked_warm_outer"])
def test_loop_lane_matches_solve(fleet16, case):
    """What the batched lane does not take goes through `solve()` per
    policy, with the reference's semantics: a shared warm state read by
    every policy, donate dropped, a stacked warm state sliced per lane."""
    _, tp = fleet16
    base = tapi.solve(tp, tapi.CR1(), ctx=_ctx(True, steps=16))
    cr2 = [tapi.solve(tp, tapi.CR2(outer=2), ctx=_ctx(True, steps=n))
           for n in (16, 12)]
    pols = {"mixed": [tapi.CR1(), tapi.CR2(outer=2)],
            "outer": [tapi.CR2(outer=2), tapi.CR2(outer=1)],
            "stacked_warm_outer": [tapi.CR2(outer=2), tapi.CR2(outer=1)]
            }.get(case, [tapi.CR1(lam=1.2), tapi.CR1(lam=1.6)])
    kw = {"donate": dict(donate=True), "shift": dict(
        warm=base.state, shift=1, reset_mu=True),
        "shared_warm": dict(warm=base.state),
        "stacked_warm_outer": dict(warm=tapi.stack_states(
            [r.state for r in cr2]))}.get(case, {})
    ctx = _ctx(True, steps=8, **kw)
    got = tapi.sweep(tp, pols, ctx=ctx)
    for i, (pl, r) in enumerate(zip(pols, got)):
        one_ctx = dataclasses.replace(ctx, donate=False)
        if case == "stacked_warm_outer":
            one_ctx = dataclasses.replace(ctx, warm=ctx.warm.lane(i))
        np.testing.assert_array_equal(r.D, tapi.solve(tp, pl,
                                                      ctx=one_ctx).D)


def test_stack_states_names_the_mismatched_lane(fleet16):
    _, tp = fleet16
    a = tapi.solve(tp, tapi.CR1(), ctx=_ctx(False, steps=4)).state
    b = tapi.solve(tp, tapi.CR2(outer=1), ctx=_ctx(False, steps=4)).state
    st = tapi.stack_states([a, a])
    assert st.x.shape == (2, 16, 48) and st.mu.shape == (2,)
    with pytest.raises(ValueError, match="state 2 has leaf shapes"):
        tapi.stack_states([a, a, b])
    with pytest.raises(ValueError, match="at least one"):
        tapi.stack_states([])
    assert tapi.sweep(tp, [], ctx=_ctx(False)) == []


@pytest.mark.parametrize("what", ["mesh", "cr3", "b1", "b3"])
def test_unported_refused_by_name(fleet16, what):
    """A mesh that is not a `DeviceMesh` is refused
    (`launch.mesh.check_fleet_mesh`; sharded sweeps are
    `test_torch_sharding_lanes.py`'s). CR3, B1 and B3, refused until
    they were ported, now ride a mixed sweep's loop lane, held against
    the JAX package's (the CR3 rounds, `balanced` and rho as in
    `test_torch_cr3.py`)."""
    p, tp = fleet16
    if what == "mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            tapi.sweep(tp, [tapi.CR1()], ctx=tapi.SolveContext(
                device="cpu", mesh=object()))
        return
    got = tapi.sweep(tp, ["cr1", what], ctx=_ctx(False, steps=20))
    want = japi.sweep(p, ["cr1", what], ctx=japi.SolveContext(
        use_kernel=False, steps=20))
    _close_pp(got, want, PP)
    assert got[1].balanced == want[1].balanced
    if what == "cr3":
        # rel: the JAX package's own one-ulp spread of CR3's price
        # (`test_torch_cr3.py::test_cr3_rho_gap_within_jax_ulp_spread`).
        assert got[1].extras["rho"] == pytest.approx(want[1].extras["rho"],
                                                     rel=0.02)


# ---------------------------------------------------------------------------
# The batched lane's pieces against their one-lane selves
# ---------------------------------------------------------------------------
def _lane_inputs(tp, n, mode, seed, shared, bf16):
    """(x, m, v, usage, jobs, lo, hi, rowp, cvec, scal) for n lanes: each
    lane's own iterate, moments, multipliers, carbon row and scalars; the
    fleet constants shared, or each lane's fleet scaled by its own factor
    (`shared=False`)."""
    rng = np.random.default_rng(seed)
    pv = device_view(tp, torch.device("cpu"))
    lanes = []
    for i in range(n):
        f = 1.0 if shared else 1.0 + 0.1 * i
        q = dataclasses.replace(pv, usage=pv.usage * f, jobs=pv.jobs * f,
                                entitlement=pv.entitlement * f)
        lo, hi = _bounds(q)
        x = torch.clamp(torch.as_tensor(rng.normal(0, 0.3, lo.shape),
                                        dtype=torch.float32), lo, hi)
        m = torch.as_tensor(rng.normal(0, 0.01, lo.shape),
                            dtype=torch.float32)
        v = m * m + torch.as_tensor(np.abs(rng.normal(0, 1e-4, lo.shape)),
                                    dtype=torch.float32)
        refs = torch.as_tensor(np.abs(rng.normal(1, 0.2, tp.W)),
                               dtype=torch.float32)
        rowp = torch.cat([pack_rows(q.rts_coeffs, q.betas, q.k, q.x2_kind,
                                    q.is_batch, refs),
                          torch.as_tensor(rng.normal(0, 0.5, (tp.W, 1)),
                                          dtype=torch.float32),
                          torch.ones((tp.W, 1))], dim=1)
        cvec = torch.as_tensor(rng.normal(-0.5, 0.2, (1, tp.T)),
                               dtype=torch.float32)
        scal = torch.tensor([[1.45 + 0.1 * i, 10.0 * (i + 1), 0.8, 0.02,
                              3.0 + i, 0, 0, 0]])
        if bf16:
            m, v = m.bfloat16(), v.bfloat16()
        lanes.append((x, m, v, q.usage, q.jobs, lo, hi, rowp, cvec, scal))
    stacked = [torch.stack(a) for a in zip(*lanes)]
    stacked[9] = stacked[9][:, 0]
    if shared:
        stacked[3:7] = lanes[0][3:7]
    return lanes, stacked


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_plain_al_step_lanes_are_per_lane_calls(fleet16, mode, shared, bf16):
    _, tp = fleet16
    lanes, stacked = _lane_inputs(tp, 3, mode, 7, shared, bf16)
    kw = dict(mode=mode, k_steps=4)
    got = al_step_ref(*stacked, **kw)
    for i, args in enumerate(lanes):
        for g, w in zip(got, al_step_ref(*args, **kw)):
            assert g.dtype == w.dtype
            assert torch.equal(g[i], w)


@pytest.mark.parametrize("mode", ["cr1", "cr2"])
def test_fused_callback_lanes_are_per_lane_callbacks(fleet16, mode):
    """`make_fused_inner` with lanes (per-lane coef0, scale, step scale,
    mu, multipliers and carbon rows; per-lane fleet constants) runs each
    lane as its one-lane callback does, bit for bit."""
    _, tp = fleet16
    lanes, stacked = _lane_inputs(tp, 3, mode, 11, False, False)
    cfg = tapi._cr2_cfg(20, 1)
    coef0 = torch.tensor([1.0, 1.3, 2.0])
    scale = torch.tensor([0.9, 1.1, 1.3])
    step = torch.tensor([0.05, 0.07, 0.06])
    mu = torch.tensor([10.0, 20.0, 40.0])
    lam = torch.as_tensor(np.random.default_rng(1).normal(0, 0.5, (3, 16)),
                          dtype=torch.float32)
    x, _, _, usage, jobs, lo, hi, rowp, cvec, _ = stacked
    kw = dict(mode=mode, cfg=cfg, k_steps=8)
    fused = make_fused_inner(usage, jobs, lo, hi, rowp[..., :10], cvec,
                             step_scale=step, coef0=coef0, scale=scale,
                             **kw)
    got = fused(x, lam, None, mu)
    for i, a in enumerate(lanes):
        one = make_fused_inner(a[3], a[4], a[5], a[6], a[7][:, :10], a[8],
                               step_scale=step[i], coef0=coef0[i],
                               scale=scale[i], **kw)
        assert torch.equal(got[i], one(a[0], lam[i], None, mu[i]))


def test_projection_and_penalties_of_stacked_rows(fleet16):
    """`project_days` and `fleet_penalties` on (N, W, T) lanes, shared or
    per-lane bounds, are the per-lane calls (N·W rows, no lane loop)."""
    _, tp = fleet16
    for shared in (True, False):
        lanes, stacked = _lane_inputs(tp, 3, "cr2", 5, shared, False)
        x = 3.0 * stacked[0]
        isb = torch.as_tensor(tp.is_batch)
        got = project_days(x, stacked[5], stacked[6], isb, 24)
        pv = device_view(tp, torch.device("cpu"))
        q = dataclasses.replace(pv, usage=stacked[3], jobs=stacked[4])
        for use_kernel in (False, True):
            pens = fleet_penalties(q, x, use_kernel)
            for i, a in enumerate(lanes):
                torch.testing.assert_close(
                    got[i], project_days(x[i], a[5], a[6], isb, 24),
                    rtol=0, atol=1e-6)
                one = dataclasses.replace(pv, usage=a[3], jobs=a[4])
                torch.testing.assert_close(
                    pens[i], fleet_penalties(one, x[i], use_kernel),
                    rtol=1e-6, atol=1e-6)


def test_stacked_state_shift_and_tick_entry():
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    st = EngineState(x=x, lam_eq=torch.ones((2, 3)),
                     lam_in=torch.zeros((2, 0)), mu=torch.tensor([5.0, 9.0]))
    assert st.lanes == 2 and EngineState.cold(x[0]).lanes is None
    out = _enter_tick(st, 1, True, 10.0)
    for i in range(2):
        one = _enter_tick(st.lane(i), 1, True, 10.0)
        assert torch.equal(out.x[i], one.x)
        assert torch.equal(out.mu[i], one.mu)
    assert torch.equal(out.mu, torch.tensor([10.0, 10.0]))
    assert torch.equal(out.lam_eq, st.lam_eq)
