"""The slice end to end: the JAX package's fleet carried into the port,
solved by both packages in the same test, on the CPU.

Mixed fleets are compared at solution level (carbon % and penalty %
within 0.05 pp, the JAX package's own fused-vs-generic bound): the hinge
subgradient makes iterates chaotic under ulp-level changes. The port
projects exactly where the JAX package takes 3 rounds of day-mean
removal, a deliberate departure that the solution-level bound covers and
that is checked for what it is for, the day preservation. An RTS-only
fleet has no hinge, so there the generic engine's iterate is compared
at 1e-5 (the CR2 multipliers at 1e-3, see there).
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

PP = 0.05


def _carry(p):
    return convert.fleet_problem_from_arrays(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


@pytest.fixture(scope="module")
def fleet16():
    """`synthetic_fleet(16, hours=48, seed=0)` of the JAX package, cloned
    from its paper fleet calibrated at num_samples=32, num_jobs=1000.
    That package seeds job traces with Python's per-process `hash`; its
    module is handed the port's stable `name_hash` for this build, so the
    fleet, and with it every number below, is the same in every run."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpen, "hash", tpen.name_hash, raising=False)
    try:
        templates = jpen.build_paper_fleet(num_samples=32, num_jobs=1000)
    finally:
        mp.undo()
    p = synthetic_fleet(16, hours=48, seed=0, templates=templates)
    return p, _carry(p)


def _rts_only(p):
    """Every batch row recast as an RTS row (smooth cubic penalty)."""
    cubic = np.array([2e-4, 1.5e-3, 0.04])
    rts = np.where(np.asarray(p.is_batch)[:, None], cubic, p.rts_coeffs)
    return dataclasses.replace(p, is_batch=np.zeros(p.W, bool),
                               betas=np.zeros((p.W, 3)), rts_coeffs=rts)


POLICIES = {
    "cr1": (japi.CR1(lam=1.45), tapi.CR1(lam=1.45), 200),
    "cr2": (japi.CR2(cap_frac=0.78, outer=3), tapi.CR2(cap_frac=0.78,
                                                       outer=3), 120),
}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_solve_matches_jax(fleet16, policy, use_kernel):
    """The generic engine against the JAX package's generic engine; the
    fused path (the kernels' plain versions on the CPU) against the JAX
    package's fused path."""
    p, tp = fleet16
    jpol, tpol, steps = POLICIES[policy]
    want = japi.solve(p, jpol, ctx=japi.SolveContext(use_kernel=use_kernel,
                                                     steps=steps))
    got = tapi.solve(tp, tpol, ctx=tapi.SolveContext(
        device="cpu", use_kernel=use_kernel, steps=steps))
    assert got.D.shape == (16, 48) and np.isfinite(got.D).all()
    assert got.iters == want.iters
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < PP
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < PP


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_default_rounds_preserve_days(fleet16, policy, use_kernel):
    """With the port's exact projection the batch day sums close to the
    1e-3 the card's check demands (the JAX package's 3 rounds of day-mean
    removal leave them open at fleet scale); the plan stays in its box."""
    p, tp = fleet16
    _, tpol, steps = POLICIES[policy]
    got = tapi.solve(tp, tpol, ctx=tapi.SolveContext(
        device="cpu", use_kernel=use_kernel, steps=steps))
    assert got.preservation_violation < 1e-3
    assert np.isfinite(got.D).all()
    usage, ent = np.asarray(p.usage), np.asarray(p.entitlement)[:, None]
    assert (got.D <= np.minimum(0.5 * ent, usage) + 1e-4).all()


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_rts_only_iterate_matches_jax(fleet16, policy):
    p = _rts_only(fleet16[0])
    jpol, tpol, _ = POLICIES[policy]
    for use_kernel in (False, True):
        want = japi.solve(p, jpol, ctx=japi.SolveContext(
            use_kernel=use_kernel, steps=40))
        got = tapi.solve(_carry(p), tpol, ctx=tapi.SolveContext(
            device="cpu", use_kernel=use_kernel, steps=40))
        np.testing.assert_allclose(got.D, np.asarray(want.D), rtol=1e-5,
                                   atol=1e-5)
        # lam_eq sums mu·h over the rounds; h = (pen − ref)/scale is a
        # difference of float32 sums over the horizon, which mu (up to 40
        # here) scales up: 1e-3 relative.
        np.testing.assert_allclose(got.state.lam_eq.numpy(),
                                   np.asarray(want.state.lam_eq), rtol=1e-3,
                                   atol=1e-5)


def test_warm_start_carried_from_jax(fleet16):
    """A JAX solve's EngineState carried over warm-starts the port's solve
    (shifted one hour, mu reset) exactly as it warm-starts the JAX one."""
    p = _rts_only(fleet16[0])
    jpol, tpol, _ = POLICIES["cr2"]
    first = japi.solve(p, jpol, ctx=japi.SolveContext(use_kernel=False,
                                                      steps=20))
    st = first.state
    warm = convert.engine_state_from_arrays(
        np.asarray(st.x), np.asarray(st.lam_eq), np.asarray(st.lam_in),
        np.asarray(st.mu), device="cpu")
    want = japi.solve(p, jpol, ctx=japi.SolveContext(
        use_kernel=False, steps=20, warm=st, shift=1, reset_mu=True))
    got = tapi.solve(_carry(p), tpol, ctx=tapi.SolveContext(
        device="cpu", use_kernel=False, steps=20, warm=warm, shift=1,
        reset_mu=True))
    np.testing.assert_allclose(got.D, np.asarray(want.D), rtol=1e-5,
                               atol=1e-5)
    assert float(got.state.mu) == pytest.approx(float(want.state.mu))


def test_bf16_moments_solve(fleet16):
    """bf16 Adam moments through the fused path stay near the f32 solve."""
    _, tp = fleet16
    ctx = dict(device="cpu", use_kernel=True, steps=60)
    a = tapi.solve(tp, tapi.CR1(), ctx=tapi.SolveContext(**ctx))
    b = tapi.solve(tp, tapi.CR1(), ctx=tapi.SolveContext(
        moment_dtype="bfloat16", **ctx))
    assert abs(a.carbon_reduction_pct - b.carbon_reduction_pct) < 0.5
    assert b.state.x.dtype == torch.float32


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_horizon_shorter_than_a_day(fleet16, policy):
    """The fleet's first 12 hours with `day_hours` 24: the projection, the
    fused path (the kernel's plain version here) and the report all take
    the horizon as one 12-hour day. The JAX package refuses such a horizon
    in its projection, so the fused path is held to the generic engine at
    the solution-level bound."""
    p = fleet16[0]
    short = dataclasses.replace(p, usage=np.asarray(p.usage)[:, :12],
                                jobs=np.asarray(p.jobs)[:, :12],
                                mci=np.asarray(p.mci)[:12])
    tp = _carry(short)
    assert (tp.T, tp.day_hours) == (12, 24)
    _, tpol, steps = POLICIES[policy]
    fused, generic = (tapi.solve(tp, tpol, ctx=tapi.SolveContext(
        device="cpu", use_kernel=uk, steps=steps)) for uk in (True, False))
    for r in (fused, generic):
        assert r.D.shape == (16, 12) and np.isfinite(r.D).all()
        assert r.preservation_violation < 1e-3
    assert abs(fused.carbon_reduction_pct
               - generic.carbon_reduction_pct) < PP
    assert abs(fused.total_penalty_pct - generic.total_penalty_pct) < PP
