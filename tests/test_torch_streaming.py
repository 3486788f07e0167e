"""Rolling-horizon streaming, on the CPU: the port's
`RollingHorizonSolver` and `solve_day` against the JAX package's on the
same fleet and the same forecasts.

The fleet is `test_torch_solve.py`'s (16 rows cloned from the paper fleet
calibrated small, the JAX package's job traces seeded with the port's
stable hash), carried across with `convert.fleet_problem_from_arrays`.
Tolerances: mixed fleets at solution level, 0.05 pp of realized or
planned carbon and penalty (the JAX package's fused-vs-generic bound: the
hinge subgradient makes iterates chaotic under ulp-level changes, and the
port projects exactly where the JAX package takes 3 rounds of day-mean
removal); an RTS-only fleet has no hinge, so there the committed hours
are compared at 1e-4; the port's `run_scanned` against its own `run()` at
the JAX package's contract (`tests/test_streaming.py`): 0.01 pp realized,
committed within 5e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.penalty as jpen
from repro.core import api as japi
from repro.core import streaming as jstream
from repro.core.carbon import ForecastStream as JStream
from repro.core.fleet_solver import synthetic_fleet
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import penalty as tpen
from repro_torch.core import streaming as tstream
from repro_torch.core.carbon import ForecastStream as TStream
from repro_torch.obs import TelemetryConfig, read_events

PP = 0.05
TICKS = 4
KW = dict(outer=2, cold_steps=160, warm_steps=40)


def _carry(p):
    return convert.fleet_problem_from_arrays(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


@pytest.fixture(scope="module")
def fleet16():
    """`synthetic_fleet(16, hours=48, seed=0)` of the JAX package, cloned
    from its paper fleet calibrated at num_samples=32, num_jobs=1000, with
    the port's stable `name_hash` for the job traces (as in
    `test_torch_solve.py`)."""
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


def _streams(seed=3, sigma=0.03, n=TICKS):
    return (JStream.caiso(n_ticks=n, horizon=48, seed=seed,
                          revision_sigma=sigma),
            TStream.caiso(n_ticks=n, horizon=48, seed=seed,
                          revision_sigma=sigma))


def _controllers(p, tp, policy, use_kernel, **kw):
    js, ts = _streams()
    kw = {**KW, **kw}
    return (jstream.RollingHorizonSolver(p, js, policy=policy,
                                         use_kernel=use_kernel, **kw),
            tstream.RollingHorizonSolver(tp, ts, policy=policy,
                                         use_kernel=use_kernel,
                                         device="cpu", **kw))


POLICIES = ["cr1", "cr2"]


def make_runs(fleet16, policy, use_kernel):
    """The JAX package's and the port's `run(4)`, and the port's
    `run_scanned(4)`, on one policy and engine."""
    p, tp = fleet16
    jrhs, trhs = _controllers(p, tp, policy, use_kernel)
    scan = _controllers(p, tp, policy, use_kernel)[1].run_scanned(TICKS)
    return jrhs.run(TICKS), trhs.run(TICKS), scan


def check_run(want, got):
    """The port's `run()` against the JAX package's."""
    assert got.committed.shape == (16, TICKS)
    assert np.isfinite(got.committed).all()
    assert abs(got.realized_reduction_pct
               - want.realized_reduction_pct) < PP
    assert [t.forecast_mci for t in got.ticks] \
        == [t.forecast_mci for t in want.ticks]
    assert [t.inner_steps for t in got.ticks] \
        == [t.inner_steps for t in want.ticks]
    assert got.total_inner_steps == want.total_inner_steps
    assert got.realized_baseline == pytest.approx(want.realized_baseline,
                                                  rel=1e-6)
    # plan retention: the full plan on the latest tick only
    assert got.ticks[-1].plan is not None
    assert all(t.plan is None for t in got.ticks[:-1])


def check_scan(loop, scan):
    """The port's day against the port's per-tick loop, at the JAX
    package's own contract."""
    assert abs(scan.realized_reduction_pct
               - loop.realized_reduction_pct) < 0.01
    assert scan.committed.shape == loop.committed.shape == (16, TICKS)
    np.testing.assert_allclose(scan.committed, loop.committed, atol=5e-3)
    assert [t.inner_steps for t in scan.ticks] \
        == [t.inner_steps for t in loop.ticks]
    assert [t.forecast_mci for t in scan.ticks] \
        == [t.forecast_mci for t in loop.ticks]
    assert scan.ticks[-1].plan is not None
    assert all(t.plan is None for t in scan.ticks[:-1])
    assert scan.ticks[-1].plan.preservation_violation < 1e-3


def _day_pct(day, stack, p):
    """Carbon of the committed hours, priced at each tick's hour-0
    forecast, in % of the no-DR carbon of those hours."""
    usage = np.asarray(p.usage)
    car = sum(float(day.committed[i].sum()) * float(stack[i, 0])
              for i in range(len(stack)))
    base = sum(float(usage[:, i].sum()) * float(stack[i, 0])
               for i in range(len(stack)))
    return 100.0 * car / base


def _window(p, tick):
    def roll(a):
        return np.roll(np.asarray(a), -tick, axis=1)

    return dataclasses.replace(p, usage=roll(p.usage), jobs=roll(p.jobs))


def check_day(fleet16, policy, use_kernel, days):
    """`days` consecutive days of 4 ticks, each after the first
    warm-started from the last one's state, in each package. A day is
    held by what it commits: the committed hours' carbon within 0.05 pp
    and every committed hour within 5e-3 NP (the JAX package's
    loop-vs-day bound), and the last plan's penalty within 0.05 pp. The
    last plan's full-horizon carbon is not compared: on a warm CR2 day at
    2 x 40 steps it is not converged, and the JAX package's own fused and
    generic days differ by 0.03 pp there."""
    p, tp = fleet16
    js, ts = _streams(n=days * TICKS)
    stack = np.stack([ts.forecast(t) for t in range(days * TICKS)])
    np.testing.assert_array_equal(
        stack, np.stack([js.forecast(t) for t in range(days * TICKS)]))
    jpol = japi.configured_policy(policy, outer=2)
    tpol = tapi.configured_policy(policy, outer=2)
    steps = dict(cold_steps=KW["cold_steps"], warm_steps=KW["warm_steps"])
    mult = 2 if policy == "cr2" else 1
    want = got = None
    for day in range(days):
        t0 = day * TICKS
        s = stack[t0:t0 + TICKS]
        want = japi.solve_day(_window(p, t0), jpol, s, ctx=japi.SolveContext(
            use_kernel=use_kernel,
            warm=None if want is None else want.last.state), **steps)
        got = tapi.solve_day(_window(tp, t0), tpol, s, ctx=tapi.SolveContext(
            device="cpu", use_kernel=use_kernel,
            warm=None if got is None else got.last.state), **steps)
        first = KW["warm_steps"] if day else KW["cold_steps"]
        assert got.inner_steps == want.inner_steps == \
            (first * mult,) + (KW["warm_steps"] * mult,) * (TICKS - 1)
        assert got.committed.shape == (TICKS, 16)
        assert np.isfinite(got.committed).all()
        np.testing.assert_allclose(got.committed, want.committed, atol=5e-3)
        win = _window(p, t0)
        assert abs(_day_pct(got, s, win) - _day_pct(want, s, win)) < PP
        assert abs(got.last.total_penalty_pct
                   - want.last.total_penalty_pct) < PP
        assert got.last.preservation_violation < 1e-3


def check_rts_only(fleet16, policy, use_kernel):
    """No hinge on an RTS-only fleet: the committed hours of every tick
    agree with the JAX package's within 1e-4 NP."""
    p = _rts_only(fleet16[0])
    jrhs, trhs = _controllers(p, _carry(p), policy, use_kernel)
    want, got = jrhs.run(TICKS), trhs.run(TICKS)
    np.testing.assert_allclose(got.committed, want.committed, rtol=1e-4,
                               atol=1e-4)


# The generic engine here; the fused path (the kernels' plain versions on
# the CPU) in `test_torch_streaming_fused.py`, a file of its own because
# the JAX package compiles its interpret-mode kernel for every solve and
# day configuration (~5 s each on the CPU): together they would pass a
# minute.
@pytest.fixture(scope="module", params=POLICIES)
def runs(request, fleet16):
    return make_runs(fleet16, request.param, False)


def test_run_matches_reference(runs):
    check_run(*runs[:2])


def test_run_scanned_matches_run(runs):
    check_scan(*runs[1:])


@pytest.mark.parametrize("policy", POLICIES)
def test_solve_day_matches_reference(fleet16, policy):
    """A cold day, then the next day warm-started from it."""
    check_day(fleet16, policy, False, days=2)


@pytest.mark.parametrize("policy", POLICIES)
def test_rts_only_committed_hours_match_reference(fleet16, policy):
    check_rts_only(fleet16, policy, False)


@pytest.mark.parametrize("sigma,levels", [(0.002, (10, 20, 30)),
                                          (0.03, (10, 20, 30, 40)),
                                          (0.5, (40,))])
def test_adaptive_warm_budgets_match_reference(fleet16, sigma, levels):
    """Quiet, default and violent forecast revisions: each warm tick's
    budget is the JAX package's, one of 4 quantized levels between
    warm_steps_min = 10 and warm_steps = 40 (a quiet stream stays below
    the full budget, a violent one spends it). Only the budgets are
    compared: under violent revisions (12 hours forecast at zero MCI)
    the JAX package's 3 rounds of day-mean removal leave its batch days
    2-3 NP·h off, where the port's exact projection holds them, so the
    two plans part (ROADMAP queue 3, A1); the port's days are checked."""
    p, tp = fleet16
    js, ts = _streams(sigma=sigma)
    kw = dict(KW, policy="cr1", adaptive_warm=True, use_kernel=False)
    want = jstream.RollingHorizonSolver(p, js, **kw).run(TICKS)
    got = tstream.RollingHorizonSolver(tp, ts, device="cpu", **kw).run(TICKS)
    budgets = [t.inner_steps for t in got.ticks]
    assert budgets == [t.inner_steps for t in want.ticks]
    assert budgets[0] == KW["cold_steps"]
    assert all(b in levels for b in budgets[1:]), budgets
    assert got.ticks[-1].plan.preservation_violation < 1e-3


def _validation_cases():
    def mk(mod, stream_cls, p, **kw):
        return mod.RollingHorizonSolver(
            p, stream_cls.caiso(n_ticks=2, horizon=kw.pop("horizon", 48)),
            **kw)

    return {
        "horizon_mismatch": (ValueError, "horizon",
                             lambda m, S, p: mk(m, S, p, horizon=24)),
        "unknown_policy": (ValueError, "registered policies.*cr1.*cr2",
                           lambda m, S, p: mk(m, S, p, policy="cr9")),
        "not_a_policy": (TypeError, "DRPolicy",
                         lambda m, S, p: mk(m, S, p, policy=1.45)),
        "warm_floor_above_budget": (
            ValueError, "warm_steps_min",
            lambda m, S, p: mk(m, S, p, warm_steps=100, adaptive_warm=True,
                               warm_steps_min=200)),
        "warm_floor_zero": (ValueError, "warm_steps_min",
                            lambda m, S, p: mk(m, S, p, warm_steps_min=0)),
        "revision_ref": (ValueError, "revision_ref",
                         lambda m, S, p: mk(m, S, p, adaptive_warm=True,
                                            revision_ref=0.0)),
        "report_before_step": (RuntimeError, "no ticks",
                               lambda m, S, p: mk(m, S, p).report()),
        "scanned_adaptive": (ValueError, "adaptive_warm",
                             lambda m, S, p: mk(m, S, p, adaptive_warm=True
                                                ).run_scanned(2)),
        "scanned_no_ticks": (ValueError, "n_ticks",
                             lambda m, S, p: mk(m, S, p).run_scanned(0)),
    }


@pytest.mark.parametrize("case", sorted(_validation_cases()))
def test_validation_errors_match_reference(fleet16, case):
    """Each bad input raises the JAX package's exception type, before any
    solve."""
    p, tp = fleet16
    exc, match, make = _validation_cases()[case]
    with pytest.raises(exc):
        make(jstream, JStream, p)
    with pytest.raises(exc, match=match):
        make(tstream, TStream, tp)


def test_solve_day_validation_matches_reference(fleet16):
    p, tp = fleet16
    stack = np.stack([np.asarray(p.mci)] * 2)
    for mod, prob, ctx in ((japi, p, None),
                           (tapi, tp, tapi.SolveContext(device="cpu"))):
        with pytest.raises(TypeError, match="FleetProblem"):
            mod.solve_day(object(), "cr1", stack, ctx=ctx)
        with pytest.raises(ValueError, match="mci_stack"):
            mod.solve_day(prob, "cr1", stack[:, :10], ctx=ctx)
        with pytest.raises(NotImplementedError):
            mod.solve_day(prob, "b1", stack, ctx=ctx)
    # a warm state of another policy's shape is refused before the day
    ctx = tapi.SolveContext(device="cpu")
    cr1 = tapi.solve_day(tp, "cr1", stack, ctx=ctx, cold_steps=8)
    with pytest.raises(ValueError, match="ctx.warm.lam_eq"):
        tapi.solve_day(tp, "cr2", stack, cold_steps=8, ctx=tapi.SolveContext(
            device="cpu", warm=cr1.last.state))


def test_policy_knobs_and_defaults(fleet16):
    _, tp = fleet16
    ts = _streams(n=2)[1]
    by_name = tstream.RollingHorizonSolver(tp, ts, policy="cr2",
                                           cap_frac=0.8, outer=2)
    assert by_name.policy == tapi.CR2(cap_frac=0.8, outer=2)
    by_obj = tstream.RollingHorizonSolver(
        tp, ts, policy=tapi.CR2(cap_frac=0.8, outer=2))
    assert by_obj.policy == by_name.policy
    assert tstream.RollingHorizonSolver(tp, ts).policy == tapi.CR1(lam=1.45)
    assert tstream.RollingHorizonSolver(
        tp, ts, warm_steps=100, adaptive_warm=True).warm_steps_min == 25
    assert by_name.last_rho is None
    assert tapi.configured_policy("cr2") == tapi.CR2(cap_frac=0.78, outer=4)


# A mesh that is not a `DeviceMesh`, refused by the constructor (sharded
# streaming is `test_torch_sharding_lanes.py`'s).
REFUSALS = {
    "mesh": (dict(mesh=object(), device="cpu"), "DeviceMesh"),
}
# Options the port refused by name until the tick ledger, in-solve
# telemetry and the recompile guard were ported: each now runs 2 ticks
# and a 2-tick day (cold 16 / warm 8 steps) and writes a ledger.
LEDGER = {
    "events": dict(),
    "telemetry": dict(telemetry=TelemetryConfig(every=4)),
    "guard_recompiles": dict(guard_recompiles=True),
}
# Options the port refused by name until CR3 and the baselines were
# ported: each now runs, and is held against the JAX package's controller
# (2 ticks, cold 16 / warm 8 steps; CR3 by name takes outer 4, as there).
PORTED = {
    "cr3": dict(policy="cr3"),
    "b1": dict(policy="b1"),
    "b3": dict(policy="b3"),
    "rho": dict(policy="cr3", rho=0.03),
    "tax_frac": dict(policy="cr3", tax_frac=0.25),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + sorted(LEDGER)
                         + sorted(PORTED))
def test_unported_options_refuse_by_name(fleet16, case, tmp_path):
    p, tp = fleet16
    if case in REFUSALS:
        kw, item = REFUSALS[case]
        with pytest.raises(TypeError, match=item):
            tstream.RollingHorizonSolver(tp, _streams(n=2)[1], **kw)
        return
    if case in LEDGER:
        path = tmp_path / "ticks.jsonl"
        trhs = tstream.RollingHorizonSolver(
            tp, _streams(n=4)[1], device="cpu", cold_steps=16, warm_steps=8,
            events=str(path), **LEDGER[case])
        trhs.run(2)
        trhs.run_scanned(2)
        recs = read_events(path)
        assert recs[0]["host"]["platform"] == "cpu"
        ticks = [r for r in recs if r["kind"] == "tick"]
        assert [t["tick"] for t in ticks] == [0, 1, 2, 3]
        assert [t["cold"] for t in ticks] == [True, False, False, False]
        assert [t["warm_steps"] for t in ticks] == [16, 8, 8, 8]
        assert [t["dispatches"] for t in ticks] == [1, 1, 1, 0]
        assert all(t["recompiles"] == 0 for t in ticks)   # eager CPU
        tel = {r["tick"] for r in recs if r["kind"] == "telemetry"}
        assert tel == ({0, 1, 2, 3} if case == "telemetry" else set())
        return
    kw = dict(PORTED[case], cold_steps=16, warm_steps=8)
    js, ts = _streams(n=2)
    jrhs = jstream.RollingHorizonSolver(p, js, use_kernel=False, **kw)
    trhs = tstream.RollingHorizonSolver(tp, ts, device="cpu", **kw)
    assert trhs.policy == tapi.configured_policy(
        kw["policy"], **{k: v for k, v in kw.items()
                         if k in ("rho", "tax_frac")})
    want, got = jrhs.run(2), trhs.run(2)
    assert [t.inner_steps for t in got.ticks] \
        == [t.inner_steps for t in want.ticks]
    assert abs(got.realized_reduction_pct
               - want.realized_reduction_pct) < PP
    if trhs.last_rho is None:
        assert jrhs.last_rho is None
    else:
        # rel: the JAX package's own one-ulp spread of CR3's price
        # (`test_torch_cr3.py::test_cr3_rho_gap_within_jax_ulp_spread`).
        assert trhs.last_rho == pytest.approx(jrhs.last_rho, rel=0.02)
        assert trhs.last_rho == got.ticks[-1].plan.extras["rho"]


def test_multi_region_refused(fleet16):
    """The controller takes one stream per region, as the JAX package's:
    another count raises `ValueError` naming it (multi-region runs are
    held against the JAX package in
    `tests/test_torch_multiregion_streaming.py`); CR3's day stays refused
    by name in both packages."""
    p, tp = fleet16
    js, ts = _streams(n=2)
    two = [dataclasses.replace(q, mci=np.stack([q.mci, q.mci]),
                               region=np.arange(q.W) % 2) for q in (p, tp)]
    for mod, prob, pair, stream in ((jstream, p, two[0], js),
                                    (tstream, tp, two[1], ts)):
        with pytest.raises(ValueError, match="need 1 forecast stream"):
            mod.RollingHorizonSolver(prob, [stream, stream])
        with pytest.raises(ValueError, match="need 2 forecast stream"):
            mod.RollingHorizonSolver(pair, stream)
    assert tstream.RollingHorizonSolver(two[1], [ts, ts],
                                        device="cpu").streams == (ts, ts)
    for mod, prob, ctx in ((japi, p, None),
                           (tapi, tp, tapi.SolveContext(device="cpu"))):
        with pytest.raises(NotImplementedError,
                           match="cr3 needs host-side control flow"):
            mod.solve_day(prob, "cr3", np.stack([prob.mci] * 2), ctx=ctx)


def test_day_impl_is_solve_day_on_the_cpu(fleet16):
    """On the CPU `solve_day` is its tick loop run eagerly: the same
    numbers, bit for bit."""
    _, tp = fleet16
    stack = np.stack([_streams()[1].forecast(t) for t in range(3)])
    ctx = tapi.SolveContext(device="cpu", use_kernel=True)
    day = tapi.solve_day(tp, tapi.CR2(outer=2), stack, ctx=ctx,
                         cold_steps=24)
    _, _, cfg, inputs = tapi._day_setup(tp, tapi.CR2(outer=2), stack, ctx,
                                        24, None)
    with torch.no_grad():
        out = tapi._day_impl(cfg, inputs)
    np.testing.assert_array_equal(out[0].numpy(), day.committed)
    np.testing.assert_array_equal(out[3].numpy(), day.last.state.x.numpy())
    assert day.inner_steps == (48, 12, 12)
    assert cfg.first_shift == 0 and not cfg.first_reset and not cfg.warm


def test_run_scanned_warm_continuation(fleet16):
    """Per-tick steps, then a scanned remainder: the day warm-starts from
    (and updates) the solver state; a second day keeps chaining."""
    _, tp = fleet16
    rhs = tstream.RollingHorizonSolver(tp, _streams(n=6)[1], policy="cr1",
                                       cold_steps=40, warm_steps=10,
                                       device="cpu")
    rhs.step()
    rhs.step()
    rep = rhs.run_scanned(2)
    assert [t.inner_steps for t in rep.ticks] == [40, 10, 10, 10]
    assert rhs._tick == 4
    assert rep.ticks[-1].plan.state is rhs._state
    assert all(t.plan is None for t in rep.ticks[:-1])
    rep = rhs.run_scanned()
    assert [t.tick for t in rep.ticks] == list(range(rhs.stream.n_ticks))
    assert np.isfinite(rep.committed).all()
