"""Scenario ensembles on the CPU: the port's `evaluate_ensemble` (its
batched lane and its loop lane), `run_streaming_ensemble` and the risk
layer against the JAX package's, on the fleet of `test_torch_solve.py`.

Tolerances: the port against the JAX package at `PP` = 0.05 pp of carbon
and penalty (the bound of `test_torch_solve.py::test_solve_matches_jax`;
the JAX side runs its generic engine, since its interpret-mode kernel
under vmap compiles per solve); the port's batched lane against its own
loop lane, and the streaming ensemble against solo controllers and
against the JAX package's, within 0.01 pp on every scenario, the JAX
package's contract (`tests/test_ensemble.py`; committed hours within
5e-3 NP, its loop-vs-day bound). The risk layer is held to the reference's on
the same plans, to float64 rounding.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.penalty as jpen
from repro.core import api as japi
from repro.core import ensemble as jens
from repro.core import scenario as jscen
from repro.core.carbon import ForecastStream as JStream
from repro.core.fleet_solver import synthetic_fleet
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import ensemble as tens
from repro_torch.core import penalty as tpen
from repro_torch.core import scenario as tscen
from repro_torch.core.carbon import ForecastStream
from repro_torch.core.fleet_solver import _bounds, device_view
from repro_torch.core.streaming import RollingHorizonSolver

PP = 0.05
LANE_PP = 0.01
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


def _scenarios(mod, policy):
    """chip_smoke's mix, small: duck-curve and Cambium MCI scenarios; for
    CR2 also fleet jitter, so the targets differ per scenario."""
    gens = [mod.DuckPerturb(2, seed=0), mod.CambiumMix(2, seed=1)]
    if policy == "cr2":
        gens.append(mod.FleetJitter(2, seed=2))
    return gens


def _policy(mod, policy):
    return mod.CR1(lam=1.45) if policy == "cr1" else mod.CR2(cap_frac=0.78,
                                                              outer=3)


@pytest.fixture(scope="module", params=["cr1", "cr2"])
def jax_ensemble(request, fleet16):
    p, _ = fleet16
    policy = request.param
    res = jens.evaluate_ensemble(
        p, _policy(japi, policy), _scenarios(jscen, policy),
        ctx=japi.SolveContext(use_kernel=False, steps=STEPS[policy]))
    return policy, res


def _close(got, want, tol):
    assert got.labels == want.labels
    assert np.abs(got.carbon_reduction_pct
                  - want.carbon_reduction_pct).max() < tol
    assert np.abs(got.total_penalty_pct - want.total_penalty_pct).max() < tol


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ensemble_matches_reference_and_loop(fleet16, jax_ensemble,
                                             use_kernel):
    """The port's batched lane (generic or fused) against the JAX
    package's batched lane, and against the port's own loop lane."""
    p, tp = fleet16
    policy, want = jax_ensemble
    ctx = tapi.SolveContext(device="cpu", use_kernel=use_kernel,
                            steps=STEPS[policy])
    pol = _policy(tapi, policy)
    got = tens.evaluate_ensemble(tp, pol, _scenarios(tscen, policy),
                                 ctx=ctx)
    loop = tapi.ensemble(tp, pol, _scenarios(tscen, policy), ctx=ctx,
                         batched=False)
    assert got.batched and not loop.batched
    assert got.D.shape == (want.S, 16, 48) and np.isfinite(got.D).all()
    _close(got, want, PP)
    _close(got, loop, LANE_PP)
    np.testing.assert_allclose(got.entitlement, want.entitlement)
    assert (got.preservation_violation < 1e-3).all()
    np.testing.assert_allclose(got.penalties, loop.penalties, rtol=1e-3,
                               atol=1e-4)


def test_cr2_targets_per_scenario_only_where_fleet_overlays(fleet16,
                                                            monkeypatch):
    """One target computation for an MCI-only stack, one per scenario once
    usage, entitlement or jobs are overlaid (the reference's rule)."""
    _, tp = fleet16
    calls = []
    real = tens.cr2_reference_fleet
    monkeypatch.setattr(tens, "cr2_reference_fleet",
                        lambda *a: calls.append(1) or real(*a))
    pol = tapi.CR2(outer=1)
    for gens, want in (([tscen.DuckPerturb(3)], 1),
                       ([tscen.DuckPerturb(3), tscen.FleetJitter(2)], 5)):
        calls.clear()
        stack = tscen.resolve_scenarios(gens, tp)
        refs = tens._cr2_refs(pol, tp, stack, torch.device("cpu"))
        assert len(calls) == want and len(refs) == stack.S


def test_flex_mix_overlay_batched_matches_loop(fleet16):
    """The operational cap overlay (+inf where another generator's
    scenarios have none) through the batched lane."""
    _, tp = fleet16
    gens = [tscen.DuckPerturb(1, seed=3), tscen.FlexMixShift(2, seed=3)]
    ctx = tapi.SolveContext(device="cpu", use_kernel=True, steps=80)
    got = tens.evaluate_ensemble(tp, tapi.CR1(), gens, ctx=ctx)
    loop = tens.evaluate_ensemble(tp, tapi.CR1(), gens, ctx=ctx,
                                  batched=False)
    _close(got, loop, LANE_PP)


def _day_sum_gap(q, D):
    """Largest distance of a batch day's sum from the nearest sum its box
    allows, and the count of days whose box admits no zero sum."""
    isb = np.asarray(q.is_batch, bool)
    E = np.asarray(q.entitlement)[isb, None]
    U = np.asarray(q.usage)[isb]
    hi = np.minimum(q.max_curtail_frac * E, U)
    lo = np.minimum(U - E, hi)

    def days(a):
        return a.reshape(a.shape[0], -1, 24).sum(-1)

    target = np.clip(0.0, days(lo), days(hi))
    return float(np.abs(days(D[isb]) - target).max()), int(
        (target != 0).sum())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_overloaded_days_end_at_their_nearest_sum(fleet16, use_kernel):
    """FleetJitter draws usage above entitlement: such batch days admit no
    zero-sum plan, and some hours exceed what the cap can bring under E
    (U - E > 0.5 E). The box stays consistent there (`_bounds`: lo = hi),
    so every day, fused or generic, ends at the nearest sum its box
    allows; the preservation violation reported is the scenario's."""
    _, tp = fleet16
    stack = tscen.FleetJitter(2, seed=2, usage_sigma=0.6,
                              entitlement_sigma=0.0).generate(tp)
    res = tens.evaluate_ensemble(tp, tapi.CR1(), stack, ctx=tapi.SolveContext(
        device="cpu", use_kernel=use_kernel, steps=60))
    over = 0
    for s in range(stack.S):
        q = stack.problem(tp, s)
        over += int((np.asarray(q.usage) > 1.5 * np.asarray(
            q.entitlement)[:, None])[np.asarray(q.is_batch)].sum())
        gap, n_days = _day_sum_gap(q, res.D[s])
        assert n_days > 0
        assert gap < 1e-3
        lo, hi = _bounds(device_view(q, torch.device("cpu")))
        assert bool((lo <= hi).all())
    assert over > 0
    assert res.preservation_violation.max() > 1.0


def test_batched_flag_and_fallback(fleet16):
    _, tp = fleet16
    st = tapi.solve(tp, tapi.CR1(), ctx=tapi.SolveContext(device="cpu",
                                                         steps=8)).state
    ctx = tapi.SolveContext(device="cpu", steps=8, warm=st)
    res = tens.evaluate_ensemble(tp, tapi.CR1(), tscen.DuckPerturb(2), ctx=ctx)
    assert not res.batched
    with pytest.raises(ValueError, match="no batched ensemble lane"):
        tens.evaluate_ensemble(tp, tapi.CR1(), tscen.DuckPerturb(2), ctx=ctx,
                               batched=True)


def test_report_and_table_match_reference(fleet16):
    """`EnsembleReport` and `comparison_table` of the port against the
    reference's, built from the same plans and penalties."""
    p, tp = fleet16
    jstack = jscen.resolve_scenarios(
        [jscen.DuckPerturb(3, seed=0), jscen.FleetJitter(3, seed=2)], p)
    tstack = tscen.resolve_scenarios(
        [tscen.DuckPerturb(3, seed=0), tscen.FleetJitter(3, seed=2)], tp)
    rng = np.random.default_rng(0)
    D = rng.normal(0.0, 0.2, (6, 16, 48))
    pens = np.abs(rng.normal(0.05, 0.05, (6, 16)))
    pens[1, 3] = 0.0
    reps = {}
    for name, pol in (("a", "cr1"), ("b", "cr2")):
        want = jens._result_from_stacks(p, jstack, japi.resolve_policy(pol),
                                        D, pens, True)
        got = tens._result_from_stacks(tp, tstack,
                                       tapi.resolve_policy(pol), D, pens,
                                       True)
        np.testing.assert_allclose(got.carbon_reduction_pct,
                                   want.carbon_reduction_pct, rtol=1e-12)
        np.testing.assert_allclose(got.preservation_violation,
                                   want.preservation_violation, rtol=1e-12)
        for kw in ({}, dict(slo_frac=0.02, cvar_alpha=0.5,
                            quantiles=(10, 90))):
            w, g = want.report(**kw).as_dict(), got.report(**kw).as_dict()
            assert g.keys() == w.keys()
            for k in w:
                if isinstance(w[k], (str, tuple, list)):
                    assert g[k] == w[k], k
                elif isinstance(w[k], dict):
                    assert g[k].keys() == w[k].keys()
                    np.testing.assert_allclose(list(g[k].values()),
                                               list(w[k].values()),
                                               rtol=1e-12)
                else:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-12)
        assert got.report().lines() == want.report().lines()
        reps[name] = (got.report(), want.report())
    assert (tens.comparison_table({k: v[0] for k, v in reps.items()})
            == jens.comparison_table({k: v[1] for k, v in reps.items()}))


def test_compare_policies_keys(fleet16):
    _, tp = fleet16
    reps = tens.compare_policies(
        tp, [tapi.CR1(lam=1.2), tapi.CR1(lam=2.0), "cr2"],
        tscen.DuckPerturb(2), ctx=tapi.SolveContext(device="cpu", steps=16))
    assert list(reps) == ["cr1", "cr1#1", "cr2"]
    assert len(tens.comparison_table(reps)) == 5


@pytest.fixture(scope="module")
def streaming(fleet16):
    """S = 3 forecast regimes, 3 ticks of CR1 (cold 80, warm 20): the
    JAX package's streaming ensemble (generic), the port's (generic and
    fused), and the port's solo controllers for two of the streams."""
    p, tp = fleet16
    kw = dict(n_ticks=3, cold_steps=80, warm_steps=20)
    want = jens.run_streaming_ensemble(p, "cr1", jscen.ForecastRegime(3),
                                       use_kernel=False, **kw)
    got = {uk: tens.run_streaming_ensemble(
        tp, "cr1", tscen.ForecastRegime(3), use_kernel=uk, device="cpu",
        **kw) for uk in (False, True)}
    streams = tscen.ForecastRegime(3).streams(tp, n_ticks=3)
    solo = {uk: [RollingHorizonSolver(tp, streams[s], policy="cr1",
                                      cold_steps=80, warm_steps=20,
                                      use_kernel=uk, device="cpu").run(3)
                 for s in (0, 2)] for uk in (False, True)}
    return want, got, solo


@pytest.mark.parametrize("use_kernel", [False, True])
def test_streaming_ensemble_matches_reference_and_solo(streaming,
                                                       use_kernel):
    want, got, solo = streaming
    got, solo = got[use_kernel], solo[use_kernel]
    assert got.batched and got.labels == want.labels
    assert got.committed.shape == (3, 16, 3)
    assert got.total_inner_steps == want.total_inner_steps == 80 + 2 * 20
    assert np.abs(got.realized_reduction_pct
                  - want.realized_reduction_pct).max() < LANE_PP
    np.testing.assert_allclose(got.committed, want.committed, atol=5e-3)
    np.testing.assert_allclose(got.realized_baseline, want.realized_baseline,
                               rtol=1e-9)
    for s, rep in zip((0, 2), solo):
        assert abs(got.realized_reduction_pct[s]
                   - rep.realized_reduction_pct) < LANE_PP
        np.testing.assert_allclose(got.committed[s], rep.committed,
                                   atol=5e-3)
    risk = got.risk()
    assert risk["p50"] == pytest.approx(
        float(np.percentile(got.realized_reduction_pct, 50)))


def test_streaming_ensemble_cr2_and_validation(fleet16):
    _, tp = fleet16
    streams = [ForecastStream.caiso(n_ticks=2, horizon=48, seed=s)
               for s in (1, 2)]
    rep = tens.run_streaming_ensemble(tp, tapi.CR2(outer=2), streams,
                                      n_ticks=2, cold_steps=16, warm_steps=8,
                                      device="cpu")
    assert rep.n_ticks == 2 and rep.total_inner_steps == 2 * (16 + 8)
    with pytest.raises(ValueError, match="horizon"):
        tens.run_streaming_ensemble(tp, "cr1", [ForecastStream.caiso(
            n_ticks=2, horizon=24)], device="cpu")
    with pytest.raises(ValueError, match="n_ticks"):
        tens.run_streaming_ensemble(tp, "cr1", streams, n_ticks=9,
                                    device="cpu")
    with pytest.raises(ValueError, match=">= 1 stream"):
        tens.run_streaming_ensemble(tp, "cr1", [], device="cpu")


# A mesh that is not a `DeviceMesh` (sharded ensembles are
# `test_torch_sharding_lanes.py`'s).
REFUSALS = {
    "mesh": (TypeError, "DeviceMesh", lambda tp: tens.evaluate_ensemble(
        tp, "cr1", "duck_perturb", ctx=tapi.SolveContext(
            device="cpu", mesh=object()))),
}


def _stream_groups(mod, prob, **kw):
    """Groups of two streams for a single-region fleet."""
    stream = (JStream if mod is jens else ForecastStream).caiso(n_ticks=2)
    return mod.run_streaming_ensemble(prob, "cr1", [(stream,) * 2], **kw)


def _divergence(mod, prob, ctx):
    scen = jscen if mod is jens else tscen
    return mod.evaluate_ensemble(prob, "cr1", scen.RegionalDivergence(2),
                                 ctx=ctx)


# Inputs both packages refuse with the same exception: a group of streams
# that is not one per region, and regional divergence over one region.
RAISES = {
    "stream_groups": (ValueError, "per region", lambda tp, p: (
        lambda: _stream_groups(tens, tp, device="cpu"),
        lambda: _stream_groups(jens, p))),
    "regional_divergence": (ValueError, "multi-region base", lambda tp, p: (
        lambda: _divergence(tens, tp, tapi.SolveContext(device="cpu")),
        lambda: _divergence(jens, p, None))),
}


def _two_regions(q):
    return dataclasses.replace(q, mci=np.stack([q.mci, 0.7 * q.mci]),
                               region=np.arange(q.W) % 2)


def _cr3_ensemble(mod, prob, ctx):
    return mod.ensemble(prob, mod.CR3(outer=1), jscen.DuckPerturb(3)
                        if mod is japi else tscen.DuckPerturb(3), ctx=ctx)


def _b1_streams(mod, prob, **kw):
    stream = (jscen if mod is japi else tscen).ForecastRegime(2, seed=4)
    run = (jens if mod is japi else tens).run_streaming_ensemble
    return run(prob, "b1", stream, n_ticks=2, **kw)


def _b3_compare(mod, prob, ctx):
    run = (jens if mod is japi else tens).compare_policies
    scen = (jscen if mod is japi else tscen).CambiumMix(3, seed=1)
    return run(prob, ["cr1", "b3"], scen, ctx=ctx)


# What the port refused by name until it was ported: CR3 and the
# baselines take the JAX package's sequential fallback (a `solve()` loop,
# or S solo controllers); a multi-region fleet the batched lane. Each is
# held against the JAX package's.
PORTED = {
    "regions": lambda tp, p: (
        tens.evaluate_ensemble(_two_regions(tp), "cr1",
                               tscen.ScenarioStack(labels=("a",)),
                               ctx=tapi.SolveContext(device="cpu", steps=40)),
        jens.evaluate_ensemble(_two_regions(p), "cr1",
                               jscen.ScenarioStack(labels=("a",)),
                               ctx=japi.SolveContext(use_kernel=False,
                                                     steps=40))),
    "cr3": lambda tp, p: (
        _cr3_ensemble(tapi, tp, tapi.SolveContext(device="cpu", steps=20)),
        _cr3_ensemble(japi, p, japi.SolveContext(use_kernel=False,
                                                 steps=20))),
    "b1": lambda tp, p: (_b1_streams(tens, tp, device="cpu"),
                         _b1_streams(japi, p, use_kernel=False)),
    "b3": lambda tp, p: (
        _b3_compare(tapi, tp, tapi.SolveContext(device="cpu", steps=20)),
        _b3_compare(japi, p, japi.SolveContext(use_kernel=False,
                                               steps=20))),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + sorted(RAISES)
                         + sorted(PORTED))
def test_unported_refused_by_name(fleet16, case):
    p, tp = fleet16
    if case in REFUSALS:
        exc, match, call = REFUSALS[case]
        with pytest.raises(exc, match=match):
            call(tp)
        return
    if case in RAISES:
        exc, match, calls = RAISES[case]
        for call in calls(tp, p):
            with pytest.raises(exc, match=match):
                call()
        return
    got, want = PORTED[case](tp, p)
    if case == "regions":
        assert got.batched and want.batched and got.D.shape == (1, 16, 48)
        _close(got, want, PP)
    elif case == "cr3":
        assert not got.batched and got.labels == want.labels
        _close(got, want, PP)
        assert [e["balanced"] for e in got.extras] \
            == [e["balanced"] for e in want.extras]
    elif case == "b1":
        assert not got.batched and got.total_inner_steps == 0
        np.testing.assert_allclose(got.committed, want.committed,
                                   rtol=0, atol=0)
        np.testing.assert_allclose(got.realized_reduction_pct,
                                   want.realized_reduction_pct, rtol=1e-12)
    else:
        assert list(got) == list(want) == ["cr1", "b3"]
        for key in got:
            assert abs(got[key].carbon_mean - want[key].carbon_mean) < PP
            assert abs(got[key].penalty_mean - want[key].penalty_mean) < PP
