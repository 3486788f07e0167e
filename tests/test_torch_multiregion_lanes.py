"""Multi-region fleets in the batched lanes, on the CPU: `RegionalDivergence`
and the per-region streams of `ForecastRegime`, `evaluate_ensemble` (with
each scenario's migration post-stage in both lanes), `run_streaming_ensemble`
over groups of one stream per region, and the warm refinement sweep from
`stack_states`, against the JAX package's on the draws of
`tests/torch_region_fleets.py` (the JAX side on its generic engine) and
against the port's own loop lane.

Tolerances: the batched lane within 0.01 pp of the port's loop lane
(`LANE_PP`, the JAX package's batched-vs-loop contract), a streaming
ensemble's scenario within 0.01 pp of its solo controller and its
committed hours within 5e-3 NP (`COMMIT_ATOL`); the port within 0.05 pp
of the JAX package (`PP`, its fused-vs-generic bound: the hinge
subgradient makes iterates chaotic under ulp-level changes). Scenario
stacks and streams are numpy code and held exactly; the refinement's
lanes are held bit for bit against each lane's warm `solve()`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import ensemble as jens
from repro.core import scenario as jscen
from repro.core import streaming as jstream
from repro_torch.core import api as tapi
from repro_torch.core import ensemble as tens
from repro_torch.core import scenario as tscen
from repro_torch.core import streaming as tstream
from torch_region_fleets import (STATES, carry, jax_regional_fleet,
                                 paper_templates)

PP = 0.05
LANE_PP = 0.01
COMMIT_ATOL = 5e-3
STEPS = 120


@pytest.fixture(scope="module")
def fleets():
    """R = 3 (CA, TX, NY), 12 rows on the UTC clock, with the default
    topology and without one; R = 2 (CA, TX), 10 rows, without one. JAX
    and port."""
    templates = paper_templates()[0]
    p3 = jax_regional_fleet(templates, 12, STATES, seed=3,
                            utc_offsets="auto")
    p2 = jax_regional_fleet(templates, 10, STATES[:2], seed=1,
                            utc_offsets="auto", topology=None)
    bare = dataclasses.replace(p3, topology=None)
    return {"topology": (p3, carry(p3)), "bare": (bare, carry(bare)),
            "r2": (p2, carry(p2))}


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", **kw)


def _jctx(**kw):
    return japi.SolveContext(use_kernel=False, **kw)


# ---------------------------------------------------------------------------
# Scenarios over regions
# ---------------------------------------------------------------------------
def test_regional_divergence_matches_reference(fleets):
    p, tp = fleets["topology"]
    for gen in ({}, dict(n_scenarios=5, seed=3, level_sigma=0.3,
                         trough_sigma=0.6)):
        want = jscen.RegionalDivergence(**gen).generate(p)
        got = tscen.RegionalDivergence(**gen).generate(tp)
        assert got.mci.shape == (want.S, 3, 48)
        np.testing.assert_array_equal(got.mci, want.mci)
        assert got.labels == want.labels
        assert set(got.overlay_fields()) == {"mci"}


def test_forecast_regime_over_regions_matches_reference(fleets):
    """S groups of R streams, seeds `sd + r`; `generate` stacks each
    group's tick-0 forecasts into (S, R, T)."""
    p, tp = fleets["topology"]
    want = jscen.ForecastRegime(3, seed=2).streams(p, n_ticks=5)
    got = tscen.ForecastRegime(3, seed=2).streams(tp, n_ticks=5)
    assert len(got) == 3 and all(len(g) == 3 for g in got)
    for gg, wg in zip(got, want):
        for g, w in zip(gg, wg):
            assert (g.seed, g.revision_sigma) == (w.seed, w.revision_sigma)
            for t in range(5):
                np.testing.assert_array_equal(g.forecast(t), w.forecast(t))
                assert g.realized(t) == w.realized(t)
    gs = tscen.ForecastRegime(3, seed=2).generate(tp)
    ws = jscen.ForecastRegime(3, seed=2).generate(p)
    np.testing.assert_array_equal(gs.mci, ws.mci)
    assert gs.mci.shape == (3, 3, 48) and gs.labels == ws.labels


# ---------------------------------------------------------------------------
# evaluate_ensemble over regions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fleet", ["bare", "topology"])
@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_ensemble_matches_loop_and_reference(fleets, policy, fleet):
    """CR1/CR2 over `RegionalDivergence(3)`: the batched lane against the
    port's loop lane and against the JAX package's batched lane. With the
    default topology each scenario's migration post-stage is credited in
    both lanes."""
    p, tp = fleets[fleet]
    jpol = japi.configured_policy(policy, outer=2)
    tpol = tapi.configured_policy(policy, outer=2)
    gen = dict(n_scenarios=3, seed=0)
    got = tens.evaluate_ensemble(tp, tpol, tscen.RegionalDivergence(**gen),
                                 ctx=_ctx(steps=STEPS))
    loop = tens.evaluate_ensemble(tp, tpol, tscen.RegionalDivergence(**gen),
                                  ctx=_ctx(steps=STEPS), batched=False)
    want = jens.evaluate_ensemble(p, jpol, jscen.RegionalDivergence(**gen),
                                  ctx=_jctx(steps=STEPS))
    assert got.batched and not loop.batched and want.batched
    assert got.D.shape == (3, 12, 48) and np.isfinite(got.D).all()
    for ref, tol in ((loop, LANE_PP), (want, PP)):
        assert np.abs(got.carbon_reduction_pct
                      - ref.carbon_reduction_pct).max() < tol
        assert np.abs(got.total_penalty_pct
                      - ref.total_penalty_pct).max() < tol
    assert got.labels == loop.labels == want.labels
    assert (got.preservation_violation < 1e-3).all()
    credited = [["migration" in e for e in r.extras]
                for r in (got, loop, want)]
    assert credited == [[fleet == "topology"] * 3] * 3
    if fleet == "topology":
        for g, w in zip(got.extras, loop.extras):
            assert g["migration"].net_saved == pytest.approx(
                w["migration"].net_saved, rel=1e-3)
            assert g["migration"].net_saved > 0.0


def test_compare_policies_over_regions(fleets):
    """`compare_policies` on a multi-region stack: CR1 takes the batched
    lane, B3 the loop lane, as in the JAX package."""
    p, tp = fleets["topology"]
    scen = dict(n_scenarios=2, seed=5)
    got = tens.compare_policies(tp, ["cr1", "b3"],
                                tscen.RegionalDivergence(**scen),
                                ctx=_ctx(steps=STEPS))
    want = jens.compare_policies(p, ["cr1", "b3"],
                                 jscen.RegionalDivergence(**scen),
                                 ctx=_jctx(steps=STEPS))
    assert list(got) == list(want) == ["cr1", "b3"]
    for key in got:
        assert abs(got[key].carbon_mean - want[key].carbon_mean) < PP
        assert abs(got[key].penalty_mean - want[key].penalty_mean) < PP


def test_coupled_migration_takes_the_loop_lane(fleets):
    _, tp = fleets["topology"]
    ctx = _ctx(steps=8, coupled_migration=True)
    res = tens.evaluate_ensemble(tp, "cr1", tscen.RegionalDivergence(2),
                                 ctx=ctx)
    assert not res.batched
    with pytest.raises(ValueError, match="coupled_migration"):
        tens.evaluate_ensemble(tp, "cr1", tscen.RegionalDivergence(2),
                               ctx=ctx, batched=True)


# ---------------------------------------------------------------------------
# run_streaming_ensemble over groups of one stream per region
# ---------------------------------------------------------------------------
KW = dict(cold_steps=STEPS, warm_steps=40)


def test_streaming_ensemble_matches_solo_and_reference(fleets):
    p, tp = fleets["topology"]
    regime = dict(n_scenarios=2, seed=0, sigma=(0.02, 0.05))
    groups = tscen.ForecastRegime(**regime).streams(tp, n_ticks=3)
    got = tens.run_streaming_ensemble(tp, tapi.CR1(), groups, n_ticks=3,
                                      device="cpu", **KW)
    want = jens.run_streaming_ensemble(p, japi.CR1(),
                                       jscen.ForecastRegime(**regime),
                                       n_ticks=3, use_kernel=False, **KW)
    assert got.batched and got.committed.shape == (2, 12, 3)
    assert got.total_inner_steps == STEPS + 2 * 40
    np.testing.assert_allclose(got.realized_baseline,
                               want.realized_baseline, rtol=1e-6)
    assert np.abs(got.realized_reduction_pct
                  - want.realized_reduction_pct).max() < PP
    for s, g in enumerate(groups):
        solo = tstream.RollingHorizonSolver(tp, g, policy=tapi.CR1(),
                                            device="cpu", **KW).run(3)
        assert abs(got.realized_reduction_pct[s]
                   - solo.realized_reduction_pct) < LANE_PP
        np.testing.assert_allclose(got.committed[s], solo.committed,
                                   atol=COMMIT_ATOL)
        assert got.realized_baseline[s] == pytest.approx(
            solo.realized_baseline, rel=1e-12)
        assert got.forecast_carbon[s] == pytest.approx(
            solo.forecast_carbon, rel=1e-5)


def test_streaming_ensemble_fallback_over_regions(fleets):
    """A policy without a batched lane runs S solo controllers, each with
    its group of streams, as in the JAX package."""
    p, tp = fleets["topology"]
    run = dict(n_ticks=2, **KW)
    got = tens.run_streaming_ensemble(tp, "b1", tscen.ForecastRegime(2),
                                      device="cpu", **run)
    want = jens.run_streaming_ensemble(p, "b1", jscen.ForecastRegime(2),
                                       use_kernel=False, **run)
    assert not got.batched and got.total_inner_steps == 0
    np.testing.assert_allclose(got.committed, want.committed, rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(got.realized_reduction_pct,
                               want.realized_reduction_pct, rtol=1e-5)


def test_streaming_ensemble_groups_per_region(fleets):
    """A group of the wrong size raises in both packages."""
    p, tp = fleets["topology"]
    for mod, scen, prob, kw in ((tens, tscen, tp, dict(device="cpu")),
                                (jens, jscen, p, {})):
        full = scen.ForecastRegime(1).streams(prob, n_ticks=2)
        with pytest.raises(ValueError, match="per region"):
            mod.run_streaming_ensemble(prob, "cr1", [g[:1] for g in full],
                                       n_ticks=2, **kw)
        with pytest.raises(ValueError, match="per region"):
            mod.run_streaming_ensemble(prob, "cr1", [g[0] for g in full],
                                       n_ticks=2, **kw)


# ---------------------------------------------------------------------------
# The warm refinement sweep from stack_states
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_refinement_sweep_over_regions(fleets, policy):
    """At R = 2 with no topology (`tests/test_multiregion.py`'s case):
    `stack_states` round-trips bit for bit and the warm refinement sweep
    takes the batched lane, each lane equal to its warm `solve()` bit for
    bit."""
    _, tp = fleets["r2"]
    pols = ([tapi.CR1(lam=1.0), tapi.CR1(lam=1.45)] if policy == "cr1"
            else [tapi.CR2(cap_frac=c, outer=2) for c in (0.74, 0.82)])
    cold = tapi.sweep(tp, pols, ctx=_ctx(steps=60))
    st = tapi.stack_states([r.state for r in cold])
    for i, r in enumerate(cold):
        for name in ("x", "lam_eq", "lam_in", "mu"):
            assert torch.equal(getattr(st, name)[i], getattr(r.state, name))
    warm = tapi.sweep(tp, pols, ctx=_ctx(steps=20, warm=st))
    for pl, w, c in zip(pols, warm, cold):
        solo = tapi.solve(tp, pl, ctx=_ctx(steps=20, warm=c.state))
        np.testing.assert_array_equal(w.D, solo.D)
        assert w.carbon_reduction_pct == solo.carbon_reduction_pct
        assert w.total_penalty_pct == solo.total_penalty_pct
