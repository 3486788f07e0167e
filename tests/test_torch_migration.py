"""Cross-region migration on the CPU: the port's `core/migration.py`
(the post-stage's plan, its exact repair, the region aggregates) and
`SolveContext.coupled_migration` against the JAX package's, on the draws
of `tests/torch_region_fleets.py`, and the R = 3 CA/TX/NY acceptance of
`tests/test_multiregion.py` on the port.

Tolerances: the repair is float64 numpy in both packages and is held
equal; a plan is float32 projected Adam on a linear objective in both,
its moved total and net saving held within `PLAN_RTOL` of the JAX
package's on the same aggregates; caps hold exactly after the repair,
supply and headroom to float64 rounding.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import migration as jmig
from repro_torch.core import api as tapi
from repro_torch.core import fleet_solver as tfs
from repro_torch.core import migration as tmig
from torch_region_fleets import (STATES, carry, jax_regional_fleet,
                                 paper_templates)

PLAN_RTOL = 1e-6


@pytest.fixture(scope="module")
def templates():
    return paper_templates()


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", **kw)


def _assert_feasible(p, res, plan):
    """Exact link caps, no self-flows, supply and headroom to rounding."""
    y = plan.y
    bw = np.asarray(p.topology.bandwidth)
    assert (y >= 0.0).all() and (y <= bw[:, :, None]).all()
    assert np.abs(np.trace(y.sum(axis=2))) == 0.0
    movable, headroom = tmig.region_aggregates(p, np.asarray(res.D))
    assert (y.sum(axis=1) <= movable * (1 + 1e-9) + 1e-9).all()
    assert (y.sum(axis=0) <= headroom + 1e-9).all()


def test_repair_respects_caps_under_adversarial_rounding():
    """`_repair` projects an over-cap iterate (epsilon overshoots and gross
    violations) onto the exact constraint set, as the JAX package's does
    on the same input."""
    rng = np.random.default_rng(0)
    R, T = 3, 8
    mci = rng.uniform(100.0, 500.0, (R, T))
    cost = rng.uniform(0.0, 50.0, (R, R))
    np.fill_diagonal(cost, 0.0)
    margin = mci[:, None, :] - mci[None, :, :] - cost[:, :, None]
    bw = rng.uniform(0.0, 2.0, (R, R))
    np.fill_diagonal(bw, 0.0)
    cap = np.broadcast_to(bw[:, :, None], (R, R, T)).copy()
    movable = rng.uniform(0.0, 1.5, (R, T))
    headroom = rng.uniform(0.0, 1.0, (R, T))
    y = cap * (1.0 + 1e-7) + rng.uniform(0.0, 1.0, cap.shape)
    out = tmig._repair(y, margin, cap, movable, headroom)
    np.testing.assert_array_equal(
        out, jmig._repair(y, margin, cap, movable, headroom))
    assert (out >= 0.0).all() and (out <= cap).all()
    assert (out[margin <= 0.0] == 0.0).all()
    assert (out.sum(axis=1) <= movable * (1 + 1e-9) + 1e-12).all()
    assert (out.sum(axis=0) <= headroom * (1 + 1e-9) + 1e-12).all()


@pytest.fixture(scope="module")
def fleet9(templates):
    """`synthetic_regional_fleet(9, CA/TX/NY, hours=48, seed=0)` with its
    default topology, JAX and port."""
    p = jax_regional_fleet(templates[0], 9, STATES, hours=48, seed=0)
    return p, carry(p)


def test_plan_migration_matches_jax(fleet9):
    """The port's plan against the JAX package's on the same aggregates,
    with and without region ceilings; the aggregates themselves equal."""
    p, tp = fleet9
    rng = np.random.default_rng(1)
    D = 0.3 * np.asarray(p.usage) * rng.uniform(-0.5, 1.0, p.usage.shape)
    for ceiling in (None, 0.4 * np.asarray(p.usage).sum(0).max()
                    * np.ones(3)):
        top = dataclasses.replace(p.topology, ceiling=ceiling)
        jp = dataclasses.replace(p, topology=top)
        q = dataclasses.replace(tp, topology=carry(jp).topology)
        agg = tmig.region_aggregates(q, D)
        for a, b in zip(agg, jmig.region_aggregates(jp, D)):
            np.testing.assert_array_equal(a, b)
        got = tmig.plan_migration(q.mci, *agg, q.topology, device="cpu")
        want = jmig.plan_migration(np.asarray(p.mci), *agg, top)
        assert want.moved_total > 0.0
        assert got.moved_total == pytest.approx(want.moved_total,
                                                rel=PLAN_RTOL)
        assert got.net_saved == pytest.approx(want.net_saved, rel=PLAN_RTOL)
        assert (got.y <= np.asarray(top.bandwidth)[:, :, None]).all()


def test_migration_plan_is_feasible_and_credited(fleet9):
    """`solve()` with a positive-bandwidth topology leaves D as solved
    without one and credits the net saving; the plan meets every cap, and
    `fleet_migration` gives it again."""
    _, tp = fleet9
    ctx = _ctx(steps=300)
    res = tapi.solve(tp, tapi.CR1(lam=1.45), ctx=ctx)
    off = tapi.solve(dataclasses.replace(tp, topology=None),
                     tapi.CR1(lam=1.45), ctx=ctx)
    np.testing.assert_array_equal(res.D, off.D)
    plan = res.extras["migration"]
    assert isinstance(plan, tmig.MigrationPlan) and plan.net_saved > 0.0
    wmci = np.asarray(tp.mci)[np.asarray(tp.region)]
    base = float((np.asarray(tp.usage) * wmci).sum())
    assert res.carbon_reduction_pct == pytest.approx(
        off.carbon_reduction_pct + 100.0 * plan.net_saved / base)
    _assert_feasible(tp, res, plan)
    again = tmig.fleet_migration(tp, res.D, device="cpu")
    np.testing.assert_array_equal(again.y, plan.y)
    # A sweep's lanes take the same stage.
    lanes = tapi.sweep(tp, [tapi.CR1(lam=1.45), tapi.CR1(lam=1.0)], ctx=ctx)
    assert "migration" in lanes[1].extras
    np.testing.assert_array_equal(lanes[0].D, res.D)
    np.testing.assert_array_equal(lanes[0].extras["migration"].y, plan.y)


def test_zero_bandwidth_topology_yields_zero_plan(templates):
    p = jax_regional_fleet(templates[0], 6, STATES[:2], hours=48, seed=1)
    tp = dataclasses.replace(carry(p), topology=tfs.RegionTopology(
        cost=np.full((2, 2), 2.0), bandwidth=np.zeros((2, 2))))
    res = tapi.solve(tp, tapi.CR1(lam=1.45), ctx=_ctx(steps=150))
    assert "migration" not in res.extras
    plan = tmig.fleet_migration(tp, res.D, device="cpu")
    assert plan.moved_total == 0.0 and plan.net_saved == 0.0


def test_single_region_topology_is_exact_noop(fleet9):
    """A 1-region topology, even with a positive self-bandwidth, has no
    link: post-stage or coupled, the solve is the plain single-region
    one bit for bit."""
    _, tp = fleet9
    rows = np.asarray(tp.region) == 0
    fp = tfs.FleetProblem(**{
        f: np.asarray(getattr(tp, f))[rows] for f in (
            "usage", "entitlement", "k", "rts_coeffs", "betas", "x2_kind",
            "jobs", "is_batch")}, mci=np.asarray(tp.mci)[0])
    pr = tfs.regional_fleet([fp], np.asarray(fp.mci)[None])
    pt = dataclasses.replace(pr, topology=tfs.RegionTopology(
        cost=np.zeros((1, 1)), bandwidth=np.ones((1, 1))))
    ctx = _ctx(steps=120)
    a = tapi.solve(pr, tapi.CR1(lam=1.45), ctx=ctx)
    b = tapi.solve(pt, tapi.CR1(lam=1.45), ctx=ctx)
    c = tapi.solve(pt, tapi.CR1(lam=1.45),
                   ctx=dataclasses.replace(ctx, coupled_migration=True))
    for r in (b, c):
        np.testing.assert_array_equal(a.D, r.D)
        assert a.carbon_reduction_pct == r.carbon_reduction_pct
        assert "migration" not in r.extras
    assert tmig.fleet_migration(pt, b.D, device="cpu").moved_total == 0.0


def test_toll_dominated_links_are_never_used(templates):
    """A toll at or above the largest carbon spread makes no link
    profitable: nothing moves, post-stage or coupled."""
    p = jax_regional_fleet(templates[0], 6, STATES[:2], hours=48, seed=1)
    mci = np.asarray(p.mci, float)
    spread = float(np.abs(mci[0] - mci[1]).max())
    top = tfs.RegionTopology(cost=np.full((2, 2), spread),
                             bandwidth=np.full((2, 2), 1e3))
    tp = dataclasses.replace(carry(p), topology=top)
    plan = tmig.plan_migration(mci, np.ones((2, tp.T)),
                               np.full((2, tp.T), np.inf), top, device="cpu")
    assert plan.moved_total == 0.0 and plan.net_saved == 0.0
    ctx = _ctx(steps=120)
    res = tapi.solve(tp, tapi.CR1(lam=1.45), ctx=ctx)
    off = tapi.solve(dataclasses.replace(tp, topology=None),
                     tapi.CR1(lam=1.45), ctx=ctx)
    assert res.extras["migration"].moved_total == 0.0
    assert res.carbon_reduction_pct == off.carbon_reduction_pct
    coup = tapi.solve(tp, tapi.CR1(lam=1.45),
                      ctx=dataclasses.replace(ctx, coupled_migration=True))
    assert coup.extras["migration"].moved_total == 0.0
    assert coup.carbon_reduction_pct >= res.carbon_reduction_pct


def test_coupled_migration_matches_or_beats_post_stage(templates):
    """`coupled_migration` on the R = 3 fleet of 60 rows never loses to the
    post-stage at equal total curtailment (2e-3 relative), for CR1 and
    CR2, and its plan meets every cap; for CR1 here the coupled candidate
    wins."""
    p = jax_regional_fleet(templates[0], 60, STATES, hours=48, seed=7)
    tp = carry(p)
    ctx = _ctx(steps=300)
    cctx = dataclasses.replace(ctx, coupled_migration=True)
    for pol in (tapi.CR1(lam=1.45), tapi.CR2(cap_frac=0.8, outer=2)):
        post = tapi.solve(tp, pol, ctx=ctx)
        coup = tapi.solve(tp, pol, ctx=cctx)
        assert coup.carbon_reduction_pct >= post.carbon_reduction_pct
        tot_post, tot_coup = float(post.D.sum()), float(coup.D.sum())
        assert abs(tot_coup - tot_post) <= 2e-3 * max(abs(tot_post), 1.0)
        if coup.extras.get("coupled_migration"):
            _assert_feasible(tp, coup, coup.extras["migration"])
        if pol.name == "cr1":
            assert coup.extras.get("coupled_migration") is True
            assert coup.carbon_reduction_pct > post.carbon_reduction_pct


def test_coupled_migration_zero_bandwidth_is_pure_solve(templates):
    """Zero bandwidth leaves the coupled solve no link: it is the plain
    solve bit for bit, with no migration."""
    p = jax_regional_fleet(templates[0], 6, STATES[:2], hours=48, seed=1)
    tp = dataclasses.replace(carry(p), topology=tfs.RegionTopology(
        cost=np.full((2, 2), 2.0), bandwidth=np.zeros((2, 2))))
    ctx = _ctx(steps=120)
    plain = tapi.solve(tp, tapi.CR1(lam=1.45), ctx=ctx)
    coup = tapi.solve(tp, tapi.CR1(lam=1.45),
                      ctx=dataclasses.replace(ctx, coupled_migration=True))
    np.testing.assert_array_equal(plain.D, coup.D)
    assert plain.carbon_reduction_pct == coup.carbon_reduction_pct
    assert "migration" not in coup.extras


def test_r3_regional_beats_best_single_signal_solve(templates):
    """The acceptance of the JAX package's `tests/test_multiregion.py`
    on the port: pricing each region of the R = 3 CA/TX/NY fleet (UTC
    clock) on its own trace, plus migration, saves more than 1 % of
    fleet carbon by migration and beats pricing the whole fleet on any
    single region's trace by more than 0.5 pp at equal total curtailment
    (each single-signal plan scaled down to the multi solve's
    curtailment, which keeps it feasible)."""
    base = carry(jax_regional_fleet(templates[0], 9, STATES, hours=48,
                                    seed=0, utc_offsets="auto"))
    ent = float(np.asarray(base.entitlement).sum())
    bw = np.full((3, 3), 0.15 * ent / 2)
    np.fill_diagonal(bw, 0.0)
    p = dataclasses.replace(base, topology=tfs.RegionTopology(
        cost=np.full((3, 3), 1.0), bandwidth=bw))
    wmci = np.asarray(p.mci)[np.asarray(p.region)]
    carbon = float((np.asarray(p.usage) * wmci).sum())
    ctx = _ctx(steps=400)
    multi = tapi.solve(p, tapi.CR1(lam=1.45), ctx=ctx)
    curtail = float(multi.D.sum())
    assert 100.0 * multi.extras["migration"].net_saved / carbon > 1.0
    best = -np.inf
    for r in range(p.R):
        single = dataclasses.replace(p, mci=np.asarray(p.mci)[r],
                                     region=None, topology=None)
        rs = tapi.solve(single, tapi.CR1(lam=1.45), ctx=ctx)
        assert float(rs.D.sum()) >= curtail
        realized = 100.0 * float((rs.D * wmci).sum()) / carbon
        best = max(best, realized * curtail / float(rs.D.sum()))
    assert multi.carbon_reduction_pct > best + 0.5
