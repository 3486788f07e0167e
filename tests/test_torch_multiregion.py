"""Multi-region fleets on the CPU: the port's `RegionTopology`,
`regional_fleet`, per-region reductions and CR1/CR2/CR3 solves and
sweeps against the JAX package's, on the draws of
`tests/torch_region_fleets.py` (the JAX side on its generic engine).

Tolerances: plans are compared at solution level, carbon % and penalty %
within 0.05 pp (`PP`, the JAX package's fused-vs-generic bound; the
hinge subgradient makes iterates chaotic under ulp-level changes), the
port's fused path against its generic engine likewise, and a sweep's
lanes within 0.01 pp of their `solve()` loop (`LANE_PP`, the JAX
package's sweep contract). Reductions are held to 1e-6 relative of the
JAX package's (`RTOL`: float32 sums in another order). R = 1 is
canonicalized to the single-region path and held bit for bit. CR3's
per-region clearing is in `tests/test_torch_multiregion_cr3.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import fleet_solver as jfs
from repro.core import regional as jreg
from repro_torch.core import api as tapi
from repro_torch.core import fleet_solver as tfs
from repro_torch.core import regional as treg
from torch_region_fleets import (STATES, carry, jax_regional_fleet,
                                 paper_templates)

PP = 0.05
LANE_PP = 0.01
RTOL = 1e-6


@pytest.fixture(scope="module")
def templates():
    return paper_templates()


@pytest.fixture(scope="module")
def fleets(templates):
    """R = 2 (CA, TX) and R = 3 (CA, TX, NY) fleets of 12 rows on the UTC
    clock, without a topology (the solves alone), JAX and port."""
    out = {}
    for R in (2, 3):
        p = jax_regional_fleet(templates[0], 12, STATES[:R], seed=R,
                               utc_offsets="auto", topology=None)
        out[R] = p, carry(p)
    return out


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", **kw)


def _gaps(a, b):
    return (abs(a.carbon_reduction_pct - b.carbon_reduction_pct),
            abs(a.total_penalty_pct - b.total_penalty_pct))


# ---------------------------------------------------------------------------
# The data model
# ---------------------------------------------------------------------------
def test_region_topology_validates_shapes():
    for mod in (jfs, tfs):
        with pytest.raises(ValueError, match="cost/bandwidth"):
            mod.RegionTopology(cost=np.zeros((2, 2)),
                               bandwidth=np.zeros((3, 3))).validate(2, 24)
        with pytest.raises(ValueError, match="ceiling"):
            mod.RegionTopology(cost=np.zeros((2, 2)),
                               bandwidth=np.zeros((2, 2)),
                               ceiling=np.zeros(3)).validate(2, 24)
        with pytest.raises(ValueError, match="labels"):
            mod.RegionTopology(cost=np.zeros((2, 2)),
                               bandwidth=np.zeros((2, 2)),
                               labels=("a",)).validate(2, 24)
        mod.RegionTopology(cost=np.zeros((2, 2)), bandwidth=np.zeros((2, 2)),
                           ceiling=np.zeros((2, 24))).validate(2, 24)
        assert mod.RegionTopology(cost=np.zeros((3, 3)),
                                  bandwidth=np.zeros((3, 3))).R == 3


def _assert_same_problem(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "topology":
            assert (a is None) == (b is None)
            if b is not None:
                for g in ("cost", "bandwidth", "ceiling"):
                    np.testing.assert_array_equal(getattr(a, g),
                                                  getattr(b, g))
                assert a.labels == b.labels
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_regional_fleet_composes_as_jax(templates, fleets):
    """The port's `regional_fleet` of the carried per-region fleets is the
    JAX package's field for field: region-sorted rows, ids, `label/name`
    names, `upper` filled with +inf where one part lacks it; and it
    refuses what the JAX package refuses."""
    jt = templates[0]
    parts = [jfs.synthetic_fleet(3, seed=0, templates=jt),
             jfs.synthetic_fleet(4, seed=1, templates=jt)]
    parts[1] = dataclasses.replace(parts[1], upper=0.3 * parts[1].usage)
    mcis = np.asarray(fleets[2][0].mci)
    top = jfs.RegionTopology(cost=np.ones((2, 2)), bandwidth=np.eye(2)[::-1],
                             labels=("CA", "TX"))
    want = jfs.regional_fleet(parts, mcis, topology=top)
    got = tfs.regional_fleet([carry(f) for f in parts], mcis,
                             topology=carry(want).topology)
    _assert_same_problem(got, want)
    assert got.R == 2 and got.is_multiregion
    np.testing.assert_array_equal(got.region, [0, 0, 0, 1, 1, 1, 1])
    assert got.names[0] == "CA/RTS1-0" and np.isinf(got.upper[:3]).all()
    with pytest.raises(ValueError, match="one trace per fleet"):
        tfs.regional_fleet([carry(f) for f in parts], mcis[0])
    with pytest.raises(ValueError, match="single-region"):
        tfs.regional_fleet([got], mcis[:1])


def test_synthetic_regional_fleet_is_the_reference_draw(templates):
    """The port's own `synthetic_regional_fleet` (the draw chip_smoke.py
    takes) is the JAX package's on the same templates, default topology
    included."""
    want = jax_regional_fleet(templates[0], 10, seed=4, utc_offsets="auto")
    got = tfs.synthetic_regional_fleet(10, list(STATES), hours=48, seed=4,
                                       utc_offsets="auto",
                                       templates=templates[1])
    _assert_same_problem(got, want)
    assert [int((got.region == r).sum()) for r in range(3)] == [4, 3, 3]


def test_single_region_view_canonicalizes(fleets):
    _, tp = fleets[2]
    one = dataclasses.replace(tp, mci=np.asarray(tp.mci)[:1],
                              region=np.zeros(tp.W, np.int32),
                              topology=tfs.RegionTopology(
                                  cost=np.zeros((1, 1)),
                                  bandwidth=np.ones((1, 1))))
    view = tfs.single_region_view(one)
    assert not view.is_multiregion and view.R == 1
    assert view.region is None and view.topology is None
    np.testing.assert_array_equal(view.mci, np.asarray(tp.mci)[0])
    assert tfs.single_region_view(tp) is tp
    stray = dataclasses.replace(view, region=np.zeros(tp.W, np.int32))
    assert tfs.single_region_view(stray).region is None


# ---------------------------------------------------------------------------
# The per-region reductions
# ---------------------------------------------------------------------------
def test_region_reductions_match_jax(fleets):
    """`region_totals` equals the JAX package's; the multi-region CR1/CR2
    normalizers and CR3's regularizer scale are within `RTOL` of its."""
    for R, (p, tp) in fleets.items():
        region = np.asarray(p.region)
        usage = np.asarray(p.usage)
        m = np.asarray(p.is_batch, bool)
        for args in ((region, usage[:, 0]), (region, usage),
                     (region[m], usage[m])):
            np.testing.assert_array_equal(
                treg.region_totals(*args, R), jreg.region_totals(*args, R))
        view = tfs.device_view(tp, torch.device("cpu"))
        refs = np.array(jfs.cr2_reference_fleet(p, 0.78), np.float32)
        pairs = list(zip(treg.cr1_norms(view), jreg.cr1_norms(p)))
        pairs += list(zip(treg.cr2_norms(view, torch.as_tensor(refs)),
                          jreg.cr2_norms(p, refs)))
        pairs.append((treg.cr3_reg_scale(view), jreg.cr3_reg_scale(p)))
        for got, want in pairs:
            assert tuple(got.shape) == tuple(np.shape(want))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL)


def test_region_sums_repeat_and_match_standalone_sums(fleets):
    """The segment sums are the same bit for bit call after call, and a
    region's `region_sum` is the sum its own rows take alone."""
    _, tp = fleets[3]
    view = tfs.device_view(tp, torch.device("cpu"))
    x = view.usage.sum(1)
    a, b = (treg.region_sum(x, view.region, view.region_index)
            for _ in range(2))
    assert torch.equal(a, b)
    for r in range(3):
        rows = view.region == r
        assert torch.equal(a[rows], x[rows].sum().expand(int(rows.sum())))
    s1, s2 = (treg.segment_sum(view.usage, view.region, 3) for _ in range(2))
    assert torch.equal(s1, s2) and s1.shape == (3, tp.T)
    np.testing.assert_allclose(s1.numpy(), treg.region_totals(
        tp.region, tp.usage, 3), rtol=RTOL)


# ---------------------------------------------------------------------------
# R = 1 is the single-region path, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", [
    tapi.CR1(lam=1.45), tapi.CR2(cap_frac=0.8, outer=2),
    tapi.CR3(outer=2, clearing_iters=2)], ids=["cr1", "cr2", "cr3"])
def test_r1_regional_solve_is_bitwise_single_region(fleets, policy):
    _, tp = fleets[2]
    fp = dataclasses.replace(tp, mci=np.asarray(tp.mci)[0], region=None)
    pr = tfs.regional_fleet([fp], np.asarray(fp.mci)[None])
    for use_kernel in (False, True):
        ctx = _ctx(steps=60, use_kernel=use_kernel)
        a, b = tapi.solve(fp, policy, ctx=ctx), tapi.solve(pr, policy,
                                                          ctx=ctx)
        np.testing.assert_array_equal(a.D, b.D)
        assert a.carbon_reduction_pct == b.carbon_reduction_pct
        assert a.total_penalty_pct == b.total_penalty_pct
        assert torch.equal(a.state.x, b.state.x)


def test_r1_regional_sweep_is_bitwise_single_region(fleets):
    _, tp = fleets[2]
    fp = dataclasses.replace(tp, mci=np.asarray(tp.mci)[0], region=None)
    pr = tfs.regional_fleet([fp], np.asarray(fp.mci)[None])
    pols = [tapi.CR1(lam=lam) for lam in (1.0, 1.45)]
    ctx = _ctx(steps=60, use_kernel=True)
    for a, b in zip(tapi.sweep(fp, pols, ctx=ctx),
                    tapi.sweep(pr, pols, ctx=ctx)):
        np.testing.assert_array_equal(a.D, b.D)


# ---------------------------------------------------------------------------
# CR1 and CR2 over regions
# ---------------------------------------------------------------------------
POLICIES = {
    "cr1": (japi.CR1(lam=1.45), tapi.CR1(lam=1.45), 300),
    "cr2": (japi.CR2(cap_frac=0.78, outer=3), tapi.CR2(cap_frac=0.78,
                                                       outer=3), 120),
}


@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_multiregion_solve_matches_jax(fleets, policy, R):
    """The port's generic engine against the JAX package's, and the fused
    path (al_step's plain version fed the per-row carbon rows and step
    column) against the port's generic engine."""
    p, tp = fleets[R]
    jpol, tpol, steps = POLICIES[policy]
    want = japi.solve(p, jpol, ctx=japi.SolveContext(use_kernel=False,
                                                     steps=steps))
    gen = tapi.solve(tp, tpol, ctx=_ctx(use_kernel=False, steps=steps))
    fused = tapi.solve(tp, tpol, ctx=_ctx(use_kernel=True, steps=steps))
    assert gen.iters == fused.iters == want.iters
    for got, ref in ((gen, want), (fused, gen)):
        assert got.D.shape == (tp.W, tp.T) and np.isfinite(got.D).all()
        dc, dp = _gaps(got, ref)
        assert dc < PP and dp < PP, (dc, dp)
    assert fused.preservation_violation < 1e-3


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multiregion_sweep_lanes_match_their_loop(fleets, use_kernel):
    """CR1 lam and CR2 cap_frac lanes on the R = 3 fleet, each lane's
    per-row norms and carbon rows its own, against `solve()` per policy."""
    _, tp = fleets[3]
    for pols, steps in (([tapi.CR1(lam=lam) for lam in (1.0, 1.45, 2.2)],
                         200),
                        ([tapi.CR2(cap_frac=c, outer=2)
                          for c in (0.74, 0.82)], 100)):
        ctx = _ctx(use_kernel=use_kernel, steps=steps)
        lanes = tapi.sweep(tp, pols, ctx=ctx)
        for pl, a in zip(pols, lanes):
            b = tapi.solve(tp, pl, ctx=ctx)
            dc, dp = _gaps(a, b)
            assert dc < LANE_PP and dp < LANE_PP, (pl, dc, dp)
            assert a.iters == b.iters


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_zero_bandwidth_decomposes_into_per_region_solves(fleets, policy):
    """With a zero-bandwidth network the R = 2 solve reproduces the two
    standalone single-region solves (atol 1e-4, as the JAX package's
    test), carries no migration, and agrees with the JAX package's joint
    solve within `PP`."""
    p, tp = fleets[2]
    jpol, tpol, steps = POLICIES[policy]
    zero = tfs.RegionTopology(cost=np.full((2, 2), 2.0),
                              bandwidth=np.zeros((2, 2)))
    joint = dataclasses.replace(tp, topology=zero)
    ctx = _ctx(use_kernel=False, steps=steps)
    res = tapi.solve(joint, tpol, ctx=ctx)
    assert "migration" not in res.extras
    for r in range(2):
        rows = np.asarray(tp.region) == r
        alone = tfs.FleetProblem(**{
            f: (getattr(tp, f)[rows] if f in ("usage", "entitlement", "k",
                                               "rts_coeffs", "betas",
                                               "x2_kind", "jobs", "is_batch")
                else getattr(tp, f))
            for f in ("usage", "entitlement", "k", "rts_coeffs", "betas",
                      "x2_kind", "jobs", "is_batch", "day_hours",
                      "max_curtail_frac")}, mci=np.asarray(tp.mci)[r])
        indep = tapi.solve(alone, tpol, ctx=ctx)
        np.testing.assert_allclose(res.D[rows], indep.D, atol=1e-4)
    want = japi.solve(p, jpol, ctx=japi.SolveContext(use_kernel=False,
                                                     steps=steps))
    dc, dp = _gaps(res, want)
    assert dc < PP and dp < PP


def test_baselines_price_each_row_on_its_region(fleets):
    """B1 and B3 plans read no carbon signal; their report prices each
    row on its region's trace, as the JAX package's."""
    p, tp = fleets[3]
    for jpol, tpol in ((japi.B1(), tapi.B1()), (japi.B3(), tapi.B3())):
        want = japi.solve(p, jpol, ctx=japi.SolveContext(use_kernel=False))
        got = tapi.solve(tp, tpol, ctx=_ctx())
        np.testing.assert_array_equal(got.D, np.asarray(want.D))
        assert got.carbon_reduction_pct == pytest.approx(
            want.carbon_reduction_pct, rel=1e-12)
        assert got.total_penalty_pct == pytest.approx(
            want.total_penalty_pct, rel=1e-5)


# ---------------------------------------------------------------------------
# What stays refused around the streaming and batched lanes
# ---------------------------------------------------------------------------
def test_multiregion_streaming_and_lanes_refused_by_name(fleets, tmp_path):
    """The streaming and batched lanes take a multi-region fleet (held
    against the JAX package in `tests/test_torch_multiregion_streaming.py`
    and `tests/test_torch_multiregion_lanes.py`); what stays refused
    around them is refused by name: a mesh that is not a `DeviceMesh`
    (sharded regional days and ensembles are
    `tests/test_torch_sharding_lanes.py`'s).
    The tick ledger, telemetry and recompile guard run on it: per-region
    committed and realized carbon on every tick, with the migration
    credit."""
    from repro_torch.core import ensemble as tens
    from repro_torch.core import scenario as tscen
    from repro_torch.core import streaming as tstream
    from repro_torch.core.carbon import ForecastStream
    _, tp = fleets[2]
    streams = ForecastStream.regional(np.tile(np.asarray(tp.mci), (1, 2)),
                                      horizon=tp.T)
    stack = np.stack([np.asarray(tp.mci)] * 2)
    kw = dict(cold_steps=4, warm_steps=2, device="cpu")
    runs = [
        tapi.solve_day(tp, "cr1", stack, ctx=_ctx(), cold_steps=4).committed,
        tstream.RollingHorizonSolver(tp, streams, **kw).run(2).committed,
        tstream.RollingHorizonSolver(tp, streams, **kw).run_scanned(
            2).committed,
        tens.evaluate_ensemble(tp, "cr1", tscen.RegionalDivergence(2),
                               ctx=_ctx(steps=4)).D,
        tens.run_streaming_ensemble(tp, "cr1", tscen.ForecastRegime(2),
                                    n_ticks=2, **kw).committed]
    for out in runs:
        assert np.isfinite(out).all()
    cold = tapi.sweep(tp, [tapi.CR1(), tapi.CR1(lam=1.0)],
                      ctx=_ctx(steps=4))
    warm = tapi.sweep(tp, [tapi.CR1(), tapi.CR1(lam=1.0)], ctx=_ctx(
        steps=4, warm=tapi.stack_states([r.state for r in cold])))
    assert len(warm) == 2 and not hasattr(tstream, "_ITEM_9B")
    mesh = _ctx(mesh=object())
    for call in (
            lambda: tapi.solve_day(tp, "cr1", stack, ctx=mesh),
            lambda: tens.evaluate_ensemble(tp, "cr1",
                                           tscen.RegionalDivergence(2),
                                           ctx=mesh),
            lambda: tstream.RollingHorizonSolver(tp, streams, mesh=object(),
                                                 device="cpu")):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    from repro_torch.obs import TelemetryConfig, read_events
    path = tmp_path / "regions.jsonl"
    ledger = tstream.RollingHorizonSolver(
        tp, streams, events=str(path), guard_recompiles=True,
        telemetry=TelemetryConfig(every=2), **kw)
    ledger.run(2)
    ledger.run_scanned(2)
    recs = read_events(path)
    ticks = [r for r in recs if r["kind"] == "tick"]
    assert [t["tick"] for t in ticks] == [0, 1, 2, 3]
    for t in ticks:
        assert len(t["committed_carbon"]) == len(t["realized_carbon"]) == 2
        assert t["migration_credit"] == 0.0   # hour 0 commits, no stage
        assert np.isfinite(t["committed_carbon"]).all()
    assert {r["tick"] for r in recs if r["kind"] == "telemetry"} == \
        {0, 1, 2, 3}
