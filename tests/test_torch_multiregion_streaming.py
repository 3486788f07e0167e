"""Multi-region fleets in the streaming controller and the day, on the CPU:
the port's capture-safe per-region sums, `RollingHorizonSolver` with a
stream per region, `run_scanned` and `solve_day` over (n_ticks, R, T)
forecast stacks, against the JAX package's on the R = 3 draw of
`tests/torch_region_fleets.py` (the JAX side on its generic engine).

Tolerances: the port's `run()` and `solve_day` against the JAX package's
within 0.05 pp of realized (or committed-hour) carbon (`PP`, the JAX
package's fused-vs-generic bound: the hinge subgradient makes iterates
chaotic under ulp-level changes); the port's `run_scanned` against its
own `run()` at the JAX package's loop-vs-day contract, 0.01 pp realized
and committed hours within 5e-3 NP (`SCAN_PP`, `COMMIT_ATOL`); CR3's
per-region price within 2 % (`RHO_MULTI`, the JAX package's own one-ulp
spread of its price); B1 and B3 ticks within 1e-5 relative (`BASE_RTOL`,
closed forms priced in float32). The sums, R = 1 and the day's replay
of its eager loop are held bit for bit.
"""
import contextlib
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import streaming as jstream
from repro.core.carbon import ForecastStream as JStream
from repro_torch.core import api as tapi
from repro_torch.core import fleet_solver as tfs
from repro_torch.core import regional as treg
from repro_torch.core import streaming as tstream
from repro_torch.core.carbon import ForecastStream as TStream
from torch_region_fleets import (STATES, carry, jax_regional_fleet,
                                 paper_templates)

PP = 0.05
SCAN_PP = 0.01
COMMIT_ATOL = 5e-3
RHO_MULTI = 0.02
BASE_RTOL = 1e-5
TICKS = 3
KW = dict(outer=2, cold_steps=120, warm_steps=40)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def templates():
    return paper_templates()


@pytest.fixture(scope="module")
def fleet(templates):
    """R = 3 (CA, TX, NY), 12 rows on the UTC clock with the default
    topology (which a streaming tick drops), JAX and port."""
    p = jax_regional_fleet(templates[0], 12, STATES, seed=3,
                           utc_offsets="auto")
    return p, carry(p)


def _streams(p, sigma=0.03, seed=7):
    """One stream per region over the fleet's traces, in each package."""
    actual = np.tile(np.asarray(p.mci, float), (1, 2))
    return (JStream.regional(actual, horizon=48, revision_sigma=sigma,
                             seed=seed),
            TStream.regional(actual, horizon=48, revision_sigma=sigma,
                             seed=seed))


def _stack(streams, n):
    """(n, R, T): each tick's forecast of every region."""
    return np.stack([np.stack([st.forecast(t) for st in streams])
                     for t in range(n)])


@contextlib.contextmanager
def _quiet():
    """CR3 warns where a region's clearing runs out of rounds."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


# ---------------------------------------------------------------------------
# Capture-safe per-region sums
# ---------------------------------------------------------------------------
def _mask_sum(x, region, R):
    """The per-region sum of the parent tree: `x[mask].sum()` per region,
    gathered back to rows (boolean indexing reads a count on the host)."""
    total = torch.zeros_like(x)
    for r in range(R):
        mask = region == r
        total = torch.where(mask, x[mask].sum(), total)
    return total


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("W,R", [(1, 1), (7, 3), (130, 2), (10_000, 3),
                                 (257, 4)])
def test_region_sum_is_the_mask_sum_bit_for_bit(W, R, order):
    rng = np.random.default_rng(W + R)
    region = np.sort(rng.integers(0, R, W))
    if order == "unsorted":
        region = rng.permutation(region)
    if R == 4:
        region[region == 2] = 1          # a region with no rows
    x = torch.as_tensor(rng.normal(0.0, 3.0, W) * 10.0 ** rng.integers(
        -3, 4, W), dtype=torch.float32)
    reg = torch.as_tensor(region, dtype=torch.int64)
    index = tfs.region_index(region, R, CPU)
    got = treg.region_sum(x, reg, index)
    assert torch.equal(got, _mask_sum(x, reg, R))
    for r in range(R):
        rows = x[torch.as_tensor(region == r)]
        # A region's total is the sum its standalone fleet takes.
        assert torch.equal(got[reg == r], rows.sum().expand(rows.shape[0]))
    assert index.counts == tuple(np.bincount(region, minlength=R))


def test_norms_are_the_mask_forms_bit_for_bit(fleet):
    """`cr1_norms` and `cr2_norms` on the index sums equal the parent
    tree's mask-sum forms of them, bit for bit, on a region-interleaved
    fleet."""
    _, tp = fleet
    perm = np.random.default_rng(0).permutation(tp.W)
    q = dataclasses.replace(tp, names=None, **{
        f: np.asarray(getattr(tp, f))[perm]
        for f in ("usage", "entitlement", "k", "rts_coeffs", "betas",
                  "x2_kind", "jobs", "is_batch", "region")})
    for prob in (tp, q):
        v = tfs.device_view(prob, CPU)
        R, region = prob.R, v.region
        lo, hi = tfs._bounds(v)
        wmci = v.mci[region]
        counts = _mask_sum(torch.ones(prob.W), region, R)
        step = (_mask_sum(torch.clamp(hi - lo, min=1e-6).mean(1), region, R)
                / counts)[:, None]
        car = 100.0 / _mask_sum((v.usage * wmci).sum(1), region, R)
        refs = torch.as_tensor(np.asarray(
            tfs.cr2_reference_fleet(prob, 0.78, "cpu"), np.float32))
        want1 = (100.0 / _mask_sum(v.entitlement, region, R), car, step)
        want2 = (car, torch.clamp(_mask_sum(refs, region, R) / counts,
                                  min=1e-3), step)
        for got, want in zip(treg.cr1_norms(v) + treg.cr2_norms(v, refs),
                             want1 + want2):
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# RollingHorizonSolver over regions
# ---------------------------------------------------------------------------
def _runs(fleet, policy, **kw):
    p, tp = fleet
    js, ts = _streams(p)
    kw = {**KW, **kw}
    want = jstream.RollingHorizonSolver(p, js, policy=policy,
                                        use_kernel=False, **kw)
    got = tstream.RollingHorizonSolver(tp, ts, policy=policy,
                                       device="cpu", **kw)
    return want, got


def _check_ledger(rep, R):
    for t in rep.ticks:
        assert np.shape(t.forecast_mci) == np.shape(t.realized_mci) == (R,)
        assert t.committed_by_region.shape == (R,)
        # Exact float64 totals of the float32 committed hours.
        assert t.committed_by_region.sum() == pytest.approx(
            t.committed.astype(float).sum(), rel=1e-12, abs=1e-12)
    assert np.isfinite(rep.committed).all()


@pytest.mark.parametrize("policy", ["cr1", "cr2", "cr3"])
def test_run_matches_reference(fleet, policy):
    jrhs, trhs = _runs(fleet, policy)
    with _quiet():
        want, got = jrhs.run(TICKS), trhs.run(TICKS)
    _check_ledger(got, 3)
    assert got.committed.shape == (12, TICKS)
    assert abs(got.realized_reduction_pct
               - want.realized_reduction_pct) < PP
    assert got.realized_baseline == pytest.approx(want.realized_baseline,
                                                  rel=1e-6)
    for g, t in zip(got.ticks, want.ticks):
        np.testing.assert_array_equal(g.forecast_mci, t.forecast_mci)
        np.testing.assert_array_equal(g.realized_mci, t.realized_mci)
        assert g.inner_steps == t.inner_steps
    assert got.ticks[-1].plan is not None
    assert all(t.plan is None for t in got.ticks[:-1])
    # The topology is dropped on a tick: no migration stage ran.
    assert "migration" not in got.ticks[-1].plan.extras
    if policy == "cr3":
        rho, rho_w = np.asarray(trhs.last_rho), np.asarray(jrhs.last_rho)
        assert rho.shape == rho_w.shape == (3,)
        np.testing.assert_allclose(rho, rho_w, rtol=RHO_MULTI)
    else:
        assert trhs.last_rho is None


@pytest.mark.parametrize("policy", ["b1", "b3"])
def test_baseline_ticks_match_reference(fleet, policy):
    jrhs, trhs = _runs(fleet, policy)
    want, got = jrhs.run(TICKS), trhs.run(TICKS)
    _check_ledger(got, 3)
    np.testing.assert_allclose(got.committed, want.committed,
                               rtol=BASE_RTOL, atol=0)
    for g, t in zip(got.ticks, want.ticks):
        assert g.realized_carbon == pytest.approx(t.realized_carbon,
                                                  rel=BASE_RTOL)
        assert g.forecast_carbon == pytest.approx(t.forecast_carbon,
                                                  rel=BASE_RTOL)


def test_adaptive_warm_reads_the_regional_revision(fleet):
    """`adaptive_warm` budgets each warm tick from the relative revision
    of the whole (R, T) forecast, as the JAX package does: the same
    budgets tick by tick."""
    kw = dict(adaptive_warm=True, warm_steps_min=10, revision_ref=0.3)
    p, tp = fleet
    js, ts = _streams(p)
    want = jstream.RollingHorizonSolver(p, js, policy="cr1", use_kernel=False,
                                        **{**KW, **kw}).run(TICKS)
    got = tstream.RollingHorizonSolver(tp, ts, policy="cr1", device="cpu",
                                       **{**KW, **kw}).run(TICKS)
    steps = [t.inner_steps for t in got.ticks]
    assert steps == [t.inner_steps for t in want.ticks]
    # Revisions of ~0.2 against 0.3: budgets between the floor and the
    # full warm budget.
    assert steps[0] == KW["cold_steps"]
    assert all(10 < n < KW["warm_steps"] for n in steps[1:])
    assert abs(got.realized_reduction_pct
               - want.realized_reduction_pct) < PP


def test_stream_count_is_checked(fleet):
    p, tp = fleet
    js, ts = _streams(p)
    for mod, prob, streams in ((jstream, p, js), (tstream, tp, ts)):
        with pytest.raises(ValueError, match="need 3 forecast stream"):
            mod.RollingHorizonSolver(prob, streams[:2])
        with pytest.raises(ValueError, match="need 3 forecast stream"):
            mod.RollingHorizonSolver(prob, streams[0])


# ---------------------------------------------------------------------------
# The multi-region day
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_run_scanned_matches_run(fleet, policy):
    """The day against the per-tick loop, at the JAX package's own
    contract; a second day chains warm from the first."""
    _, tp = fleet
    ts = _streams(fleet[0])[1]
    mk = functools.partial(tstream.RollingHorizonSolver, tp, ts,
                           policy=policy, device="cpu", **KW)
    loop, solver = mk().run(TICKS), mk()
    scan = solver.run_scanned(TICKS)
    _check_ledger(scan, 3)
    assert abs(scan.realized_reduction_pct
               - loop.realized_reduction_pct) < SCAN_PP
    np.testing.assert_allclose(scan.committed, loop.committed,
                               atol=COMMIT_ATOL)
    for a, b in zip(scan.ticks, loop.ticks):
        np.testing.assert_array_equal(a.forecast_mci, b.forecast_mci)
        assert a.inner_steps == b.inner_steps
    second = solver.run_scanned(TICKS)
    assert len(second.ticks) == 2 * TICKS
    assert [t.inner_steps for t in second.ticks[TICKS:]] \
        == [KW["warm_steps"] * (2 if policy == "cr2" else 1)] * TICKS
    assert np.isfinite(second.committed).all()
    assert second.ticks[-1].plan.preservation_violation < 1e-3


def _window(p, tick):
    def roll(a):
        return np.roll(np.asarray(a), -tick, axis=1)

    return dataclasses.replace(p, usage=roll(p.usage), jobs=roll(p.jobs))


def _day_pct(day, stack, p):
    """Carbon of the committed hours, each region's total priced at the
    tick's hour-0 forecast of its region, in % of the no-DR carbon of
    those hours."""
    region, usage = np.asarray(p.region), np.asarray(p.usage)
    car = base = 0.0
    for i in range(len(stack)):
        wmci = stack[i][region, 0]
        car += float((day.committed[i] * wmci).sum())
        base += float((usage[:, i] * wmci).sum())
    return 100.0 * car / base


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_solve_day_matches_reference(fleet, policy):
    """Two days of `solve_day` on one (n_ticks, R, T) stack per day, the
    second warm from the first, in each package: the committed hours'
    carbon and the last plan's penalty within 0.05 pp; on the cold first
    day every committed hour within 5e-3 NP too. The warm CR2 day at
    2 x 40 steps is not converged: there one hinge row's committed hour
    can part past 5e-3 NP from the JAX package's while the day's carbon
    stays within 0.05 pp."""
    p, tp = fleet
    js, ts = _streams(p)
    stack = _stack(ts, 2 * TICKS)
    np.testing.assert_array_equal(stack, _stack(js, 2 * TICKS))
    assert stack.shape == (2 * TICKS, 3, 48)
    jpol = japi.configured_policy(policy, outer=2)
    tpol = tapi.configured_policy(policy, outer=2)
    steps = dict(cold_steps=KW["cold_steps"], warm_steps=KW["warm_steps"])
    want = got = None
    for day in range(2):
        t0 = day * TICKS
        s = stack[t0:t0 + TICKS]
        want = japi.solve_day(_window(p, t0), jpol, s, ctx=japi.SolveContext(
            use_kernel=False,
            warm=None if want is None else want.last.state), **steps)
        got = tapi.solve_day(_window(tp, t0), tpol, s, ctx=tapi.SolveContext(
            device="cpu", warm=None if got is None else got.last.state),
            **steps)
        assert got.inner_steps == want.inner_steps
        assert got.committed.shape == (TICKS, 12)
        if day == 0:
            np.testing.assert_allclose(got.committed, want.committed,
                                       atol=COMMIT_ATOL)
        win = _window(p, t0)
        assert abs(_day_pct(got, s, win) - _day_pct(want, s, win)) < PP
        assert abs(got.last.total_penalty_pct
                   - want.last.total_penalty_pct) < PP
        assert got.last.preservation_violation < 1e-3


def test_solve_day_validation_matches_reference(fleet):
    """As the JAX package's (`tests/test_streaming.py`): a stack that is
    not (n_ticks,) + (R, T) raises naming `mci_stack`."""
    p, tp = fleet
    rstack = np.stack([np.asarray(p.mci)] * 2)
    for mod, prob, ctx in ((japi, p, japi.SolveContext(use_kernel=False)),
                           (tapi, tp, tapi.SolveContext(device="cpu"))):
        for bad in (rstack[:, :1, :10], rstack[:, :2], rstack[:, :, :10],
                    rstack[:, 0]):
            with pytest.raises(ValueError, match="mci_stack"):
                mod.solve_day(prob, "cr1", bad, ctx=ctx)
        with pytest.raises(NotImplementedError, match="host-side"):
            mod.solve_day(prob, "cr3", rstack, ctx=ctx)


def test_day_impl_is_solve_day_on_the_cpu(fleet):
    """On the CPU `solve_day` of a multi-region fleet is its tick loop run
    eagerly, bit for bit; the day's static key holds R and the rows per
    region."""
    _, tp = fleet
    stack = _stack(_streams(fleet[0])[1], 3)
    ctx = tapi.SolveContext(device="cpu")
    day = tapi.solve_day(tp, "cr1", stack, ctx=ctx, cold_steps=16,
                         warm_steps=8)
    _, _, key, inputs = tapi._day_setup(tp, tapi.CR1(), stack, ctx, 16, 8)
    assert key.R == 3
    assert key.region_counts == tuple(np.bincount(tp.region, minlength=3))
    assert inputs["region"].dtype == torch.int64
    assert inputs["mci"].shape == (3, 3, 48)
    with torch.no_grad():
        out = tapi._day_impl(key, inputs)
    np.testing.assert_array_equal(out[0].numpy(), day.committed)
    np.testing.assert_array_equal(out[3].numpy(), day.last.state.x.numpy())


# ---------------------------------------------------------------------------
# R = 1 is the single-region path, bit for bit
# ---------------------------------------------------------------------------
def test_r1_streaming_and_day_are_bitwise_single_region(fleet):
    _, tp = fleet
    single = dataclasses.replace(tp, mci=np.asarray(tp.mci)[0], region=None,
                                 topology=None)
    one = dataclasses.replace(tp, mci=np.asarray(tp.mci)[:1],
                              region=np.zeros(tp.W, np.int64),
                              topology=None)
    stream = TStream(actual=np.tile(np.asarray(tp.mci)[0], 2), horizon=48,
                     revision_sigma=0.03, seed=7)
    for policy in ("cr1", "cr2"):
        kw = dict(policy=policy, device="cpu", **KW)
        for run in (lambda s: s.run(TICKS), lambda s: s.run_scanned(TICKS)):
            a = run(tstream.RollingHorizonSolver(single, stream, **kw))
            b = run(tstream.RollingHorizonSolver(one, [stream], **kw))
            np.testing.assert_array_equal(a.committed, b.committed)
            assert a.realized_carbon == b.realized_carbon
            assert a.realized_baseline == b.realized_baseline
            assert b.ticks[0].committed_by_region is None
        stack = np.stack([stream.forecast(t) for t in range(TICKS)])
        ctx = tapi.SolveContext(device="cpu")
        a = tapi.solve_day(single, policy, stack, ctx=ctx, cold_steps=40)
        b = tapi.solve_day(one, policy, stack[:, None], ctx=ctx,
                           cold_steps=40)
        np.testing.assert_array_equal(a.committed, b.committed)
        np.testing.assert_array_equal(a.last.D, b.last.D)
