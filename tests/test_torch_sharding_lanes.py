"""Fleet meshes in the sweeps, `solve_day`, the ensembles and streaming
on the CPU: the port's sharded calls against its unsharded ones and the
JAX package's.

The ranks are gloo processes spawned once per world size for the whole
module (`tests/torch_sharding_worker.py`, job kinds "sweep", "day",
"ensemble", "stream" and "refusals"); every rank runs every job, so each
result is held to rank 0's bitwise and rank 0's to the unsharded calls,
which the parent makes while the ranks run, with the JAX package's
unsharded call of every sweep, day and stream and of each ensemble (a
call that several jobs share made once). The fleets are
`tests/test_torch_sharding.py`'s: W = 17 (padded to 18 at world 2 and to
20 on the 2 x 2 mesh), the 13-row three-region fleet (padded to 14), and
a 9-row one-region fleet for the R = 1 day. The CR1 controllers keep
their tick ledgers, which only the first rank writes.

Bounds: against the port's unsharded call, carbon and penalty within
0.01 pp (the JAX package's sharded bound,
`tests/test_fleet_sharding.py:84-97`) and a day's or a stream's committed
hours within 1e-6 NP (tighter than the JAX package's own sharded bounds,
1e-3 NP for days and 1e-5 for streaming ticks,
`tests/test_fleet_sharding.py:161`, `:321-440`); pad rows of the state
exactly 0; the same inner steps. Against the JAX package's unsharded
call: 0.05 pp (its fused-vs-generic bound: the port projects exactly
where the JAX package takes 3 rounds of day-mean removal, ROADMAP A1-A2)
and a day's or a stream's committed hours within `JAX_COMMIT` = 5e-3 NP, the JAX
package's loop-vs-day contract (`tests/test_streaming.py:320-323`): the
port's unsharded CR2 day on this fleet already commits 2.08e-3 NP from
the JAX package's (CR1 9.5e-5), so its sharded bound (1e-3) cannot hold
across the packages.
"""
import os

import numpy as np
import pytest

import torch_sharding_worker as worker
from repro.core import api as japi
from repro.core import ensemble as jens
from repro.core import scenario as jscen
from repro.core import streaming as jstream
from repro.core.carbon import ForecastStream as JStream
from repro.core.fleet_solver import synthetic_fleet
from repro_torch.core import api as tapi
from repro_torch.core import ensemble as tens
from repro_torch.core import scenario as tscen
from repro_torch.core import streaming as tstream
from repro_torch.core.carbon import ForecastStream as TStream
from repro_torch.obs.events import read_events
from torch_region_fleets import carry, jax_regional_fleet, paper_templates

SHARD_PP = 0.01
JAX_PP = 0.05
COMMIT = 1e-6
JAX_COMMIT = 5e-3
W, W_REG, W_R1 = 17, 13, 9
TICKS = 4
LAMS = (1.0, 1.45, 2.2)
CAPS = (0.74, 0.78)
DAY = dict(cold_steps=24, warm_steps=8)
STREAM = dict(cold_steps=24, warm_steps=8, outer=2)


def _scenarios(mod):
    return [mod.DuckPerturb(4, seed=0), mod.FleetJitter(2, seed=1),
            mod.FlexMixShift(2, seed=2)]


@pytest.fixture(scope="module")
def fleets():
    """The 17-row mixed fleet, the 13-row three-region fleet (no
    topology: a day commits hour 0 and runs no migration stage) and a
    9-row one-region fleet, JAX and port copies, with their forecast
    stacks."""
    jt, _ = paper_templates()
    p = synthetic_fleet(W, hours=48, seed=0, templates=jt)
    pr = jax_regional_fleet(jt, W_REG, seed=0, topology=None)
    p1 = jax_regional_fleet(jt, W_R1, states=("CA",), seed=3, topology=None)
    stream = TStream.caiso(n_ticks=TICKS, horizon=48, seed=3,
                           revision_sigma=0.03)
    regional = TStream.regional(np.tile(np.asarray(pr.mci), (1, 2)),
                                horizon=48, revision_sigma=0.03, seed=7)
    return {
        "mixed": (p, carry(p)), "regions": (pr, carry(pr)),
        "r1": (p1, carry(p1)),
        "stack": np.stack([stream.forecast(t) for t in range(TICKS)]),
        "reg_stack": np.stack([np.stack([s.forecast(t) for s in regional])
                               for t in range(TICKS)]),
        "r1_stack": np.stack([np.asarray(p1.mci) * (1 + 0.02 * t)
                              for t in range(TICKS)]).astype(np.float32)}


def _streams(n):
    return (JStream.caiso(n_ticks=n, horizon=48, seed=3,
                          revision_sigma=0.03),
            TStream.caiso(n_ticks=n, horizon=48, seed=3,
                          revision_sigma=0.03))


def _once(memo, key, call):
    """`call()` made once for every job that shares `key`."""
    def get():
        if key not in memo:
            memo[key] = call()
        return memo[key]
    return get


def _jax_sweep(p, pols, steps, warm=None):
    ctx = japi.SolveContext(use_kernel=False, steps=steps)
    if warm is not None:
        cold = japi.sweep(p, pols, ctx=japi.SolveContext(
            use_kernel=False, steps=warm))
        ctx = japi.SolveContext(use_kernel=False, steps=steps,
                                warm=japi.stack_states([r.state
                                                        for r in cold]))
    return japi.sweep(p, pols, ctx=ctx)


def _jax_day(p, policy, stack, warm=None):
    return japi.solve_day(p, policy, stack, ctx=japi.SolveContext(
        use_kernel=False, warm=warm), **DAY)


def _jax_chain(p, policy, stack):
    """The JAX package's day and a second one warm from its state."""
    day = _jax_day(p, policy, stack)
    return day, _jax_day(p, policy, stack, warm=day.last.state)


def _jobs(fleets, world, events_dir):
    """(name, job) pairs for a `world`-rank group. A job's "jax" (a
    callable) makes the JAX package's unsharded call; the parent drops
    it. The CR1 streams keep their tick ledgers under `events_dir`."""
    p, tp = fleets["mixed"]
    stack = fleets["stack"]
    memo = {}
    pols = {"cr1": (tapi.CR1(lam=1.45), japi.CR1(lam=1.45)),
            "cr2": (tapi.CR2(cap_frac=0.78, outer=2),
                    japi.CR2(cap_frac=0.78, outer=2))}
    cr1_sweep = _once(memo, "sweep", lambda: _jax_sweep(
        p, [japi.CR1(lam=x) for x in LAMS], 40))
    days = {name: dict(kind="day", fleet=tp, policy=pols[name][0],
                       stack=stack, **DAY, jax=lambda pl=pols[name][1]:
                       _jax_day(p, pl, stack))
            for name in pols}
    if world == 4:
        return [(f"day-{name}", dict(job, regions=2))
                for name, job in days.items()]
    jobs = [(f"day-{name}", job) for name, job in days.items()]
    jobs[0][1].update(chain=True, jax=lambda: _jax_chain(
        p, pols["cr1"][1], stack))
    jobs += [
        ("sweep-cr1", dict(
            kind="sweep", fleet=tp, policies=[tapi.CR1(lam=x) for x in LAMS],
            ctx=dict(steps=40), jax=cr1_sweep)),
        ("sweep-cr2", dict(
            kind="sweep", fleet=tp,
            policies=[tapi.CR2(cap_frac=c, outer=2) for c in CAPS],
            ctx=dict(steps=30), jax=lambda: _jax_sweep(
                p, [japi.CR2(cap_frac=c, outer=2) for c in CAPS], 30))),
        ("sweep-cr1-fused", dict(
            kind="sweep", fleet=tp, policies=[tapi.CR1(lam=x) for x in LAMS],
            ctx=dict(steps=40, use_kernel=True), jax=cr1_sweep)),
        ("sweep-cr3", dict(
            kind="sweep", fleet=tp,
            policies=[tapi.CR3(rho=r, outer=2) for r in (0.01, 0.02)],
            ctx=dict(steps=40), jax=lambda: _jax_sweep(
                p, [japi.CR3(rho=r, outer=2) for r in (0.01, 0.02)], 40))),
        ("sweep-warm", dict(
            kind="sweep", fleet=tp, policies=[tapi.CR1(lam=x) for x in LAMS],
            ctx=dict(steps=20), warm_state=_cold_sweep_state(tp),
            jax=lambda: _jax_sweep(p, [japi.CR1(lam=x) for x in LAMS], 20,
                                   warm=40))),
        ("refusals", dict(kind="refusals", fleet=tp,
                          scenarios=tscen.DuckPerturb(2), stack=stack)),
        ("stream-cr1", dict(
            kind="stream", fleet=tp, streams=_streams(TICKS)[1],
            solver=dict(policy="cr1", **STREAM), ticks=TICKS,
            events=os.path.join(events_dir, "stream-cr1.jsonl"),
            jax=lambda: jstream.RollingHorizonSolver(
                p, _streams(TICKS)[0], policy="cr1", use_kernel=False,
                **STREAM).run(TICKS))),
        ("stream-cr1-scanned", dict(
            kind="stream", fleet=tp, streams=_streams(TICKS)[1],
            solver=dict(policy="cr1", **STREAM), ticks=TICKS,
            scanned=True,
            events=os.path.join(events_dir, "stream-cr1-scanned.jsonl"),
            jax=lambda: jstream.RollingHorizonSolver(
                p, _streams(TICKS)[0], policy="cr1", use_kernel=False,
                **STREAM).run_scanned(TICKS))),
        ("stream-cr3", dict(
            kind="stream", fleet=tp, streams=_streams(3)[1],
            solver=dict(policy=tapi.CR3(outer=2), **STREAM), ticks=3,
            jax=lambda: jstream.RollingHorizonSolver(
                p, _streams(3)[0], policy=japi.CR3(outer=2),
                use_kernel=False, **STREAM).run(3)))]
    for name, steps in (("cr1", 40), ("cr2", 30)):
        jobs.append((f"ens-{name}", dict(
            kind="ensemble", fleet=tp, policy=pols[name][0],
            scenarios=_scenarios(tscen), ctx=dict(steps=steps),
            jax=lambda pl=pols[name][1], s=steps: jens.evaluate_ensemble(
                p, pl, _scenarios(jscen), ctx=japi.SolveContext(
                    use_kernel=False, steps=s)))))
    pr, tpr = fleets["regions"]
    for regions, tag in ((None, ""), (2, "-2x1")):
        for name in pols:
            jobs.append((f"reg-day-{name}{tag}", dict(
                kind="day", fleet=tpr, policy=pols[name][0],
                stack=fleets["reg_stack"], regions=regions, **DAY,
                jax=_once(memo, name, lambda pl=pols[name][1]: _jax_day(
                    pr, pl, fleets["reg_stack"])))))
    p1, tp1 = fleets["r1"]
    for name, fleet in (("r1-day", tp1),
                        ("r1-day-single", tapi.single_region_view(tp1))):
        jobs.append((name, dict(
            kind="day", fleet=fleet, policy=pols["cr1"][0],
            stack=fleets["r1_stack"], **DAY,
            jax=_once(memo, "r1", lambda: _jax_day(
                p1, pols["cr1"][1], fleets["r1_stack"])))))
    return jobs


def _cold_sweep_state(tp):
    """The unsharded cold sweep's stacked state (numpy), a warm start."""
    out = tapi.sweep(tp, [tapi.CR1(lam=x) for x in LAMS],
                     ctx=tapi.SolveContext(device="cpu", steps=40))
    st = tapi.stack_states([r.state for r in out])
    return tuple(getattr(st, f).numpy() for f in ("x", "lam_eq", "lam_in",
                                                  "mu"))


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", **kw)


def _unsharded(name, job):
    """The port's unsharded call of a job (a stream's ledger beside the
    sharded one's, ".solo")."""
    kind = job["kind"]
    kw = dict(job.get("ctx", {}))
    if kind == "sweep":
        if "warm_state" in job:
            kw["warm"] = worker._warm(job)
        return tapi.sweep(job["fleet"], job["policies"], ctx=_ctx(**kw))
    if kind == "day":
        day = tapi.solve_day(job["fleet"], job["policy"], job["stack"],
                             ctx=_ctx(**kw), cold_steps=job["cold_steps"],
                             warm_steps=job["warm_steps"])
        if not job.get("chain"):
            return day
        return day, tapi.solve_day(
            job["fleet"], job["policy"], job["stack"],
            ctx=_ctx(warm=day.last.state, **kw),
            cold_steps=job["cold_steps"], warm_steps=job["warm_steps"])
    if kind == "ensemble":
        return tens.evaluate_ensemble(job["fleet"], job["policy"],
                                      job["scenarios"], ctx=_ctx(**kw))
    if kind == "stream":
        events = job.get("events")
        solver = tstream.RollingHorizonSolver(
            job["fleet"], job["streams"], device="cpu",
            events=events and events + ".solo", **job["solver"])
        run = solver.run_scanned if job.get("scanned") else solver.run
        return run(job["ticks"]), solver
    return None


def _run(fleets, world, events_dir):
    """Start the ranks, make the unsharded calls beside them, collect."""
    jobs = _jobs(fleets, world, events_dir)
    group = worker.Group(world, [(n, {k: v for k, v in j.items()
                                      if k != "jax"}) for n, j in jobs])
    try:
        want = {n: (_unsharded(n, j), j["jax"]() if "jax" in j else None)
                for n, j in jobs}
    finally:
        results = group.results()
    return results, want


@pytest.fixture(scope="module")
def events_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ledgers"))


@pytest.fixture(scope="module")
def world2(fleets, events_dir):
    return _run(fleets, 2, events_dir)


@pytest.fixture(scope="module")
def mesh2x2(fleets, events_dir):
    return _run(fleets, 4, events_dir)


def _ranks_equal(results, name):
    """Every rank's result bitwise rank 0's; rank 0's returned."""
    got = results[0][name]
    for other in results[1:]:
        for a, b in zip(_leaves(got), _leaves(other[name])):
            np.testing.assert_array_equal(a, b)
    return got


def _leaves(r):
    if isinstance(r, dict):
        return [v for k in sorted(r) for v in _leaves(r[k])]
    if isinstance(r, (list, tuple)):
        return [v for x in r for v in _leaves(x)]
    return [np.asarray(r)]


def _pads_zero(got, W_true, W_pad):
    """The padded state: x (W_pad, T), per-row multipliers (W_pad,),
    pad rows exactly 0."""
    assert got["x"].shape[-2:] == (W_pad, 48)
    assert not np.any(got["x"][..., W_true:, :])
    for lam in (got["lam_eq"], got["lam_in"]):
        assert lam.shape[-1] in (0, W_pad)
        assert not np.any(lam[..., W_true:])


def _close(got_c, got_p, c, pen, tol):
    assert abs(got_c - c) < tol and abs(got_p - pen) < tol


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sweep-cr1", "sweep-cr2",
                                  "sweep-cr1-fused", "sweep-cr3",
                                  "sweep-warm"])
def test_sharded_sweep(world2, name):
    """CR1 and CR2 grids on the batched lane at world 2 (17 rows padded
    to 18; lanes without a state, as the JAX package's), the fused CR1
    grid, a CR3 grid and a stacked warm state on the loop of sharded
    `solve`s (their states padded): each lane within 0.01 pp of the
    port's unsharded sweep and 0.05 pp of the JAX package's."""
    results, want = world2
    got = _ranks_equal(results, name)
    solo, jres = want[name]
    assert len(got) == len(solo)
    for g, s in zip(got, solo):
        assert g["D"].shape == (W, 48) and np.isfinite(g["D"]).all()
        assert g["iters"] == s.iters
        _close(g["carbon"], g["penalty"], s.carbon_reduction_pct,
               s.total_penalty_pct, SHARD_PP)
        batched = name in ("sweep-cr1", "sweep-cr2", "sweep-cr1-fused")
        assert g["state"] is not batched
        if not batched:
            _pads_zero(g, W, 18)
    for g, j in zip(got, jres or ()):
        _close(g["carbon"], g["penalty"], j.carbon_reduction_pct,
               j.total_penalty_pct, JAX_PP)


# ---------------------------------------------------------------------------
# Ensembles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ens-cr1", "ens-cr2"])
def test_sharded_ensemble(world2, name):
    """CR1 and CR2 over DuckPerturb(4), FleetJitter(2) and
    FlexMixShift(2) (usage, entitlement, jobs and `upper` overlays padded
    with the inert fills): the batched lane on the blocks, each scenario
    within 0.01 pp of the port's unsharded batched lane and 0.05 pp of
    the JAX package's."""
    results, want = world2
    got = _ranks_equal(results, name)
    solo, jres = want[name]
    assert got["batched"] and solo.batched
    assert got["D"].shape == (8, W, 48) and got["penalties"].shape == (8, W)
    for ref, tol in ((solo, SHARD_PP), (jres, JAX_PP)):
        np.testing.assert_array_less(
            np.abs(got["carbon"] - ref.carbon_reduction_pct), tol)
        np.testing.assert_array_less(
            np.abs(got["penalty"] - ref.total_penalty_pct), tol)


def test_sharded_ensemble_lane_is_cold_only(world2):
    """A warm, shifted or mu-reset batched lane under a mesh raises
    `ValueError`, as the JAX package's."""
    got = _ranks_equal(world2[0], "refusals")
    for key in ("warm", "shift", "reset_mu"):
        assert got[key][0] == "ValueError" and "cold-only" in got[key][1]


def test_sharded_day_refuses_telemetry_and_sanitize(world2):
    """A sharded day refuses telemetry and sanitize, as the JAX
    package's."""
    got = _ranks_equal(world2[0], "refusals")
    assert got["telemetry"][0] == "NotImplementedError"
    assert "telemetry" in got["telemetry"][1]
    assert got["sanitize"][0] == "NotImplementedError"
    assert "mesh" in got["sanitize"][1]


# ---------------------------------------------------------------------------
# Days
# ---------------------------------------------------------------------------
def _check_day(got, solo, jres, W_true, W_pad):
    assert got["committed"].shape == (TICKS, W_true)
    assert np.isfinite(got["committed"]).all()
    assert tuple(got["inner_steps"]) == solo.inner_steps
    assert np.abs(got["committed"] - solo.committed).max() <= COMMIT
    _close(got["carbon"], got["penalty"], solo.last.carbon_reduction_pct,
           solo.last.total_penalty_pct, SHARD_PP)
    _pads_zero(got, W_true, W_pad)
    if jres is not None:
        assert tuple(got["inner_steps"]) == tuple(jres.inner_steps)
        assert np.abs(got["committed"]
                      - np.asarray(jres.committed)).max() < JAX_COMMIT
        _close(got["carbon"], got["penalty"],
               jres.last.carbon_reduction_pct, jres.last.total_penalty_pct,
               JAX_PP)


@pytest.mark.parametrize("world, name", [
    (2, "day-cr1"), (2, "day-cr2"), (4, "day-cr1"), (4, "day-cr2")])
def test_sharded_day(world2, mesh2x2, world, name):
    """A 4-tick CR1 and CR2 day at world 2 (1-D mesh, 18 rows) and on
    the 2 x 2 mesh (20 rows), each tick normalized on the whole fleet's
    window: committed hours within 1e-6 NP of the port's unsharded day
    and `JAX_COMMIT` of the JAX package's, the last plan within 0.01 pp
    and 0.05 pp."""
    results, want = world2 if world == 2 else mesh2x2
    got = _ranks_equal(results, name)
    solo, jres = want[name]
    if isinstance(solo, tuple):
        solo, jres = solo[0], jres[0]
    _check_day(got, solo, jres, W, 18 if world == 2 else 20)


def test_sharded_day_warm_chain(world2):
    """A second day warm from the sharded day's padded state against the
    port's and the JAX package's unsharded chains."""
    results, want = world2
    got = _ranks_equal(results, "day-cr1/chain")
    solo, jres = want["day-cr1"]
    _check_day(got, solo[1], jres[1], W, 18)


@pytest.mark.parametrize("name", ["reg-day-cr1", "reg-day-cr2",
                                  "reg-day-cr1-2x1", "reg-day-cr2-2x1"])
def test_sharded_regional_day(world2, name):
    """The three-region fleet (13 rows padded to 14, the pad row in
    region 0) on the 1-D and the (2, 1) mesh: each tick's per-region
    norms from the whole fleet's window, padded and cut to the block;
    against the port's and the JAX package's unsharded regional day."""
    results, want = world2
    got = _ranks_equal(results, name)
    _check_day(got, *want[name], W_REG, 14)


def test_sharded_r1_day_is_the_single_region_day(world2):
    """R = 1 canonicalizes to the single-region day under a mesh too:
    bitwise; each held to the port's and the JAX package's unsharded
    R = 1 day."""
    results, want = world2
    a = _ranks_equal(results, "r1-day")
    b = _ranks_equal(results, "r1-day-single")
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)
    for name, got in (("r1-day", a), ("r1-day-single", b)):
        _check_day(got, *want[name], W_R1, 10)


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name, ticks", [
    ("stream-cr1", TICKS), ("stream-cr1-scanned", TICKS),
    ("stream-cr3", 3)])
def test_sharded_streaming(world2, name, ticks):
    """`RollingHorizonSolver(mesh=...)`: CR1 through `run(4)` and
    `run_scanned(4)`, CR3 through `run(3)`, every tick a sharded solve
    (or the day a sharded `solve_day`) warm from the padded state:
    committed hours within 1e-6 NP of the unsharded controller's,
    realized carbon within 0.01 pp, and 0.05 pp of the JAX package's."""
    results, want = world2
    got = _ranks_equal(results, name)
    (rep, solver), jres = want[name]
    assert got["committed"].shape == (W, ticks)
    assert got["inner_steps"] == rep.total_inner_steps
    assert np.abs(got["committed"] - rep.committed).max() <= COMMIT
    assert abs(got["reduction"] - rep.realized_reduction_pct) < SHARD_PP
    _pads_zero(got, W, 18)
    if jres is not None:
        assert got["inner_steps"] == jres.total_inner_steps
        assert np.abs(got["committed"]
                      - np.asarray(jres.committed)).max() < JAX_COMMIT
        assert abs(got["reduction"] - jres.realized_reduction_pct) < JAX_PP


@pytest.mark.parametrize("name", ["stream-cr1", "stream-cr1-scanned"])
def test_sharded_streaming_keeps_one_ledger(world2, events_dir, name):
    """Every rank steps the same controller, but only the first of the
    fleet's ranks writes the tick ledger: one header and one `TickEvent`
    a tick, the ticks of the unsharded controller's ledger."""
    _ranks_equal(world2[0], name)
    path = os.path.join(events_dir, name + ".jsonl")
    got, solo = read_events(path), read_events(path + ".solo")
    assert [e["kind"] for e in got].count("header") == 1
    ticks = [[e["tick"] for e in ledger if e["kind"] == "tick"]
             for ledger in (got, solo)]
    assert ticks[0] == ticks[1] == list(range(TICKS))
