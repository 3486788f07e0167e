"""CR3, the closed-form baselines and the coordinator on the CPU: the
port's `api.CR3`, `B1`, `B3`, the CR3 sweep lane, `FleetProblem.
from_problem`/`to_problem`, the deprecated shims and `FleetCoordinator`
against the JAX package's, on the 16-row fleet of `test_torch_solve.py`
(the JAX side on its generic engine, its automatic choice on the CPU).

Tolerances. CR3's best responses are projected Adam on a nearly flat
objective, and its clearing is chaotic under rounding in the JAX package
itself: moving the fleet's usage by one float32 ulp moves that package's
150-step clearing price by up to 2 % at the same 3 rounds, and to 2 or 4
rounds on other draws (`test_cr3_rho_gap_within_jax_ulp_spread`, the
witness). So the clearing price of a multi-round solve is held to that
spread, `RHO_MULTI`; the rounds, `balanced` and the plan's carbon and
penalty to 0.05 pp as the issue sets them. A one-round solve (the
default budget here) keeps rho at its configured value and is held to
1e-4. The sweep lane against the port's own loop takes the JAX
package's bounds for its sweep (`tests/test_api.py`): 0.05 pp, rho
1e-3, the same `balanced` and iterations.
"""
import dataclasses
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.core.penalty as jpen
from repro.core import api as japi
from repro.core import fleet_solver as jfs
from repro.core import policies as jpol
from repro.core.carbon import caiso_2021
from repro.core.fleet_solver import synthetic_fleet
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import fleet_solver as tfs
from repro_torch.core import penalty as tpen
from repro_torch.core import policies as tpol

PP = 0.05
RHO_ONE = 1e-4
RHO_MULTI = 0.02
RHO_LANE = 1e-3
ORDER = ("RTS1", "RTS2", "AITraining", "DataPipeline")


def _carry(p):
    return convert.fleet_problem_from_arrays(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


def _carry_model(m):
    return convert.penalty_model_from_arrays(
        **{f.name: getattr(m, f.name) for f in dataclasses.fields(m)})


@pytest.fixture(scope="module")
def templates():
    """The JAX package's paper fleet calibrated small with the port's
    stable `name_hash` (as `test_torch_solve.py`), and its port copy."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpen, "hash", tpen.name_hash, raising=False)
    try:
        jt = jpen.build_paper_fleet(num_samples=32, num_jobs=1000)
    finally:
        mp.undo()
    return jt, {k: _carry_model(m) for k, m in jt.items()}


@pytest.fixture(scope="module")
def fleet16(templates):
    p = synthetic_fleet(16, hours=48, seed=0, templates=templates[0])
    return p, _carry(p)


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", **kw)


def _same_clearing(got, want, rho_rtol):
    assert got.iters == want.iters                 # the same rounds
    assert got.extras["balanced"] == want.extras["balanced"]
    assert got.balanced == want.extras["balanced"]
    assert got.extras["rho"] == pytest.approx(want.extras["rho"],
                                              rel=rho_rtol)
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < PP
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < PP


@pytest.fixture(scope="module")
def cr3_solves(fleet16):
    """CR3 at its defaults on the fleet, solved once and shared by the
    tests below: `get(package, steps, use_kernel)` with package "jax" (the
    JAX package's CR3) or "port"."""
    p, tp = fleet16
    memo = {}

    def get(package, steps, use_kernel=False):
        key = (package, steps, use_kernel)
        if key not in memo:
            if package == "jax":
                memo[key] = japi.solve(p, japi.CR3(), ctx=japi.SolveContext(
                    use_kernel=use_kernel, steps=steps))
            else:
                memo[key] = tapi.solve(tp, tapi.CR3(), ctx=_ctx(
                    use_kernel=use_kernel, steps=steps))
        return memo[key]

    return get


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("steps", [150, 600])
def test_cr3_matches_jax(cr3_solves, steps, use_kernel):
    """The generic engine (plain features) and the kernel path (the
    kernel's plain forward and its closed-form backward) against the JAX
    package's generic engine. CR3 here takes the JAX package's 3-round
    day-mean projection (`test_cr3_exact_projection`)."""
    want = cr3_solves("jax", steps)
    got = cr3_solves("port", steps, use_kernel)
    _same_clearing(got, want, RHO_ONE if want.iters == steps * 3
                   else RHO_MULTI)
    assert got.D.shape == (16, 48) and np.isfinite(got.D).all()
    assert got.preservation_violation < 1e-3
    assert got.state.lam_in.shape == (16,)
    assert float(got.state.mu) == pytest.approx(0.01 * 2 ** 3)


@pytest.mark.parametrize("steps", [150, 600])
def test_cr3_kernel_path_is_the_plain_path(cr3_solves, steps):
    """dr_features' closed-form backward takes the plain path's gradient
    off the ties, so CR3 through it clears as the plain path, bit for
    bit, on the CPU."""
    got, want = (cr3_solves("port", steps, uk) for uk in (True, False))
    assert got.iters == want.iters
    assert got.extras == want.extras
    np.testing.assert_array_equal(got.D, want.D)


def test_cr3_rho_gap_within_jax_ulp_spread(fleet16, cr3_solves, capsys):
    """The witness behind `RHO_MULTI`, from the JAX package alone: its
    150-step CR3 on the fleet with usage moved by ±1 float32 ulp (draws
    1-4) against the unmoved solve, and its kernel path (the custom VJP,
    interpret mode) against its generic engine. The same-round spread of
    its clearing price is at least `RHO_MULTI`, and the port's gap to it
    no wider (`pytest -s` prints the numbers)."""
    p, _ = fleet16
    ctx = japi.SolveContext(use_kernel=False, steps=150)
    base = cr3_solves("jax", 150)
    rho0 = base.extras["rho"]
    spread, rows = 0.0, []
    for seed in (1, 2, 3, 4):
        sign = np.random.default_rng(seed).choice([-1, 1], size=p.usage.shape)
        u = (np.asarray(p.usage, np.float32) * (1 + 2.0 ** -23 * sign)
             ).astype(np.float32)
        r = japi.solve(dataclasses.replace(p, usage=u), japi.CR3(), ctx=ctx)
        assert r.extras["balanced"] and np.isfinite(r.D).all()
        gap = abs(r.extras["rho"] / rho0 - 1)
        if r.iters == base.iters:
            spread = max(spread, gap)
        rows.append((seed, r.iters // 450, r.extras["rho"], gap))
    kern = cr3_solves("jax", 150, True)
    got = cr3_solves("port", 150)
    port_gap = abs(got.extras["rho"] / rho0 - 1)
    with capsys.disabled():
        print(f"\nJAX CR3 150 steps: rounds {base.iters // 450} rho {rho0!r}")
        for seed, rounds, rho, gap in rows:
            print(f"  usage ±1 ulp draw {seed}: rounds {rounds} rho {rho!r}"
                  f" rel {gap:.6g}")
        print(f"  JAX kernel path: rounds {kern.iters // 450} rho "
              f"{kern.extras['rho']!r} rel "
              f"{abs(kern.extras['rho'] / rho0 - 1):.6g}")
        print(f"  port: rounds {got.iters // 450} rho {got.extras['rho']!r}"
              f" rel {port_gap:.6g}; same-round ulp spread {spread:.6g}")
    assert spread >= RHO_MULTI
    assert got.iters == base.iters and port_gap <= spread


def test_cr3_exact_projection(fleet16, cr3_solves, monkeypatch, capsys):
    """Why CR3 keeps the JAX package's day-mean projection beside the
    port's exact one: with the exact one, the default budget (600 steps)
    clears as the JAX package's (one round, 0.05 pp), but the 150-step
    solve takes other rounds than the JAX package's, which
    `test_cr3_matches_jax[150-*]` hold equal (`pytest -s` prints them)."""
    _, tp = fleet16
    monkeypatch.setattr(tapi, "_mean_projection", tfs._projection)
    for steps in (150, 600):
        got = tapi.solve(tp, tapi.CR3(), ctx=_ctx(steps=steps))
        want = cr3_solves("jax", steps)
        assert got.preservation_violation < 1e-3
        with capsys.disabled():
            print(f"\nexact projection, {steps} steps: rounds "
                  f"{got.iters // (3 * steps)} (JAX package "
                  f"{want.iters // (3 * steps)}), rho {got.extras['rho']!r}"
                  f" ({want.extras['rho']!r}), carbon "
                  f"{got.carbon_reduction_pct:.6f} % "
                  f"({want.carbon_reduction_pct:.6f} %)")
    _same_clearing(got, want, RHO_ONE)


def test_cr3_unbalanced_warns_like_jax(fleet16):
    """Clearing cut short: both packages warn, report the deficit and
    leave rho where the last round put it."""
    p, tp = fleet16
    kw = dict(rho=0.5, clearing_iters=1, outer=1)
    with pytest.warns(RuntimeWarning, match="Eq. 6 unmet"):
        want = japi.solve(p, japi.CR3(**kw), ctx=japi.SolveContext(
            use_kernel=False, steps=20))
    with pytest.warns(RuntimeWarning, match="Eq. 6 unmet"):
        got = tapi.solve(tp, tapi.CR3(**kw), ctx=_ctx(steps=20))
    assert not got.balanced and not want.balanced
    _same_clearing(got, want, RHO_ONE)
    assert got.fiscal_deficit == pytest.approx(want.fiscal_deficit,
                                               rel=1e-3)
    assert got.fiscal_deficit > 0


def test_cr3_warm_start_and_tick_entry(fleet16):
    """`ctx.warm`/`shift`/`reset_mu` seed round 0 as the JAX package's."""
    p, tp = fleet16
    jr = japi.solve(p, japi.CR3(outer=1), ctx=japi.SolveContext(
        use_kernel=False, steps=30))
    tr = tapi.solve(tp, tapi.CR3(outer=1), ctx=_ctx(steps=30))
    warm = convert.engine_state_from_arrays(
        *(np.asarray(getattr(jr.state, f)) for f in
          ("x", "lam_eq", "lam_in", "mu")), device="cpu")
    want = japi.solve(p, japi.CR3(outer=1), ctx=japi.SolveContext(
        use_kernel=False, steps=30, warm=jr.state, shift=1, reset_mu=True))
    got = tapi.solve(tp, tapi.CR3(outer=1), ctx=_ctx(
        steps=30, warm=warm, shift=1, reset_mu=True))
    _same_clearing(got, want, RHO_MULTI)
    assert abs(tr.carbon_reduction_pct - jr.carbon_reduction_pct) < PP


def _sweep_pols(mod):
    return [mod.CR3(tax_frac=t, outer=2, clearing_iters=2)
            for t in (0.18, 0.3)]


def test_cr3_sweep_matches_its_loop_and_jax(fleet16):
    p, tp = fleet16
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = tapi.sweep(tp, _sweep_pols(tapi), ctx=_ctx(steps=80))
        loop = [tapi.solve(tp, pl, ctx=_ctx(steps=80))
                for pl in _sweep_pols(tapi)]
        want = japi.sweep(p, _sweep_pols(japi), ctx=japi.SolveContext(
            use_kernel=False, steps=80))
    for g, lp, w in zip(got, loop, want):
        _same_clearing(g, w, RHO_MULTI)
        assert g.iters == lp.iters and g.balanced == lp.balanced
        assert g.extras["rho"] == pytest.approx(lp.extras["rho"],
                                                rel=RHO_LANE)
        assert abs(g.carbon_reduction_pct - lp.carbon_reduction_pct) < PP
        assert abs(g.total_penalty_pct - lp.total_penalty_pct) < PP
        assert g.state.x.shape == (16, 48)


def test_cr3_sweep_rides_the_lane_only_when_uniform(fleet16, monkeypatch):
    _, tp = fleet16
    calls = []
    real = tapi.CR3._sweep_family.__func__

    def spy(cls, *a, **k):
        calls.append(len(a[1]))
        return real(cls, *a, **k)

    monkeypatch.setattr(tapi.CR3, "_sweep_family", classmethod(spy))
    ctx = _ctx(steps=4)
    tapi.sweep(tp, [tapi.CR3(rho=0.02), tapi.CR3(rho=0.03)], ctx=ctx)
    tapi.sweep(tp, [tapi.CR3(outer=1), tapi.CR3(outer=2)], ctx=ctx)
    warm = tapi.solve(tp, tapi.CR3(), ctx=ctx).state
    tapi.sweep(tp, [tapi.CR3(), tapi.CR3(rho=0.01)],
               ctx=_ctx(steps=4, warm=warm))
    assert calls == [2]


@pytest.mark.parametrize("policy", ["b1", "b3"])
def test_baselines_match_jax(fleet16, policy):
    p, tp = fleet16
    make = {"b1": lambda m: m.B1(F=0.75),
            "b3": lambda m: m.B3(depth=0.5, max_cut=0.3)}[policy]
    want = japi.solve(p, make(japi), ctx=japi.SolveContext(use_kernel=False))
    for uk in (False, True):
        got = tapi.solve(tp, make(tapi), ctx=_ctx(use_kernel=uk))
        np.testing.assert_array_equal(got.D, want.D)
        assert got.iters == 0 and got.state is None and got.balanced
        assert got.carbon_reduction_pct == want.carbon_reduction_pct
        assert got.total_penalty_pct == pytest.approx(
            want.total_penalty_pct, rel=1e-5)
        assert got.preservation_violation == want.preservation_violation
    assert tapi.solve(tp, policy, ctx=_ctx()).D.shape == (16, 48)


def test_from_problem_to_problem_round_trip(templates):
    jt, tt = templates
    mci = np.asarray(caiso_2021(48).mci)
    jp = jpol.DRProblem(models=tuple(jt[n] for n in ORDER), mci=mci)
    tp = tpol.DRProblem(models=tuple(tt[n] for n in ORDER), mci=mci)
    want = jfs.FleetProblem.from_problem(jp)
    got = tfs.FleetProblem.from_problem(tp)
    for f in tfs.DATA_FIELDS + ("names", "day_hours", "max_curtail_frac"):
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None
        elif f == "names":
            assert a == tuple(b)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    back = got.to_problem()
    assert isinstance(back, tpol.DRProblem)
    for m, ref in zip(back.models, tp.models):
        assert (m.name, m.kind, m.k, m.params, m.entitlement) == (
            ref.name, ref.kind, ref.k, ref.params, ref.entitlement)
        assert m.feature_names == ref.feature_names
        np.testing.assert_array_equal(m.usage, ref.usage)
    D = np.random.default_rng(0).uniform(0, 1, (4, 48)) * tp.bounds()[1]
    Dt = torch.as_tensor(D)
    np.testing.assert_allclose(back.penalties(Dt).numpy(),
                               tp.penalties(Dt).numpy(), rtol=1e-12)
    assert got.to_problem(smooth=0.1).smooth == 0.1
    with pytest.raises(ValueError, match="preservation"):
        tfs.FleetProblem.from_problem(dataclasses.replace(
            tp, preservation="none"))
    with pytest.raises(ValueError, match="single-region"):
        dataclasses.replace(got, mci=np.stack([mci, mci])).to_problem()


SHIMS = {
    "solve_cr1_fleet": (lambda m, p, **k: m.solve_cr1_fleet(p, 1.2, 8, **k),
                        lambda p: ("cr1", tapi.CR1(lam=1.2), 8)),
    "solve_cr2_fleet": (lambda m, p, **k: m.solve_cr2_fleet(
        p, 0.8, 8, outer=2, **k), lambda p: ("cr2", tapi.CR2(0.8, 2), 8)),
    "solve_cr3_fleet": (lambda m, p, **k: m.solve_cr3_fleet(
        p, 0.02, steps=8, outer=1, **k),
        lambda p: ("cr3", tapi.CR3(outer=1), 8)),
}


@pytest.mark.parametrize("shim", sorted(SHIMS) + ["solve_cr1_fleet_sweep"])
def test_deprecated_shims(fleet16, shim):
    _, tp = fleet16
    with pytest.warns(DeprecationWarning, match=shim):
        if shim == "solve_cr1_fleet_sweep":
            out = tfs.solve_cr1_fleet_sweep(tp, [1.0, 1.5], steps=8,
                                            device="cpu")
            want = tapi.sweep(tp, [tapi.CR1(1.0), tapi.CR1(1.5)],
                              ctx=_ctx(steps=8))
            for a, b in zip(out, want):
                np.testing.assert_array_equal(a.D, b.D)
            return
        call, ref = SHIMS[shim]
        out = call(tfs, tp, device="cpu")
    _, pol, steps = ref(tp)
    want = tapi.solve(tp, pol, ctx=_ctx(steps=steps))
    if shim == "solve_cr3_fleet":
        out, rho = out
        assert rho == out.extras["rho"] == want.extras["rho"]
    np.testing.assert_array_equal(out.D, want.D)


def test_configured_policy_takes_cr3_knobs():
    cfg = tapi.configured_policy
    assert cfg("cr3", rho=0.03, tax_frac=0.25, outer=2) == tapi.CR3(
        rho=0.03, tax_frac=0.25, outer=2)
    assert cfg("cr3") == tapi.CR3(outer=4)
    assert cfg("b1") == tapi.B1() and cfg("b3") == tapi.B3()
    assert cfg(tapi.B3(depth=0.1), rho=0.5) == tapi.B3(depth=0.1)
    with pytest.raises(ValueError, match="unknown policy"):
        cfg("cr9")
    assert sorted(tapi.POLICY_REGISTRY) == sorted(japi.POLICY_REGISTRY)


def test_multiregion_cr3_still_refused(fleet16):
    """Multi-region CR3 solves through `solve` and `CR3.solve`
    (`tests/test_torch_multiregion_cr3.py` holds it against the JAX
    package) and through the rolling-horizon controller with a stream per
    region, whose `last_rho` is then (R,)
    (`tests/test_torch_multiregion_streaming.py`). A mesh shards it
    (`tests/test_torch_sharding.py`); what `solve` refuses is a mesh that
    is not a `DeviceMesh`."""
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.streaming import RollingHorizonSolver
    _, tp = fleet16
    two = dataclasses.replace(tp, mci=np.stack([tp.mci, tp.mci]),
                              region=np.arange(tp.W) % 2)
    stream = ForecastStream.caiso(n_ticks=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for res in (tapi.solve(two, tapi.CR3(), ctx=_ctx(steps=2)),
                    tapi.CR3().solve(two, _ctx(steps=2))):
            assert np.shape(res.extras["rho"]) == (2,)
        rhs = RollingHorizonSolver(two, [stream, stream], policy="cr3",
                                   cold_steps=2, warm_steps=2, device="cpu")
        rep = rhs.run(2)
    assert np.shape(rhs.last_rho) == (2,)
    assert rep.ticks[-1].committed_by_region.shape == (2,)
    with pytest.raises(ValueError, match="need 2 forecast stream"):
        RollingHorizonSolver(two, stream, policy="cr3", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tapi.solve(tp, tapi.CR3(), ctx=_ctx(mesh=object()))


# ---------------------------------------------------------------------------
# FleetCoordinator
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jfleet():
    """The JAX package's `repro.core.fleet`, whose solver import needs
    `jax.experimental.enable_x64` (moved to `jax.enable_x64` in jax 0.9):
    handed over for this file only, and taken back out of `sys.modules`
    afterwards."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
               raising=False)
    try:
        yield importlib.import_module("repro.core.fleet")
    finally:
        mp.undo()
        for name in ("repro.core.fleet", "repro.core.solver"):
            sys.modules.pop(name, None)
            if hasattr(repro.core, name.rsplit(".", 1)[1]):
                delattr(repro.core, name.rsplit(".", 1)[1])


def _jobs(mod, power):
    return [mod.FleetJob("train-a", "train", power.JobPowerModel(
                "train-a", 512, 0.8, 1.0)),
            mod.FleetJob("serve-b", "serve", power.JobPowerModel(
                "serve-b", 256, 0.3, 1.0)),
            mod.FleetJob("data-c", "data", power.JobPowerModel(
                "data-c", 128, 0.5, 1.0), diurnal_amplitude=0.02)]


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_coordinator_plan_matches_jax(templates, jfleet, policy,
                                      monkeypatch):
    import repro.core.fleetcache as jcache
    import repro.power.model as jpower
    from repro_torch.core import fleet as tfleet
    from repro_torch.core import fleetcache as tcache
    from repro_torch.core.carbon import caiso_2021 as tcaiso
    from repro_torch.power import model as tpower
    jt, tt = templates
    monkeypatch.setattr(jcache, "cached_paper_fleet", lambda **k: jt)
    monkeypatch.setattr(tcache, "cached_paper_fleet", lambda **k: tt)
    sig = caiso_2021(48)
    want_s, want = jfleet.FleetCoordinator(
        _jobs(jfleet, jpower), sig, policy=policy).plan()
    got_s, got = tfleet.FleetCoordinator(
        _jobs(tfleet, tpower), tcaiso(48), policy=policy,
        device="cpu").plan()
    # A converged SLSQP stops where its last steps fall under ftol, which
    # last-bit differences move (CR1: 9 iterations against 14, 3e-4 pp
    # apart); the plan is compared, to 0.01 pp and 1 % of throughput.
    assert got.solver == want.solver == "slsqp"
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < 0.01
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < 0.01
    assert sorted(got_s) == sorted(want_s)
    for name, s in got_s.items():
        np.testing.assert_allclose(s.throttle, want_s[name].throttle,
                                   atol=1e-2)
        assert s.at_hour(49) == s.throttle[1]


def test_coordinator_plan_streaming_matches_jax(templates, jfleet,
                                                monkeypatch):
    import repro.core.fleetcache as jcache
    import repro.power.model as jpower
    from repro_torch.core import fleet as tfleet
    from repro_torch.core import fleetcache as tcache
    from repro_torch.core.carbon import caiso_2021 as tcaiso
    from repro_torch.power import model as tpower
    jt, tt = templates
    monkeypatch.setattr(jcache, "cached_paper_fleet", lambda **k: jt)
    monkeypatch.setattr(tcache, "cached_paper_fleet", lambda **k: tt)
    kw = dict(n_ticks=3, cold_steps=40, warm_steps=10)
    want_s, want = jfleet.FleetCoordinator(
        _jobs(jfleet, jpower), caiso_2021(48)).plan_streaming(**kw)
    got_s, got = tfleet.FleetCoordinator(
        _jobs(tfleet, tpower), tcaiso(48), device="cpu").plan_streaming(**kw)
    assert got.total_inner_steps == want.total_inner_steps
    np.testing.assert_allclose(got.committed, want.committed, atol=5e-3)
    assert abs(got.realized_reduction_pct
               - want.realized_reduction_pct) < 0.01
    for name, s in got_s.items():
        np.testing.assert_allclose(s.throttle, want_s[name].throttle,
                                   atol=1e-2)


def test_power_model_matches_jax():
    import repro.power.model as jpower
    from repro_torch.power import model as tpower
    roof = {"t_compute_s": 0.4, "t_memory_s": 0.7, "t_collective_s": 0.2}
    a = jpower.job_power_from_roofline("j", roof, 64)
    b = tpower.job_power_from_roofline("j", roof, 64)
    for f in ("utilization", "power_watts", "power_np", "dynamic_fraction"):
        assert getattr(b, f) == getattr(a, f)
    for x in (0.0, 0.1, 0.9):
        assert b.steps_per_hour(x) == a.steps_per_hour(x)
        assert b.throttle_for_power_cut(x) == a.throttle_for_power_cut(x)
    assert dataclasses.asdict(tpower.ChipPower()) == dataclasses.asdict(
        jpower.ChipPower())


def test_jax_fleet_penalties_agree_on_cr3_plans(fleet16):
    """The port's CR3 plan, scored by the JAX package's penalties: the
    reported penalty is the plan's."""
    p, tp = fleet16
    got = tapi.solve(tp, tapi.CR3(outer=1), ctx=_ctx(steps=20))
    pens = np.asarray(jfs.fleet_penalties(p, jnp.asarray(got.D)))
    want = 100 * pens.sum() / np.asarray(p.entitlement).sum()
    assert got.total_penalty_pct == pytest.approx(want, rel=1e-4, abs=1e-7)
