"""Observability in the port (`repro_torch.obs`), on the CPU: in-solve
telemetry, the streaming tick ledger and the report, against the JAX
package's `repro.obs` on the same fleets and forecasts, and the port's own
contracts (telemetry on is bitwise off, refusals, the event schema, spans).

Fleets: the 16-row fleet of `tests/test_torch_solve.py` (the paper fleet
calibrated small, the JAX package's job traces seeded with the port's
stable hash), its RTS-only recast (no hinge, so iterates agree at 1e-5 and
the traces sample by sample), and the R = 3 draw of
`tests/torch_region_fleets.py`. Tolerances, RTS-only fleet, generic
engine: `step` and `mu` equal, `objective` rtol 1e-4, `grad_norm`² rtol
1e-3, `violation` and `dx` atol 1e-5 + rtol 1e-3; the same for every
tick of a CR1 day and for a CR2 day's cold tick. A CR2 day's warm ticks
start from multipliers that already differ at ~1e-3 (the JAX package
recomputes each window's targets in float32, the port takes the float64
cap plan) and their iterates drift apart tick by tick (committed hours
4.2e-4 NP apart at tick 3): measured, objective 8.7e-3 and `grad_norm`²
4.7e-3 relative, violation 5.8e-4 and dx 3.1e-5 absolute, so they are
held at `WARM_CR2` (rtol 2e-2; atol 2e-3 and 1e-4). Tick ledger: tick,
cold and steps equal, revision rtol 1e-6, objective proxy within 0.05 pp
(mixed fleets too), carbon rtol 1e-4.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import api as japi
from repro.core import streaming as jstream
from repro.core.carbon import ForecastStream as JStream
from repro.core.fleet_solver import synthetic_fleet
from repro.obs.report import render as jrender
from repro_torch.core import api as tapi
from repro_torch.core import streaming as tstream
from repro_torch.core.carbon import ForecastStream as TStream
from repro_torch.obs import (SCHEMA_VERSION, ConvergenceTrace, EventWriter,
                             SpanEvent, TelemetryConfig, TickEvent,
                             host_meta, read_events, span)
from repro_torch.obs import report as treport
from torch_region_fleets import (STATES, carry, jax_regional_fleet,
                                 paper_templates)

PP = 0.05
EVERY = 10
#: (objective rtol, grad_norm² rtol, violation atol, dx atol, rtol of both)
TRACE = (1e-4, 1e-3, 1e-5, 1e-5, 1e-3)
WARM_CR2 = (2e-2, 2e-2, 2e-3, 1e-4, 1e-3)


@pytest.fixture(scope="module")
def fleets():
    """{"mixed": 16 rows, "rts": its RTS-only recast, "r3": the R = 3
    12-row draw on the UTC clock}, each as (JAX, port)."""
    jt, _ = paper_templates()
    p = synthetic_fleet(16, hours=48, seed=0, templates=jt)
    r3 = jax_regional_fleet(jt, 12, STATES, seed=3, utc_offsets="auto")
    return {name: (q, carry(q)) for name, q in
            (("mixed", p), ("rts", _rts_only(p)), ("r3", r3))}


def _rts_only(p):
    """Every batch row recast as an RTS row (smooth cubic penalty)."""
    cubic = np.array([2e-4, 1.5e-3, 0.04])
    rts = np.where(np.asarray(p.is_batch)[:, None], cubic, p.rts_coeffs)
    return dataclasses.replace(p, is_batch=np.zeros(p.W, bool),
                               betas=np.zeros((p.W, 3)), rts_coeffs=rts)


POLICIES = {
    "cr1": (japi.CR1(lam=1.45), tapi.CR1(lam=1.45), 120),
    "cr2": (japi.CR2(cap_frac=0.78, outer=3), tapi.CR2(cap_frac=0.78,
                                                       outer=3), 60),
}


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", use_kernel=False, **kw)


def _check_trace(got, want, bounds=TRACE):
    """A port trace against the JAX package's, at `bounds`."""
    obj, g2, viol, dx, rtol = bounds
    np.testing.assert_array_equal(got.step, np.asarray(want.step))
    np.testing.assert_array_equal(got.mu, np.asarray(want.mu))
    np.testing.assert_allclose(got.objective, want.objective, rtol=obj)
    np.testing.assert_allclose(got.grad_norm ** 2, want.grad_norm ** 2,
                               rtol=g2)
    for f, atol in (("violation", viol), ("dx", dx)):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=atol, rtol=rtol)
    assert got.step_scale == pytest.approx(want.step_scale, rel=1e-6)


# ---------------------------------------------------------------------------
# In-solve telemetry against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_telemetry_matches_jax(fleets, policy):
    p, tp = fleets["rts"]
    jpol, tpol, steps = POLICIES[policy]
    tel = TelemetryConfig(every=EVERY)
    want = japi.solve(p, jpol, ctx=japi.SolveContext(
        use_kernel=False, steps=steps,
        telemetry=jobs.TelemetryConfig(every=EVERY))).extras["telemetry"]
    got = tapi.solve(tp, tpol, ctx=_ctx(steps=steps, telemetry=tel)
                     ).extras["telemetry"]
    assert isinstance(got, ConvergenceTrace)
    assert got.n_samples == steps * getattr(tpol, "outer", 1) // EVERY
    _check_trace(got, want)
    if policy == "cr1":
        assert np.all(got.violation == 0.0)
    else:
        assert got.mu[-1] > got.mu[0]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_solve_day_traces_match_jax(fleets, policy):
    """4 ticks, one trace each: the cold tick has 3x the samples of each
    warm tick, and each trace is the JAX package's."""
    p, tp = fleets["rts"]
    jpol, tpol, _ = POLICIES[policy]
    rng = np.random.default_rng((7, 2))
    base = np.asarray(p.mci, float)
    stack = np.stack([np.roll(base, -i) * (1 + 0.01 * rng.standard_normal(
        base.shape)) for i in range(4)])
    want = japi.solve_day(p, jpol, stack, cold_steps=60, warm_steps=20,
                          ctx=japi.SolveContext(
                              use_kernel=False,
                              telemetry=jobs.TelemetryConfig(every=EVERY)))
    off = tapi.solve_day(tp, tpol, stack, ctx=_ctx(), cold_steps=60,
                         warm_steps=20)
    on = tapi.solve_day(tp, tpol, stack, cold_steps=60, warm_steps=20,
                        ctx=_ctx(telemetry=TelemetryConfig(every=EVERY)))
    np.testing.assert_array_equal(off.committed, on.committed)
    assert "telemetry" not in off.last.extras
    traces = on.last.extras["telemetry"]
    assert len(traces) == 4
    warm_n = traces[1].n_samples
    assert warm_n > 0 and traces[0].n_samples == 3 * warm_n
    assert all(t.n_samples == warm_n for t in traces[1:])
    for tick, (got, w) in enumerate(zip(traces,
                                        want.last.extras["telemetry"])):
        _check_trace(got, w, WARM_CR2 if tick and policy == "cr2"
                     else TRACE)


# ---------------------------------------------------------------------------
# The port's own telemetry contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_telemetry_on_is_bitwise_off(fleets, policy):
    _, tp = fleets["mixed"]
    _, tpol, steps = POLICIES[policy]
    off = tapi.solve(tp, tpol, ctx=_ctx(steps=steps))
    on = tapi.solve(tp, tpol, ctx=_ctx(
        steps=steps, telemetry=TelemetryConfig(every=EVERY)))
    np.testing.assert_array_equal(off.D, on.D)
    for f in ("x", "lam_eq", "lam_in", "mu"):
        assert torch.equal(getattr(off.state, f), getattr(on.state, f))
    assert off.carbon_reduction_pct == on.carbon_reduction_pct
    assert "telemetry" not in off.extras
    d = next(on.extras["telemetry"].samples())
    assert set(d) == {"step", "objective", "grad_norm", "violation", "dx",
                      "mu"}
    json.dumps(d)


def test_telemetry_refusals(fleets):
    from repro_torch.core.engine import EngineConfig, EngineState, al_minimize
    _, tp = fleets["mixed"]
    tel = TelemetryConfig(every=EVERY)
    with pytest.raises(NotImplementedError, match="telemetry"):
        tapi.solve(tp, tapi.CR1(), ctx=tapi.SolveContext(
            device="cpu", use_kernel=True, steps=20, telemetry=tel))
    with pytest.raises(NotImplementedError, match="telemetry"):
        tapi.solve_day(tp, tapi.CR1(), np.stack([tp.mci] * 2),
                       cold_steps=8, ctx=tapi.SolveContext(
                           device="cpu", use_kernel=True, telemetry=tel))
    with pytest.raises(ValueError):
        TelemetryConfig(every=0)
    x0 = torch.zeros(3)
    cfg = EngineConfig(inner_steps=4, telemetry_every=2)
    with pytest.raises(ValueError, match="fused_inner"):
        al_minimize(lambda x, _: (x * x).sum(), lambda x: x, x0, cfg=cfg,
                    fused_inner=lambda x, *a: x)
    lanes = EngineState(x=torch.zeros(2, 3), lam_eq=torch.zeros(2, 0),
                        lam_in=torch.zeros(2, 0), mu=torch.ones(2))
    with pytest.raises(ValueError, match="lane"):
        al_minimize(lambda x, _: (x * x).sum(), lambda x: x, x0, cfg=cfg,
                    init=lanes)


def test_sweep_and_ensemble_traces_ride_the_loop_lane(fleets):
    from repro_torch.core.ensemble import evaluate_ensemble
    from repro_torch.core.scenario import DuckPerturb
    _, tp = fleets["mixed"]
    ctx = _ctx(steps=40, telemetry=TelemetryConfig(every=EVERY))
    rs = tapi.sweep(tp, [tapi.CR1(lam=1.2), tapi.CR1(lam=1.6)], ctx=ctx)
    alone = [tapi.solve(tp, pl, ctx=ctx) for pl in (tapi.CR1(lam=1.2),
                                                    tapi.CR1(lam=1.6))]
    for r, a in zip(rs, alone):
        assert r.extras["telemetry"].n_samples == 4
        np.testing.assert_array_equal(r.D, a.D)
        np.testing.assert_array_equal(r.extras["telemetry"].objective,
                                      a.extras["telemetry"].objective)
    assert not np.array_equal(rs[0].extras["telemetry"].objective,
                              rs[1].extras["telemetry"].objective)
    scen = DuckPerturb(n_scenarios=2, seed=0)
    got = evaluate_ensemble(tp, tapi.CR1(lam=1.4), scen, ctx=ctx)
    assert not got.batched
    assert all(e["telemetry"].n_samples == 4 for e in got.extras)
    with pytest.raises(ValueError, match="telemetry"):
        evaluate_ensemble(tp, tapi.CR1(lam=1.4), scen, ctx=ctx, batched=True)


def test_convergence_trace_from_tensors_and_numpy():
    tel = {"step": np.array([2, 4], np.int32),
           "objective": torch.tensor([3.0, 2.0]),
           "grad_sq": torch.tensor([4.0, 1.0]),
           "violation": torch.tensor([0.5, 0.25]),
           "dx": torch.tensor([0.1, 0.05]), "mu": torch.tensor([10.0, 20.0]),
           "step_scale": torch.tensor(0.5)}
    a = ConvergenceTrace.from_aux(tel)
    b = ConvergenceTrace.from_aux({k: np.asarray(v) for k, v in tel.items()})
    for f in ("step", "objective", "grad_norm", "violation", "dx", "mu"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.grad_norm, [2.0, 1.0])
    assert a.summary()["n_samples"] == 2 and a.step_scale == 0.5
    stacked = ConvergenceTrace.split({k: torch.stack([v, v])
                                      if isinstance(v, torch.Tensor)
                                      else np.stack([v, v])
                                      for k, v in tel.items()})
    assert len(stacked) == 2 and stacked[1].n_samples == 2


# ---------------------------------------------------------------------------
# The tick ledger against the JAX package
# ---------------------------------------------------------------------------
def _ledger(mod, stream_cls, p, path, telemetry, n=3):
    """A 3-tick CR1 controller of `mod` with the ledger and telemetry on,
    generic engine; its records."""
    stream = stream_cls.caiso(n_ticks=n, horizon=48, seed=1)
    where = {} if mod is jstream else {"device": "cpu"}
    rhs = mod.RollingHorizonSolver(
        p, stream, policy="cr1", cold_steps=60, warm_steps=15,
        use_kernel=False, events=str(path), telemetry=telemetry, **where)
    rhs.run(n)
    return read_events(path)


def _ticks(recs):
    return [r for r in recs if r["kind"] == "tick"]


@pytest.mark.parametrize("fleet", ["rts", "mixed"])
def test_tick_ledger_matches_jax(fleets, fleet, tmp_path):
    p, tp = fleets[fleet]
    want = _ledger(jstream, JStream, p, tmp_path / "jax.jsonl",
                   telemetry=jobs.TelemetryConfig(every=15))
    got = _ledger(tstream, TStream, tp, tmp_path / "port.jsonl",
                  telemetry=TelemetryConfig(every=15))
    assert got[0]["schema"] == want[0]["schema"] == SCHEMA_VERSION
    assert got[0]["tags"] == want[0]["tags"]
    jt, tt = _ticks(want), _ticks(got)
    assert [t["tick"] for t in tt] == [t["tick"] for t in jt] == [0, 1, 2]
    for a, b in zip(tt, jt):
        for f in ("cold", "warm_steps", "dispatches"):
            assert a[f] == b[f]
        assert a["revision"] == pytest.approx(b["revision"], rel=1e-6)
        assert abs(a["objective_proxy"] - b["objective_proxy"]) < PP
        assert a["latency_s"] > 0 and a["recompiles"] == 0
        if fleet == "rts":
            for f in ("committed_carbon", "realized_carbon"):
                np.testing.assert_allclose(a[f], b[f], rtol=1e-4)
    tel = {r["tick"] for r in got if r["kind"] == "telemetry"}
    assert tel == {r["tick"] for r in want if r["kind"] == "telemetry"} \
        == {0, 1, 2}


def test_tick_ledger_over_regions(fleets, tmp_path):
    """R = 3: per-region committed and realized carbon (3 each) and the
    migration credit on every tick, per-tick loop and day alike."""
    _, tp = fleets["r3"]
    actual = np.tile(np.asarray(tp.mci, float), (1, 2))
    streams = TStream.regional(actual, horizon=48, revision_sigma=0.03,
                               seed=7)
    path = tmp_path / "r3.jsonl"
    rhs = tstream.RollingHorizonSolver(
        tp, streams, policy="cr1", cold_steps=40, warm_steps=10,
        device="cpu", events=str(path), telemetry=TelemetryConfig(every=10))
    rhs.run(2)
    rhs.run_scanned(2)
    ticks = _ticks(read_events(path))
    assert [t["tick"] for t in ticks] == [0, 1, 2, 3]
    for t in ticks:
        assert len(t["committed_carbon"]) == len(t["realized_carbon"]) == 3
        assert "migration_credit" in t and t["migration_credit"] == 0.0
    out = rhs.report().ticks
    for t, o in zip(ticks, out):
        np.testing.assert_allclose(sum(t["realized_carbon"]),
                                   o.realized_carbon, rtol=1e-12)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------
def _jax_ledger(path):
    """A ledger written by the JAX package's `EventWriter`: ticks over two
    regions, telemetry samples and spans."""
    with jobs.EventWriter(str(path), tags={"policy": "cr1"}) as w:
        for tick in range(3):
            w.write(jobs.TickEvent(
                tick=tick, revision=0.01 * tick, warm_steps=60 if tick == 0
                else 15, cold=tick == 0, objective_proxy=11.5 + tick,
                latency_s=0.2, committed_carbon=[1.0 + tick, 2.0],
                realized_carbon=[1.1, 1.9 + tick], migration_credit=0.3,
                recompiles=2 if tick == 0 else 0, dispatches=1))
            for s in range(1, 5):
                w.write(jobs.TelemetryEvent(
                    tick=tick, step=5 * s, objective=10.0 / s,
                    grad_norm=1.0 / s, violation=0.1 / s, dx=0.01,
                    mu=10.0 * s))
        w.write(jobs.SpanEvent(name="solve", elapsed_s=0.5))
        w.write(jobs.SpanEvent(name="solve", elapsed_s=0.25))


def test_reports_render_a_jax_ledger_alike(tmp_path, capsys):
    path = tmp_path / "jax.jsonl"
    _jax_ledger(path)
    recs = read_events(path)
    want, got = jrender(recs).splitlines(), treport.render(recs).splitlines()
    assert got[1].startswith("host: ") and "jax" in got[1]
    assert got[:1] + got[2:] == want[:1] + want[2:]
    assert treport.main([str(path)]) == 0
    assert "tick ledger (3 ticks)" in capsys.readouterr().out


def test_report_renders_the_port_ledger(fleets, tmp_path, capsys):
    _, tp = fleets["mixed"]
    path = tmp_path / "port.jsonl"
    rhs = tstream.RollingHorizonSolver(
        tp, TStream.caiso(n_ticks=2, horizon=48, seed=1), cold_steps=20,
        warm_steps=5, device="cpu", events=str(path),
        telemetry=TelemetryConfig(every=5))
    rhs.run(2)
    with span("report", writer=rhs.events):
        pass
    assert treport.main([str(path)]) == 0
    out = capsys.readouterr().out
    for line in ("tick ledger (2 ticks)", "convergence (", "spans (1",
                 "graph capture(s) / kernel build(s)", "torch "):
        assert line in out
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "header", "schema": 999,
                               "host": {}}) + "\n")
    assert treport.main([str(bad)]) == 1


# ---------------------------------------------------------------------------
# Events and spans
# ---------------------------------------------------------------------------
def test_event_writer_appends_under_one_header_and_pins_the_schema(tmp_path):
    path = tmp_path / "ev.jsonl"
    with EventWriter(str(path), tags={"a": 1}) as w:
        w.write(SpanEvent(name="x", elapsed_s=0.5))
    with EventWriter(str(path)) as w:       # reopened: no second header
        w.write(SpanEvent(name="y", elapsed_s=0.25))
        w.write({"kind": "note", "text": "free-form"})
        with pytest.raises(ValueError, match="kind"):
            w.write({"text": "no kind"})
        with pytest.raises(TypeError):
            w.write(3)
    recs = read_events(path)
    assert [r["kind"] for r in recs] == ["header", "span", "span", "note"]
    assert recs[0]["tags"] == {"a": 1}
    # a ledger written by either package reads in the other
    assert jobs.read_events(path)[1] == recs[1]
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "header", "schema": 999}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        read_events(bad)
    headerless = tmp_path / "nohdr.jsonl"
    headerless.write_text(json.dumps({"kind": "span", "name": "x",
                                      "elapsed_s": 1.0}) + "\n")
    with pytest.raises(ValueError, match="header"):
        read_events(headerless)
    ev = TickEvent(tick=3, revision=0.02, warm_steps=40, cold=False,
                   objective_proxy=11.5, latency_s=0.2,
                   committed_carbon=[1.0, 2.0], realized_carbon=[1.1, 1.9],
                   migration_credit=0.3, recompiles=0, dispatches=1)
    assert dataclasses.asdict(ev) == {
        f.name: getattr(jobs.TickEvent(**dataclasses.asdict(ev)), f.name)
        for f in dataclasses.fields(jobs.TickEvent)}


def test_host_meta_fields():
    meta = host_meta()
    assert set(meta) == {"platform", "n_devices", "device_kind", "torch",
                         "cuda"}
    assert meta["torch"] == torch.__version__
    assert meta["cuda"] == torch.version.cuda
    assert meta["platform"] == ("cuda" if torch.cuda.is_available()
                                else "cpu")
    assert meta["n_devices"] >= 1


def test_span_times_and_writes_even_when_the_body_raises(tmp_path):
    path = tmp_path / "spans.jsonl"
    with EventWriter(str(path)) as w:
        with span("mul", writer=w, meta={"n": 64}) as sp:
            y = sp.bind(torch.ones(64) * 3, {"nested": [torch.ones(2)]})[0]
        assert sp.elapsed_s > 0
        assert torch.equal(y, 3 * torch.ones(64))
        with pytest.raises(RuntimeError, match="boom"):
            with span("fails", writer=w) as sp2:
                raise RuntimeError("boom")
        assert sp2.elapsed_s > 0
    recs = read_events(path)
    assert [r["name"] for r in recs[1:]] == ["mul", "fails"]
    assert recs[1]["meta"] == {"n": 64}


def test_profile_writes_a_trace(tmp_path):
    from repro_torch.obs import profile
    with profile(tmp_path / "prof") as prof:
        (torch.ones(32) * 2).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
