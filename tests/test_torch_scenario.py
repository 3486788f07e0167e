"""The port's scenario generators (`repro_torch.core.scenario`, numpy)
against the JAX package's (`repro.core.scenario`): the same arrays and
labels from the same seeds, over the same base fleet carried across with
`convert.fleet_problem_from_arrays`."""
import dataclasses

import numpy as np
import pytest

import repro.core.penalty as jpen
from repro.core import scenario as jscen
from repro.core.fleet_solver import synthetic_fleet
from repro_torch import convert
from repro_torch.core import penalty as tpen
from repro_torch.core import scenario as tscen


def _carry(p):
    return convert.fleet_problem_from_arrays(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


@pytest.fixture(scope="module")
def fleet8():
    """`synthetic_fleet(8, hours=48, seed=0)` of the JAX package, from its
    paper fleet calibrated small with the port's stable `name_hash` (as in
    `test_torch_solve.py`)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpen, "hash", tpen.name_hash, raising=False)
    try:
        templates = jpen.build_paper_fleet(num_samples=32, num_jobs=1000)
    finally:
        mp.undo()
    p = synthetic_fleet(8, hours=48, seed=0, templates=templates)
    return p, _carry(p)


GENERATORS = {
    "duck_perturb": dict(n_scenarios=5, seed=3),
    "renewable_drought": dict(n_scenarios=5, seed=1, max_days=2),
    "evening_ramp_spike": dict(n_scenarios=5, seed=2),
    "zero_mci_window": dict(n_scenarios=5, seed=4),
    "cambium_mix": dict(n_scenarios=6, seed=1),
    "forecast_regime": dict(n_scenarios=4, seed=5),
    "fleet_jitter": dict(n_scenarios=3, seed=2),
    "flex_mix_shift": dict(n_scenarios=3, seed=7),
}


def _assert_same_stack(got, want):
    assert got.S == want.S
    assert got.labels == want.labels
    assert set(got.overlay_fields()) == set(want.overlay_fields())
    for f, v in want.overlay_fields().items():
        np.testing.assert_array_equal(got.overlay_fields()[f], v)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_reference(fleet8, name):
    p, tp = fleet8
    kw = GENERATORS[name]
    want = jscen.SCENARIO_REGISTRY[name](**kw).generate(p)
    got = tscen.SCENARIO_REGISTRY[name](**kw).generate(tp)
    _assert_same_stack(got, want)
    got.validate(tp)


def test_registry_names_match_reference():
    assert set(tscen.SCENARIO_REGISTRY) == set(jscen.SCENARIO_REGISTRY)
    for name, cls in tscen.SCENARIO_REGISTRY.items():
        assert cls.name == name
        ref = jscen.SCENARIO_REGISTRY[name]
        assert ([f.name for f in dataclasses.fields(cls)]
                == [f.name for f in dataclasses.fields(ref)])


def test_forecast_regime_streams_match_reference(fleet8):
    p, tp = fleet8
    want = jscen.ForecastRegime(3, seed=9).streams(p, n_ticks=6)
    got = tscen.ForecastRegime(3, seed=9).streams(tp, n_ticks=6)
    for g, w in zip(got, want):
        assert (g.horizon, g.revision_sigma, g.seed) == (
            w.horizon, w.revision_sigma, w.seed)
        for t in range(6):
            np.testing.assert_array_equal(g.forecast(t), w.forecast(t))
            assert g.realized(t) == w.realized(t)


def test_concat_and_resolve_match_reference(fleet8):
    """A mix of generators (MCI overlays beside fleet overlays) resolves
    to the same concatenated stack; the stack's scenarios materialize as
    the same problems; a name resolves through the registry."""
    p, tp = fleet8
    spec = [("duck_perturb", dict(n_scenarios=2, seed=0)),
            ("flex_mix_shift", dict(n_scenarios=2, seed=1))]
    want = jscen.resolve_scenarios(
        [jscen.SCENARIO_REGISTRY[n](**kw) for n, kw in spec], p)
    got = tscen.resolve_scenarios(
        [tscen.SCENARIO_REGISTRY[n](**kw) for n, kw in spec], tp)
    _assert_same_stack(got, want)
    assert np.isinf(got.upper[:2]).all()
    for s in range(got.S):
        gp, wp = got.problem(tp, s), want.problem(p, s)
        for f in ("mci", "usage", "jobs", "upper", "entitlement"):
            np.testing.assert_array_equal(getattr(gp, f), getattr(wp, f))
    by_name = tscen.resolve_scenarios("duck_perturb", tp)
    _assert_same_stack(by_name, jscen.resolve_scenarios("duck_perturb", p))
    assert tscen.resolve_scenarios(by_name, tp) is by_name


def test_bad_specs_raise_like_reference(fleet8):
    p, tp = fleet8
    for mod, base in ((jscen, p), (tscen, tp)):
        with pytest.raises(ValueError, match="unknown scenario generator"):
            mod.resolve_scenarios("no_such_generator", base)
        with pytest.raises(TypeError, match="ScenarioStack"):
            mod.resolve_scenarios(3.0, base)
        with pytest.raises(ValueError, match="n_scenarios"):
            mod.DuckPerturb(n_scenarios=0)
        with pytest.raises(ValueError, match="disagree on S"):
            mod.ScenarioStack(mci=np.zeros((2, 48)), usage=np.zeros(
                (3, base.W, 48)))
        with pytest.raises(ValueError, match="overlay 'mci'"):
            mod.resolve_scenarios(mod.ScenarioStack(mci=np.zeros((2, 24))),
                                  base)


def test_regional_divergence_refused_by_name(fleet8):
    """`RegionalDivergence` refuses a single-region base by name, as the
    JAX package's does; over a multi-region base it and the per-region
    streams of `ForecastRegime` are the JAX package's arrays
    (`tests/test_torch_multiregion_lanes.py` holds them on the R = 3
    draw)."""
    p, tp = fleet8
    for mod, base in ((jscen, p), (tscen, tp)):
        with pytest.raises(ValueError, match="multi-region base"):
            mod.RegionalDivergence(2).generate(base)
    two = [dataclasses.replace(q, mci=np.stack([q.mci, 0.5 * q.mci]),
                               region=np.arange(q.W) % 2) for q in (p, tp)]
    want = jscen.RegionalDivergence(2).generate(two[0])
    got = tscen.RegionalDivergence(2).generate(two[1])
    np.testing.assert_array_equal(got.mci, want.mci)
    for gg, wg in zip(tscen.ForecastRegime(2).streams(two[1], n_ticks=2),
                      jscen.ForecastRegime(2).streams(two[0], n_ticks=2)):
        assert len(gg) == len(wg) == 2
        for g, w in zip(gg, wg):
            np.testing.assert_array_equal(g.forecast(1), w.forecast(1))
