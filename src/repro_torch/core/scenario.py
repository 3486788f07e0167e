"""Monte Carlo grid/fleet scenario generation for ensemble evaluation.

A port of the JAX package's `repro.core.scenario`: numpy code that
produces the same arrays from the same seeds, over the port's
`FleetProblem` and `carbon` module, single- and multi-region.

The paper stress-tests Carbon Responder on one realized CAISO-2021 trace
plus two Cambium projections (Fig. 11). A production DR controller must be
evaluated across *distributions* of grid futures — renewable droughts,
evening-ramp spikes, zero-MCI solar windows, deep-decarbonization
projection mixes, forecast-error regimes — and across fleet perturbations
(usage/entitlement jitter, flex-fraction and batch/online mix shifts).
This module is the generation layer of that subsystem; the batched
evaluation lives in `repro.core.ensemble`.

Two kinds of object:

  * `ScenarioStack` — S *materialized* scenarios over a base
    `FleetProblem`: per-field overlay arrays with a leading S axis
    (`mci` (S, T), `usage` (S, W, T), `entitlement` (S, W), `jobs`,
    `upper`), `None` meaning "the base problem's field, shared by every
    scenario". The ensemble runner vmaps the overlaid fields straight
    through the fleet engine, so a stack with only an `mci` overlay costs
    S·T scenario floats, not S copies of the fleet. `problem(base, s)`
    materializes one scenario for the loop/parity path, and
    `ScenarioStack.concat` mixes stacks from different generators into
    one ensemble.

  * Scenario *generators* — frozen dataclasses whose fields are exactly
    the distribution's parameters, registered by name in
    `SCENARIO_REGISTRY` (the string-config hook, mirroring
    `api.POLICY_REGISTRY`). `generate(base)` returns a `ScenarioStack`
    and is deterministic: every random draw comes from a tuple-seeded
    `np.random.default_rng((seed, s, ...))`, so scenario `s` of a stack
    is a pure function of the generator's fields — re-generating never
    reshuffles the ensemble, and distinct (seed, s) pairs never collide.

MCI generators: `DuckPerturb` (shape/peak/trough jitter),
`RenewableDrought`, `EveningRampSpike`, `ZeroMciWindow`, `CambiumMix`
(2024/2050 `carbon.projection` mixes), `ForecastRegime` (per-scenario
`ForecastStream` sigma/seed — also the streaming ensemble's stream
factory), `RegionalDivergence` (per-region grid jitter over a
multi-region base — (S, R, T) overlays). Fleet generators:
`FleetJitter` (usage/entitlement scale), `FlexMixShift` (per-scenario
sheddable fraction via the `upper` operational cap + batch/online
usage mix shift).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Iterator, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core import carbon
from repro_torch.core.carbon import ForecastStream
from repro_torch.core.fleet_solver import FleetProblem

__all__ = [
    "SCENARIO_REGISTRY", "CambiumMix", "DuckPerturb", "EveningRampSpike",
    "FleetJitter", "FlexMixShift", "ForecastRegime", "RegionalDivergence",
    "RenewableDrought", "ScenarioGenerator", "ScenarioStack",
    "ZeroMciWindow", "resolve_scenarios",
]

#: FleetProblem data fields a scenario may overlay, with the leading-S
#: overlay shape relative to the base problem's (W, T).
OVERLAY_FIELDS = ("mci", "usage", "entitlement", "jobs", "upper")


@dataclasses.dataclass(frozen=True)
class ScenarioStack:
    """S materialized scenarios: per-field overlays with a leading S axis.

    Every non-None field must lead with the same S; `None` means the base
    problem's field is shared across scenarios. `labels` names each
    scenario for reports."""

    mci: np.ndarray | None = None          # (S, T) — (S, R, T) multi-region
    usage: np.ndarray | None = None        # (S, W, T)
    entitlement: np.ndarray | None = None  # (S, W)
    jobs: np.ndarray | None = None         # (S, W, T)
    upper: np.ndarray | None = None        # (S, W, T)
    labels: tuple[str, ...] | None = None

    def __post_init__(self):
        sizes = {np.asarray(v).shape[0] for v in self._overlays().values()}
        if self.labels is not None:
            sizes.add(len(self.labels))
        if len(sizes) != 1:
            raise ValueError(
                f"scenario overlays disagree on S (or the stack is empty): "
                f"leading sizes {sorted(sizes)}")

    def _overlays(self) -> dict[str, np.ndarray]:
        return {f: getattr(self, f) for f in OVERLAY_FIELDS
                if getattr(self, f) is not None}

    @property
    def S(self) -> int:
        for v in self._overlays().values():
            return int(np.asarray(v).shape[0])
        return len(self.labels)

    def overlay_fields(self) -> dict[str, np.ndarray]:
        """Non-None overlays as {field: (S, ...) array} (insertion order
        fixed by `OVERLAY_FIELDS` — stable jit static keys)."""
        return self._overlays()

    def validate(self, base: FleetProblem) -> None:
        shapes = {"mci": (self.S,) + np.asarray(base.mci).shape,
                  "usage": (self.S, base.W, base.T),
                  "entitlement": (self.S, base.W),
                  "jobs": (self.S, base.W, base.T),
                  "upper": (self.S, base.W, base.T)}
        for f, v in self._overlays().items():
            got = np.asarray(v).shape
            if got != shapes[f]:
                raise ValueError(
                    f"scenario overlay {f!r} has shape {got}; want "
                    f"{shapes[f]} for this base fleet")

    def problem(self, base: FleetProblem, s: int) -> FleetProblem:
        """Materialize scenario `s` as a plain FleetProblem (the
        sequential/parity path)."""
        over = {f: np.asarray(v[s]) for f, v in self._overlays().items()}
        return dataclasses.replace(base, **over)

    def problems(self, base: FleetProblem) -> Iterator[FleetProblem]:
        for s in range(self.S):
            yield self.problem(base, s)

    def label(self, s: int) -> str:
        return self.labels[s] if self.labels is not None else f"scenario-{s}"

    @staticmethod
    def concat(stacks: Sequence["ScenarioStack"],
               base: FleetProblem) -> "ScenarioStack":
        """Mix stacks into one ensemble. Fields overlaid by only some
        stacks are materialized from `base` for the others (the batched
        axis must be uniform)."""
        stacks = list(stacks)
        if not stacks:
            raise ValueError("concat of zero scenario stacks")
        fields = {f for st in stacks for f in st._overlays()}
        out: dict[str, np.ndarray] = {}
        for f in fields:
            parts = []
            for st in stacks:
                v = getattr(st, f)
                if v is None:
                    b = getattr(base, f)
                    # a base with no operational cap means "+inf"
                    b = np.full((base.W, base.T), np.inf) \
                        if b is None else np.asarray(b, float)
                    v = np.broadcast_to(b, (st.S,) + b.shape)
                parts.append(np.asarray(v, float))
            out[f] = np.concatenate(parts)
        labels = tuple(st.label(s) for st in stacks for s in range(st.S))
        return ScenarioStack(labels=labels, **out)


@runtime_checkable
class ScenarioGenerator(Protocol):
    """A scenario distribution: a frozen parameter record that knows how
    to materialize a deterministic `ScenarioStack` over a base fleet."""

    name: ClassVar[str]
    n_scenarios: int
    seed: int

    def generate(self, base: FleetProblem) -> ScenarioStack: ...


#: Generator name -> class; the one place string-typed scenario configs
#: (CLI flags, benchmark specs) resolve.
SCENARIO_REGISTRY: dict[str, type] = {}


def _register(cls):
    SCENARIO_REGISTRY[cls.name] = cls
    return cls


def resolve_scenarios(spec, base: FleetProblem) -> ScenarioStack:
    """Coerce a ScenarioStack, generator object, registry name, or sequence
    thereof (concatenated) into one materialized `ScenarioStack`."""
    if isinstance(spec, ScenarioStack):
        stack = spec
    elif isinstance(spec, str):
        try:
            gen = SCENARIO_REGISTRY[spec]()
        except KeyError:
            raise ValueError(
                f"unknown scenario generator {spec!r}; registered: "
                f"{', '.join(sorted(SCENARIO_REGISTRY))}") from None
        stack = gen.generate(base)
    elif isinstance(spec, ScenarioGenerator):
        stack = spec.generate(base)
    elif isinstance(spec, (list, tuple)):
        stack = ScenarioStack.concat(
            [resolve_scenarios(s, base) for s in spec], base)
    else:
        raise TypeError(
            f"scenarios must be a ScenarioStack, a ScenarioGenerator, a "
            f"SCENARIO_REGISTRY name, or a sequence of those; got "
            f"{type(spec).__name__}")
    stack.validate(base)
    return stack


def _rng(seed: int, s: int, stream: int = 0) -> np.random.Generator:
    """The subsystem-wide seeding convention: tuple-seeded, never additive."""
    return np.random.default_rng((seed, s, stream))


class _GeneratorBase:
    """Shared generator validation (dataclasses call `__post_init__` from
    the MRO): an empty ensemble is a caller bug, not an empty stack."""

    def __post_init__(self):
        if self.n_scenarios < 1:
            raise ValueError(
                f"{type(self).__name__}.n_scenarios must be >= 1, got "
                f"{self.n_scenarios}")


# ---------------------------------------------------------------------------
# MCI scenario generators
# ---------------------------------------------------------------------------
@_register
@dataclasses.dataclass(frozen=True)
class DuckPerturb(_GeneratorBase):
    """Duck-curve shape uncertainty: per-scenario peak/trough/solar-center
    jitter around the CAISO-2021 anchors (paper Fig. 1 'Today')."""

    n_scenarios: int = 16
    seed: int = 0
    peak_sigma: float = 0.08       # relative peak-level jitter
    trough_sigma: float = 0.08     # absolute trough-fraction jitter
    center_sigma: float = 1.0      # hours of solar-peak timing jitter

    name: ClassVar[str] = "duck_perturb"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        mcis, labels = [], []
        for s in range(self.n_scenarios):
            r = _rng(self.seed, s)
            peak = carbon.CAISO_2021_PEAK * float(
                np.exp(self.peak_sigma * r.standard_normal()))
            trough = float(np.clip(
                carbon.CAISO_2021_TROUGH_FRAC
                + self.trough_sigma * r.standard_normal(), 0.05, 0.95))
            center = 13.0 + self.center_sigma * float(r.standard_normal())
            mcis.append(carbon._duck_curve(
                base.T, peak, trough, solar_center=center,
                seed=(self.seed, s, 1)))
            labels.append(f"duck{s}[p={peak:.0f},t={trough:.2f}]")
        return ScenarioStack(mci=np.stack(mcis), labels=tuple(labels))


@_register
@dataclasses.dataclass(frozen=True)
class RenewableDrought(_GeneratorBase):
    """Renewable-drought days on top of the base MCI: the midday trough
    fills back toward the peak for 1..`max_days` consecutive days."""

    n_scenarios: int = 16
    seed: int = 0
    severity: tuple[float, float] = (0.4, 0.95)
    max_days: int = 2

    name: ClassVar[str] = "renewable_drought"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        n_days = max(1, base.T // base.day_hours)
        mcis, labels = [], []
        for s in range(self.n_scenarios):
            r = _rng(self.seed, s)
            day = int(r.integers(0, n_days))
            span = int(r.integers(1, self.max_days + 1))
            sev = float(r.uniform(*self.severity))
            mcis.append(carbon.apply_drought(
                base.mci, day, n_days=span, severity=sev,
                day_hours=base.day_hours))
            labels.append(f"drought{s}[d{day}+{span},sev={sev:.2f}]")
        return ScenarioStack(mci=np.stack(mcis), labels=tuple(labels))


@_register
@dataclasses.dataclass(frozen=True)
class EveningRampSpike(_GeneratorBase):
    """Evening-ramp spike events: 1..`max_events` multiplicative gaussian
    bumps at random evening hours (17:00–21:00) of random days."""

    n_scenarios: int = 16
    seed: int = 0
    magnitude: tuple[float, float] = (1.2, 1.9)
    max_events: int = 2

    name: ClassVar[str] = "evening_ramp_spike"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        n_days = max(1, base.T // base.day_hours)
        mcis, labels = [], []
        for s in range(self.n_scenarios):
            r = _rng(self.seed, s)
            mci = np.asarray(base.mci, float)
            n_ev = int(r.integers(1, self.max_events + 1))
            for _ in range(n_ev):
                hour = (int(r.integers(0, n_days)) * base.day_hours
                        + int(r.integers(17, 22)))
                mci = carbon.apply_evening_spike(
                    mci, min(hour, base.T - 1),
                    magnitude=float(r.uniform(*self.magnitude)))
            mcis.append(mci)
            labels.append(f"ramp_spike{s}[{n_ev}ev]")
        return ScenarioStack(mci=np.stack(mcis), labels=tuple(labels))


@_register
@dataclasses.dataclass(frozen=True)
class ZeroMciWindow(_GeneratorBase):
    """Zero-MCI solar windows: curtailed renewables set the marginal
    intensity to zero for a midday window (Fig.-11 2050 grids)."""

    n_scenarios: int = 16
    seed: int = 0
    window: tuple[int, int] = (2, 6)   # window length range, hours

    name: ClassVar[str] = "zero_mci_window"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        n_days = max(1, base.T // base.day_hours)
        mcis, labels = [], []
        for s in range(self.n_scenarios):
            r = _rng(self.seed, s)
            length = int(r.integers(self.window[0], self.window[1] + 1))
            start = (int(r.integers(0, n_days)) * base.day_hours
                     + int(r.integers(10, 16 - min(length, 5))))
            mcis.append(carbon.apply_zero_window(base.mci, start, length))
            labels.append(f"zero_mci{s}[{start}h+{length}]")
        return ScenarioStack(mci=np.stack(mcis), labels=tuple(labels))


@_register
@dataclasses.dataclass(frozen=True)
class CambiumMix(_GeneratorBase):
    """Cambium 2024/2050 projection mix: each scenario draws a (year,
    state) pair and a noise seed through `carbon.projection` — the
    Fig.-11 sweep as a sampled distribution instead of a grid."""

    n_scenarios: int = 16
    seed: int = 0
    years: tuple[int, ...] = (2024, 2050)
    states: tuple[str, ...] = carbon.STATES

    name: ClassVar[str] = "cambium_mix"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        mcis, labels = [], []
        for s in range(self.n_scenarios):
            r = _rng(self.seed, s)
            year = int(self.years[int(r.integers(len(self.years)))])
            state = str(self.states[int(r.integers(len(self.states)))])
            sig = carbon.projection(year, state, hours=base.T,
                                    seed=int(r.integers(2 ** 31)))
            mcis.append(sig.mci)
            labels.append(f"cambium{s}[{year}-{state}]")
        return ScenarioStack(mci=np.stack(mcis), labels=tuple(labels))


@_register
@dataclasses.dataclass(frozen=True)
class ForecastRegime(_GeneratorBase):
    """Forecast-error regimes: per-scenario `ForecastStream` revision
    sigma and seed over the base MCI.

    `generate` evaluates the *planning* risk: each scenario's MCI is the
    tick-0 day-ahead forecast a stream of that regime would issue, so the
    static ensemble measures how plans degrade with forecast skill.
    `streams` is the rolling-horizon hook: the S independent streams the
    streaming ensemble (`ensemble.run_streaming_ensemble`) drives through
    batched warm-started ticks."""

    n_scenarios: int = 16
    seed: int = 0
    sigma: tuple[float, float] = (0.01, 0.08)

    name: ClassVar[str] = "forecast_regime"

    def _params(self, s: int) -> tuple[float, int]:
        r = _rng(self.seed, s)
        return float(r.uniform(*self.sigma)), int(r.integers(2 ** 31))

    def streams(self, base: FleetProblem, n_ticks: int = 1):
        """S independent streams over the base MCI (periodically extended
        to cover `n_ticks` rolling solves of `base.T` hours each). A
        multi-region base gets S *groups* of R streams — one stream per
        region sharing the scenario's revision sigma (seeds offset per
        region so regional errors stay independent), the shape
        `ensemble.run_streaming_ensemble` and `RollingHorizonSolver`
        expect."""
        actual = np.asarray(base.mci, float)
        if actual.ndim == 2:       # multi-region: S groups of R streams
            reps = -(-(n_ticks + base.T - 1) // actual.shape[1])
            tiled = np.tile(actual, (1, max(reps, 1)))
            out = []
            for s in range(self.n_scenarios):
                sig, sd = self._params(s)
                out.append(tuple(
                    ForecastStream(actual=tiled[r], horizon=base.T,
                                   revision_sigma=sig, seed=sd + r)
                    for r in range(tiled.shape[0])))
            return tuple(out)
        reps = -(-(n_ticks + base.T - 1) // actual.shape[0])
        actual = np.tile(actual, max(reps, 1))
        out = []
        for s in range(self.n_scenarios):
            sig, sd = self._params(s)
            out.append(ForecastStream(actual=actual, horizon=base.T,
                                      revision_sigma=sig, seed=sd))
        return tuple(out)

    def generate(self, base: FleetProblem) -> ScenarioStack:
        streams = self.streams(base)
        if base.is_multiregion:
            mcis = np.stack([[st.forecast(0) for st in g]
                             for g in streams])
            labels = tuple(f"forecast{i}[sigma={g[0].revision_sigma:.3f}]"
                           for i, g in enumerate(streams))
        else:
            mcis = np.stack([st.forecast(0) for st in streams])
            labels = tuple(f"forecast{i}[sigma={st.revision_sigma:.3f}]"
                           for i, st in enumerate(streams))
        return ScenarioStack(mci=mcis, labels=labels)


@_register
@dataclasses.dataclass(frozen=True)
class RegionalDivergence(_GeneratorBase):
    """Cross-region grid divergence over a multi-region base: each
    scenario jitters every region's MCI trace independently — a
    per-region level scale plus a per-region midday trough fill — so
    the ensemble spans futures where the regional carbon spread (the
    signal the migration lever arbitrages) widens, narrows, or flips.
    Requires a multi-region base (`mci` of shape (R, T)); overlays are
    (S, R, T)."""

    n_scenarios: int = 16
    seed: int = 0
    level_sigma: float = 0.10    # per-region multiplicative level jitter
    trough_sigma: float = 0.25   # per-region trough-fill severity scale

    name: ClassVar[str] = "regional_divergence"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        if not base.is_multiregion:
            raise ValueError(
                "RegionalDivergence needs a multi-region base problem "
                "(mci of shape (R, T)); build one with "
                "fleet_solver.regional_fleet / synthetic_regional_fleet")
        mci = np.asarray(base.mci, float)
        R = mci.shape[0]
        n_days = max(1, base.T // base.day_hours)
        mcis, labels = [], []
        for s in range(self.n_scenarios):
            rows = []
            for reg in range(R):
                r = _rng(self.seed, s, reg + 1)
                level = float(np.exp(
                    self.level_sigma * r.standard_normal()))
                sev = float(np.clip(
                    self.trough_sigma * abs(r.standard_normal()), 0.0, 0.95))
                row = mci[reg] * level
                if sev > 0.0:
                    row = carbon.apply_drought(
                        row, 0, n_days=n_days, severity=sev,
                        day_hours=base.day_hours)
                rows.append(row)
            mcis.append(np.stack(rows))
            labels.append(f"regional_div{s}")
        return ScenarioStack(mci=np.stack(mcis), labels=tuple(labels))


# ---------------------------------------------------------------------------
# Fleet scenario generators
# ---------------------------------------------------------------------------
@_register
@dataclasses.dataclass(frozen=True)
class FleetJitter(_GeneratorBase):
    """Fleet composition uncertainty: per-workload multiplicative scale
    jitter on usage (jobs track usage, as in `synthetic_fleet`) and —
    independently — on entitlements. Because the two draws are
    independent, usage can exceed its reservation in some scenarios:
    exactly the overload futures the risk report is meant to surface
    (`usage_sigma > 0, entitlement_sigma = 0` jitters demand against
    fixed reservations)."""

    n_scenarios: int = 16
    seed: int = 0
    usage_sigma: float = 0.15
    entitlement_sigma: float = 0.05

    name: ClassVar[str] = "fleet_jitter"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        usage = np.asarray(base.usage, float)
        ent = np.asarray(base.entitlement, float)
        jobs = np.asarray(base.jobs, float)
        us, es, js = [], [], []
        for s in range(self.n_scenarios):
            r = _rng(self.seed, s)
            fu = np.exp(self.usage_sigma * r.standard_normal(base.W))
            fe = np.exp(self.entitlement_sigma * r.standard_normal(base.W))
            us.append(usage * fu[:, None])
            js.append(jobs * fu[:, None])
            es.append(ent * fe)
        labels = tuple(f"fleet_jitter[{s}]"
                       for s in range(self.n_scenarios))
        return ScenarioStack(usage=np.stack(us), entitlement=np.stack(es),
                             jobs=np.stack(js), labels=labels)


@_register
@dataclasses.dataclass(frozen=True)
class FlexMixShift(_GeneratorBase):
    """Flex-fraction and batch/online mix shifts.

    Per scenario: (a) an operational `upper` cap = flex·usage — only a
    drawn fraction of each workload's power is actually sheddable by
    throttling; (b) a batch-share factor scaling batch workloads' usage
    up and online workloads' down (or vice versa), shifting how much of
    the fleet's power is deferrable."""

    n_scenarios: int = 16
    seed: int = 0
    flex: tuple[float, float] = (0.25, 0.7)
    mix_sigma: float = 0.2

    name: ClassVar[str] = "flex_mix_shift"

    def generate(self, base: FleetProblem) -> ScenarioStack:
        usage = np.asarray(base.usage, float)
        jobs = np.asarray(base.jobs, float)
        is_batch = np.asarray(base.is_batch, bool)
        base_upper = None if base.upper is None \
            else np.asarray(base.upper, float)
        us, js, ups, labels = [], [], [], []
        for s in range(self.n_scenarios):
            r = _rng(self.seed, s)
            mix = float(np.exp(self.mix_sigma * r.standard_normal()))
            scale = np.where(is_batch, mix, 1.0 / mix)[:, None]
            u = usage * scale
            flex = r.uniform(*self.flex, size=base.W)[:, None]
            upper = flex * u
            if base_upper is not None:
                upper = np.minimum(upper, base_upper * scale)
            us.append(u)
            js.append(jobs * scale)
            ups.append(upper)
            labels.append(f"flex_mix{s}[batch x{mix:.2f}]")
        return ScenarioStack(usage=np.stack(us), jobs=np.stack(js),
                             upper=np.stack(ups), labels=tuple(labels))
