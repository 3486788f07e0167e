"""Grid carbon-intensity signals (paper §I, Fig. 1; §VI-F, Fig. 11).

The paper uses WattTime marginal carbon intensity (MCI) for CAISO 2021 and
NREL Cambium scenario projections for 2024/2050. Those datasets are not
redistributable, so this module synthesizes signals with the *published*
shape statistics:

  - CAISO 2021: diurnal "duck curve" — midday solar trough at ~66% of the
    evening peak (paper: "the trough can be as low as 66% of the peak in
    today's grid").
  - 2050 projection: trough at ~40% of peak (paper: "as low as 40% of the
    peak by 2050"), with some states reaching zero-MCI periods.

All series are hourly, in kg CO2 / MWh, deterministic given a seed.

For *online* operation, `ForecastStream` turns any realized series into a
sequence of revised day-ahead forecasts (persistence + lead-time noise, or
replayed snapshots) — the input signal of a rolling-horizon solver.

A numpy module, copied from the JAX package's `repro.core.carbon` so that
the port imports nothing of that package.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Sequence

import numpy as np

# Published anchor values (approximate CAISO 2021 marginal intensity range).
CAISO_2021_PEAK = 450.0   # kg CO2/MWh, evening ramp (gas at the margin)
CAISO_2021_TROUGH_FRAC = 0.66
PROJ_2024_TROUGH_FRAC = 0.55
PROJ_2050_TROUGH_FRAC = 0.40

#: US states used for the Fig.-11 style projection sweep (subset is fine —
#: the paper plots "all states"; we model the ones with distinct profiles).
STATES = (
    "CA", "TX", "WA", "AZ", "NV", "NM", "CO", "OR", "UT", "FL",
    "NY", "NC", "GA", "IL", "OH", "PA", "VA", "MA", "MN", "IA",
)


@dataclasses.dataclass(frozen=True)
class CarbonSignal:
    """An hourly marginal-carbon-intensity series.

    Attributes:
      mci: (hours,) kg CO2/MWh marginal carbon intensity.
      label: provenance string.
    """

    mci: np.ndarray
    label: str

    @property
    def hours(self) -> int:
        return int(self.mci.shape[0])

    def peak_to_trough(self) -> float:
        return float(self.mci.min() / self.mci.max())


def _duck_curve(hours: int, peak: float, trough_frac: float,
                solar_center: float = 13.0, solar_width: float = 4.5,
                evening_bump: float = 0.18,
                seed: int | tuple[int, ...] = 0,
                noise: float = 0.02) -> np.ndarray:
    """Synthesize a duck-curve MCI: solar depresses midday marginal intensity,
    evening ramp brings gas peakers to the margin."""
    rng = np.random.default_rng(seed)
    t = np.arange(hours)
    hour_of_day = t % 24
    # Solar depression: gaussian centered early afternoon.
    solar = np.exp(-0.5 * ((hour_of_day - solar_center) / solar_width) ** 2)
    # Evening ramp bump (gas peakers) ~19:00.
    evening = np.exp(-0.5 * ((hour_of_day - 19.0) / 2.0) ** 2)
    base = 1.0 - (1.0 - trough_frac) * solar + evening_bump * evening
    base = base / base.max()
    series = peak * base
    series = series * (1.0 + noise * rng.standard_normal(hours))
    return np.clip(series, 0.0, None)


def caiso_2021(hours: int = 48, seed: int = 0) -> CarbonSignal:
    """CAISO-2021-shaped MCI (paper Fig. 1 'Today'). Two-day default window
    matching the paper's evaluation interval (§VI-A)."""
    mci = _duck_curve(hours, CAISO_2021_PEAK, CAISO_2021_TROUGH_FRAC, seed=seed)
    return CarbonSignal(mci=mci, label="caiso-2021-synthetic")


def projection(year: int, state: str = "CA", hours: int = 48,
               seed: int = 0) -> CarbonSignal:
    """Cambium-style scenario MCI for `year` in {2024, 2050} (paper Fig. 11).

    Per-state variation: solar-heavy states get deeper troughs (some reach
    zero MCI by 2050, per the AEO-2023 analysis cited in the paper).

    Deterministic per (seed, year, state): the rng is tuple-seeded
    `default_rng((seed, year, state_idx))` — additive `seed + idx` seeding
    collided distinct (seed, state) pairs (e.g. seed=8/"NY" and
    seed=1/"MA") onto one stream, so scenario sweeps over states silently
    reused noise realizations. States outside `STATES` hash with crc32
    (stable across processes, unlike `hash()`) into an index range
    disjoint from the listed states'.
    """
    if year not in (2024, 2050):
        raise ValueError(f"unsupported projection year {year}")
    idx = STATES.index(state) if state in STATES \
        else len(STATES) + zlib.crc32(state.encode("utf-8"))
    rng = np.random.default_rng((seed, year, idx))
    # State-specific solar penetration in [0, 1]; CA/AZ/NV/NM highest.
    solar_rank = {"CA": .95, "AZ": .92, "NV": .9, "NM": .88, "TX": .8,
                  "UT": .75, "CO": .7, "FL": .68, "GA": .55, "NC": .5}
    pen = solar_rank.get(state, float(rng.uniform(0.3, 0.6)))
    if year == 2024:
        trough = 1.0 - (1.0 - PROJ_2024_TROUGH_FRAC) * pen
        peak = CAISO_2021_PEAK * 0.95
    else:
        trough = max(0.0, 1.0 - (1.0 - PROJ_2050_TROUGH_FRAC) * pen * 1.55)
        peak = CAISO_2021_PEAK * 0.85
    mci = _duck_curve(hours, peak, trough, solar_width=5.0,
                      seed=(seed, year, idx, 1))
    return CarbonSignal(mci=mci, label=f"cambium-{year}-{state}-synthetic")


#: Standard-time UTC offsets for the Cambium states: a UTC-clocked fleet
#: coordinator sees each region's solar trough `-offset` hours after the
#: local-time trace places it.
STATE_UTC_OFFSETS = {"CA": -8, "OR": -8, "WA": -8, "NV": -8,
                     "AZ": -7, "NM": -7, "UT": -7, "CO": -7,
                     "TX": -6, "MN": -6, "IA": -6, "IL": -6,
                     "NY": -5, "FL": -5, "NC": -5, "GA": -5,
                     "OH": -5, "PA": -5, "VA": -5, "MA": -5}


def regional_traces(states: Sequence[str], year: int = 2050,
                    hours: int = 48, seed: int = 0,
                    utc_offsets=None,
                    ) -> tuple[np.ndarray, tuple[str, ...]]:
    """(R, T) per-region MCI stack for a multi-region `FleetProblem`.

    One Cambium-style `projection` trace per state, stacked in order —
    the `mci` input of `fleet_solver.regional_fleet`. Depth decorrelation
    across regions comes free: each state's solar penetration and noise
    stream differ, so troughs land at different depths (CA near zero by
    2050, NY much flatter). *Timing* decorrelation comes from
    `utc_offsets`: projection traces are local-time, but a fleet
    coordinator schedules on one UTC clock, so pass `"auto"` (the
    `STATE_UTC_OFFSETS` table) or one offset per state to roll each
    trace onto UTC — CA's trough then lags NY's by three hours, which is
    what lets per-region pricing and migration beat any single shared
    signal. `None` (default) keeps the local-time alignment. Returns
    (mcis, labels).
    """
    if not states:
        raise ValueError("states must name at least one region")
    sigs = [projection(year, state=s, hours=hours, seed=seed)
            for s in states]
    mcis = np.stack([s.mci for s in sigs])
    if utc_offsets is not None:
        if isinstance(utc_offsets, str):
            if utc_offsets != "auto":
                raise ValueError(
                    f"utc_offsets must be 'auto', a sequence of "
                    f"{len(states)} ints, or None; got {utc_offsets!r}")
            utc_offsets = [STATE_UTC_OFFSETS.get(s, 0) for s in states]
        if len(utc_offsets) != len(states):
            raise ValueError(
                f"need one UTC offset per state ({len(states)}); got "
                f"{len(utc_offsets)}")
        # local hour h lands at UTC hour h - offset (offsets are negative
        # west of Greenwich), so roll each trace right by -offset
        mcis = np.stack([np.roll(m, -int(off))
                         for m, off in zip(mcis, utc_offsets)])
    return mcis, tuple(s.label for s in sigs)


# ---------------------------------------------------------------------------
# Grid-event hooks (scenario-ensemble building blocks, `repro.core.scenario`)
#
# Deterministic transforms of an hourly MCI series, each modelling one grid
# event the paper's single CAISO-2021 trace cannot express. Scenario
# generators randomize the event parameters (tuple-seeded rngs) and stack S
# transformed series for the vmapped ensemble runner.
# ---------------------------------------------------------------------------
def apply_drought(mci: np.ndarray, day: int, n_days: int = 1,
                  severity: float = 0.7, day_hours: int = 24) -> np.ndarray:
    """Renewable-drought days: fill the midday solar trough back in.

    For `n_days` days starting at `day`, each hour's MCI is lifted toward
    that day's running peak by `severity` (1.0 = no solar at all, the
    trough disappears; 0.0 = no event). Models multi-day wind/solar
    droughts ("dunkelflaute") where gas stays at the margin all day.
    """
    out = np.asarray(mci, float).copy()
    for d in range(day, min(day + n_days, -(-out.shape[0] // day_hours))):
        sl = slice(d * day_hours, min((d + 1) * day_hours, out.shape[0]))
        peak = out[sl].max()
        out[sl] = out[sl] + severity * (peak - out[sl])
    return out


def apply_evening_spike(mci: np.ndarray, hour: int, magnitude: float = 1.4,
                        width: float = 2.0) -> np.ndarray:
    """Evening-ramp spike: multiply MCI by a gaussian bump centred at
    `hour` (absolute hour index), peaking at `magnitude`. Models a steeper
    ramp than forecast — peakers brought online hard."""
    t = np.arange(np.asarray(mci).shape[0], dtype=float)
    bump = 1.0 + (magnitude - 1.0) * np.exp(
        -0.5 * ((t - hour) / max(width, 1e-6)) ** 2)
    return np.asarray(mci, float) * bump


def apply_zero_window(mci: np.ndarray, start: int, length: int,
                      ) -> np.ndarray:
    """Zero-MCI window: clamp hours [start, start+length) to zero marginal
    intensity — curtailed renewables on the margin (the 2050
    deep-decarbonization grids of Fig. 11 reach this today in CAISO
    spring)."""
    out = np.asarray(mci, float).copy()
    out[max(start, 0):max(start, 0) + max(length, 0)] = 0.0
    return out


# ---------------------------------------------------------------------------
# Streaming forecasts (rolling-horizon operation, ROADMAP "Streaming MCI")
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ForecastStream:
    """Revised MCI forecasts over a sliding horizon — the online DR signal.

    At tick `t` (one tick = one hour), `forecast(t)` returns the current
    `(horizon,)` day-ahead MCI estimate for hours `[t, t + horizon)`;
    `realized(t)` is the actual MCI of hour `t`, known only once it has
    elapsed. Two modes:

      * revision model (default): persistence + lead-time noise over the
        `actual` series — the hour about to be committed is known almost
        exactly, while hours `k` ahead carry multiplicative error growing
        as `revision_sigma * sqrt(k)` (forecast skill decays with lead
        time, the shape WattTime/Cambium day-ahead products exhibit).
        Deterministic given `seed`: re-asking for tick t re-issues the
        *same* revised forecast.
      * replay (`replay=(n_ticks, horizon)` array): serve pre-recorded
        forecast snapshots verbatim — for backtesting against logged
        forecast revisions.
    """

    actual: np.ndarray                 # (n_hours,) realized MCI
    horizon: int = 48                  # forecast window length T
    revision_sigma: float = 0.03       # per-sqrt-hour multiplicative error
    # Tuple seeds namespace one revision model across several streams
    # (`regional` issues (seed, r) per region); a plain int is the
    # single-stream case and keeps its exact historical noise draws.
    seed: int | tuple[int, ...] = 0
    replay: np.ndarray | None = None   # (n_ticks, horizon) snapshots

    def __post_init__(self):
        if self.replay is not None:
            r = np.asarray(self.replay)
            if r.ndim != 2 or r.shape[1] != self.horizon:
                raise ValueError(
                    f"replay must be (n_ticks, horizon={self.horizon}); "
                    f"got {r.shape}")

    @property
    def n_ticks(self) -> int:
        """Ticks for which a full horizon (and its realized hour) exist.

        Replay mode is clamped to `len(actual)`: a stream carrying more
        forecast snapshots than realized hours would otherwise let
        `forecast()` succeed on ticks whose `realized()` hour does not
        exist, crashing the control loop mid-run with an IndexError."""
        if self.replay is not None:
            return min(int(np.asarray(self.replay).shape[0]),
                       int(np.asarray(self.actual).shape[0]))
        return max(0, int(self.actual.shape[0]) - self.horizon + 1)

    def forecast(self, tick: int) -> np.ndarray:
        """(horizon,) MCI forecast issued at `tick` for [tick, tick+T)."""
        if not 0 <= tick < self.n_ticks:
            raise IndexError(f"tick {tick} out of range [0, {self.n_ticks})")
        if self.replay is not None:
            return np.asarray(self.replay[tick], dtype=float).copy()
        window = np.asarray(self.actual[tick:tick + self.horizon], float)
        key = (self.seed,) if isinstance(self.seed, int) \
            else tuple(self.seed)
        rng = np.random.default_rng(key + (tick,))
        # sqrt-lead error growth with a small nowcast floor: even the hour
        # being committed is a forecast, not a meter reading.
        lead = np.arange(self.horizon, dtype=float)
        err = (self.revision_sigma * np.sqrt(lead + 0.25)
               * rng.standard_normal(self.horizon))
        return np.clip(window * (1.0 + err), 0.0, None)

    def realized(self, tick: int) -> float:
        """Actual MCI of hour `tick` (available once the hour elapses)."""
        if not 0 <= tick < int(np.asarray(self.actual).shape[0]):
            raise IndexError(
                f"tick {tick} has no realized hour (actual covers "
                f"[0, {int(np.asarray(self.actual).shape[0])}))")
        return float(self.actual[tick])

    @classmethod
    def caiso(cls, n_ticks: int, horizon: int = 48,
              revision_sigma: float = 0.03, seed: int = 0,
              ) -> "ForecastStream":
        """Stream over a CAISO-2021-shaped actual series long enough for
        `n_ticks` rolling solves of `horizon` hours each."""
        sig = caiso_2021(hours=n_ticks + horizon, seed=seed)
        return cls(actual=sig.mci, horizon=horizon,
                   revision_sigma=revision_sigma, seed=seed)

    @classmethod
    def regional(cls, actuals: np.ndarray, horizon: int = 48,
                 revision_sigma: float = 0.03, seed: int = 0,
                 ) -> tuple["ForecastStream", ...]:
        """R streams over an (R, n_hours) actual stack, sharing ONE
        revision model: every stream carries the same sigma/horizon and a
        `(seed, r)` tuple seed off one base seed, instead of R
        copy-pasted configs whose int seeds can collide between regions.
        The input of a multi-region `RollingHorizonSolver`."""
        actuals = np.asarray(actuals, float)
        if actuals.ndim != 2:
            raise ValueError(f"actuals must be (R, n_hours); got "
                             f"{actuals.shape}")
        return tuple(
            cls(actual=actuals[r], horizon=horizon,
                revision_sigma=revision_sigma, seed=(seed, r))
            for r in range(actuals.shape[0]))


def carbon_footprint_delta(mci: np.ndarray, adjustments: np.ndarray) -> float:
    """Change in operational carbon from adjustment matrix D (paper §V).

    CF(D) = - <mci, sum_i d_i>  — positive d (curtailment) *reduces* carbon,
    so the change in footprint is negative. We return the (signed) footprint
    change; use `carbon_reduction` for the positive-is-better quantity.

    Args:
      mci: (T,) marginal carbon intensity.
      adjustments: (W, T) or (T,) power adjustments in NP (positive=curtail).
    """
    d = np.asarray(adjustments)
    total = d.sum(axis=0) if d.ndim == 2 else d
    return float(-(np.asarray(mci) * total).sum())


def carbon_reduction(mci: np.ndarray, adjustments: np.ndarray) -> float:
    """Operational carbon eliminated by D (positive is better)."""
    return -carbon_footprint_delta(mci, adjustments)
