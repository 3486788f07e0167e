"""Fleet-scale DR data model and the plumbing the policies share.

Every workload's penalty model is stacked into arrays,

  RTS:    C_i = k_i Σ_t f(a_i; d/U)            (cubic polynomial)
  batch:  C_i = (k_i (β₀ + β₁ x₁ + β₂ x₂))⁺    (Table-IV features)

so the whole fleet evaluates as a handful of (W, T) tensor ops, with the
Table-IV features from the `dr_features` kernel on the card.

`FleetProblem` holds numpy fields, as in the JAX package. A solve makes
its float32 tensors once, on the chosen device (`device_view`); the
functions here take either form and compute on the device of the tensors
they are given (numpy fields count as the CPU).

Multi-region fleets stack per-region signals as `mci` (R, T) and give
every workload a region id; `regional_fleet` composes one from R
single-region fleets and `RegionTopology` adds the migration network
(`core/migration.py`). R = 1 is canonicalized to the single-region form
at the entry points (`single_region_view`), as in the JAX package. A
multi-region device view carries its `RegionIndex`, each region's rows
found once on the host, so that per-region sums need no host sync.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import features as feat
from repro_torch.core.engine import EngineState
from repro_torch.core.penalty import PenaltyModel
from repro_torch.kernels.dispatch import resolve_device, resolve_use_kernel

Tensor = torch.Tensor
f32 = torch.float32

# Initial AL penalty weights per policy.
CR1_MU0 = 10.0
CR2_MU0 = 10.0
CR3_MU0 = 0.01


@dataclasses.dataclass(frozen=True)
class RegionTopology:
    """Cross-region migration network for a multi-region fleet.

    All matrices are indexed [from_region, to_region]. `bandwidth` caps
    how much deferrable load (NP) can move over a link per hour; zero
    (the diagonal is ignored) disables the link, so `bandwidth=0`
    everywhere reduces the fleet to independent per-region solves. `cost`
    is the carbon toll per unit moved, subtracted from the migration
    margin. `ceiling` is an optional per-region power cap (R,) or (R, T)
    on what a region can absorb on top of its own load; None means
    uncapped. Host numpy: the migration stages read it (`core/migration`),
    the per-row solve never does.
    """
    cost: np.ndarray                    # (R, R)
    bandwidth: np.ndarray               # (R, R)
    ceiling: np.ndarray | None = None   # (R,) or (R, T)
    labels: tuple[str, ...] | None = None

    @property
    def R(self) -> int:
        return np.asarray(self.cost).shape[0]

    def validate(self, R: int, T: int) -> None:
        cost = np.asarray(self.cost)
        bw = np.asarray(self.bandwidth)
        if cost.shape != (R, R) or bw.shape != (R, R):
            raise ValueError(
                f"RegionTopology cost/bandwidth must be ({R}, {R}); got "
                f"{cost.shape} / {bw.shape}")
        if self.ceiling is not None:
            ceil = np.asarray(self.ceiling)
            if ceil.shape not in ((R,), (R, T)):
                raise ValueError(
                    f"RegionTopology ceiling must be ({R},) or ({R}, {T}); "
                    f"got {ceil.shape}")
        if self.labels is not None and len(self.labels) != R:
            raise ValueError(
                f"RegionTopology labels must have {R} entries; got "
                f"{len(self.labels)}")


class RegionIndex(NamedTuple):
    """Each region's rows of a multi-region fleet, found once on the host
    (`region_index`): per-region sums gather them with `index_select`,
    which needs no host sync and so runs inside a CUDA-graph capture."""
    order: Tensor             #: (W,) int64 row ids by region, ascending
    counts: tuple[int, ...]   #: each region's row count (fixed by shape)

    def rows(self) -> tuple[Tensor, ...]:
        """Each region's row ids, ascending: views of `order`."""
        return torch.split(self.order, self.counts)


def region_index(region, R: int, device) -> RegionIndex:
    """The `RegionIndex` of host region ids (W,) in [0, R)."""
    region = np.asarray(region)
    order = np.argsort(region, kind="stable")
    counts = np.bincount(region, minlength=R)
    return RegionIndex(torch.as_tensor(order, dtype=torch.int64,
                                       device=device),
                       tuple(int(c) for c in counts))


@dataclasses.dataclass(frozen=True)
class FleetProblem:
    """Stacked-workload DR instance.

    Single-region fleets have `mci: (T,)` and `region is None`.
    Multi-region fleets stack per-region signals as `mci: (R, T)` and give
    every workload a region via `region: (W,) int`; an optional `topology`
    adds the cross-region migration network. A device view
    (`device_view`) of a multi-region fleet carries `region` as a tensor
    and its `region_index`.
    """
    usage: np.ndarray          # (W, T)
    entitlement: np.ndarray    # (W,)
    k: np.ndarray              # (W,)
    rts_coeffs: np.ndarray     # (W, 3) a3,a2,a1 (zeros for batch)
    betas: np.ndarray          # (W, 3) β0,β1,β2 (zeros for RTS)
    x2_kind: np.ndarray        # (W,) 0=num_jobs_delayed, 1=waiting_sq
    jobs: np.ndarray           # (W, T)
    is_batch: np.ndarray       # (W,) bool
    mci: np.ndarray            # (T,) or (R, T) per-region
    day_hours: int = 24
    max_curtail_frac: float = 0.5
    names: tuple[str, ...] | None = None
    # Optional (W, T) operational cap on curtailment, intersected with the
    # entitlement/usage box.
    upper: np.ndarray | None = None
    # Multi-region fields: per-workload region ids (W,) in [0, R) and the
    # optional migration network. None for single-region fleets.
    region: np.ndarray | None = None
    topology: RegionTopology | None = None
    # Each region's rows on the device (`device_view` of a multi-region
    # fleet); None on the host.
    region_index: RegionIndex | None = None

    @property
    def W(self) -> int:
        return self.usage.shape[0]

    @property
    def T(self) -> int:
        return self.usage.shape[1]

    @property
    def R(self) -> int:
        """Number of regions (1 for single-region problems)."""
        return np.shape(self.mci)[0] if self.is_multiregion else 1

    @property
    def is_multiregion(self) -> bool:
        return np.ndim(self.mci) == 2

    @classmethod
    def from_problem(cls, p) -> "FleetProblem":
        """Stack a per-workload `DRProblem` (`core/policies.py`) into the
        fleet representation.

        The fleet path implements the default DRProblem subset: equality
        day-preservation, curtail-only RTS, and no datacenter capacity
        inequality (Eq. 10, never active for the paper fleet's 1.2
        buffer). Other `preservation`/`rts_boost` settings would silently
        change meaning here, so they are rejected."""
        if p.preservation != "equality" or p.rts_boost:
            raise ValueError(
                "FleetProblem supports preservation='equality' and "
                f"rts_boost=False only (got preservation={p.preservation!r},"
                f" rts_boost={p.rts_boost})")
        return from_models(p.models, p.mci, day_hours=p.day_hours,
                           max_curtail_frac=p.max_curtail_frac)

    def to_problem(self, **overrides):
        """Rebuild the per-workload `DRProblem` (the SLSQP reference's
        view); `overrides` replace its fields."""
        from repro_torch.core.policies import DRProblem
        if self.is_multiregion:
            raise ValueError(
                "to_problem() needs a single-region fleet (mci (T,)); the "
                "per-workload SLSQP reference has no region concept")
        names = self.names or tuple(f"w{i}" for i in range(self.W))
        models = []
        for i in range(self.W):
            common = dict(name=names[i], usage=np.asarray(self.usage[i]),
                          entitlement=float(self.entitlement[i]),
                          k=float(self.k[i]))
            if bool(self.is_batch[i]):
                slo = float(self.x2_kind[i]) > 0.5
                models.append(PenaltyModel(
                    kind="batch_slo" if slo else "batch_noslo",
                    params=tuple(float(b) for b in self.betas[i]),
                    jobs=np.asarray(self.jobs[i]),
                    feature_names=("waiting_time_power",
                                   "waiting_time_squared" if slo
                                   else "num_jobs_delayed"), **common))
            else:
                models.append(PenaltyModel(
                    kind="realtime",
                    params=tuple(float(a) for a in self.rts_coeffs[i]),
                    **common))
        kw = dict(models=tuple(models), mci=np.asarray(self.mci),
                  max_curtail_frac=self.max_curtail_frac,
                  day_hours=self.day_hours)
        kw.update(overrides)
        return DRProblem(**kw)


DATA_FIELDS = ("usage", "entitlement", "k", "rts_coeffs", "betas",
               "x2_kind", "jobs", "is_batch", "mci", "upper", "region")


def device_view(p: FleetProblem, device: torch.device) -> FleetProblem:
    """The same problem with float32 tensor fields on `device` (bool
    `is_batch`, int64 `region`, `mci` (T,) or (R, T)), made once per
    solve, and a multi-region fleet's `region_index`; `names` dropped,
    the host `topology` kept."""
    def conv(name, a):
        if a is None:
            return None
        dtype = {"is_batch": torch.bool, "region": torch.int64}.get(name, f32)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    index = None if p.region is None else region_index(p.region, p.R, device)
    return dataclasses.replace(
        p, names=None, region_index=index,
        **{n: conv(n, getattr(p, n)) for n in DATA_FIELDS})


#: Inert-row fill value per FleetProblem field (`pad_fleet`), the JAX
#: package's values; see `pad_fleet` for why usage is 0.01.
PAD_FILLS: dict[str, float] = {
    "usage": 0.01, "entitlement": 1.0, "k": 0.0, "rts_coeffs": 0.0,
    "betas": 0.0, "x2_kind": 0.0, "jobs": 1.0, "is_batch": False,
    "upper": 0.0, "region": 0,
}

#: The per-workload fields: a row block takes these rows (`row_block`).
ROW_FIELDS = tuple(f for f in DATA_FIELDS if f != "mci")


def pad_fleet(p: FleetProblem, multiple: int) -> tuple[FleetProblem, int]:
    """Pad W up to a multiple of `multiple` with inert workloads (host
    numpy fields in, host numpy fields out).

    Pad rows get usage 0.01 NP, entitlement 1, k 0 and an operational cap
    (`upper`) of 0: their box is [0, 0], so the projection pins them at
    zero curtailment, their penalties and penalty gradients are exactly
    zero (k = 0 with finite features), and every division the policies
    make (by entitlement, by usage, by tau = 0.02·E) stays finite. The
    tiny usage keeps CR3's smooth peak (tau·logsumexp(usage/tau) ≈ 0.09·E
    at D = 0) well inside the pad rows' allowance for any tax_frac below
    ~0.9, so their allowance multipliers stay exactly zero, across
    chained warm re-solves too. `upper` is materialized (+inf where the
    fleet had none); `names` and `topology` are dropped. Returns (padded
    problem, true W): reports and fiscal sums take rows [:W]."""
    pad = (-p.W) % multiple
    upper = np.asarray(p.upper, float) if p.upper is not None \
        else np.full(np.shape(p.usage), np.inf)
    if pad == 0:
        return dataclasses.replace(p, upper=upper, names=None,
                                   topology=None, region_index=None), p.W

    def rows(field, a=None):
        a = np.asarray(getattr(p, field) if a is None else a)
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], PAD_FILLS[field],
                        dtype=a.dtype)])

    return dataclasses.replace(
        p, usage=rows("usage"), entitlement=rows("entitlement"),
        k=rows("k"), rts_coeffs=rows("rts_coeffs"), betas=rows("betas"),
        x2_kind=rows("x2_kind"), jobs=rows("jobs"),
        is_batch=rows("is_batch"), upper=rows("upper", upper),
        region=None if p.region is None else rows("region"),
        names=None, topology=None, region_index=None), p.W


def _pad_state(state: EngineState, W_pad: int) -> EngineState:
    """Zero-pad a warm start's per-workload leaves (x, and the multipliers
    with one entry a row) to the padded W; the state itself when it is
    already padded, so a sharded result's state chains as it is."""
    W = state.x.shape[0]
    if W == W_pad:
        return state

    def pad(a: Tensor) -> Tensor:
        if a.dim() and a.shape[0] == W:
            tail = torch.zeros((W_pad - W,) + tuple(a.shape[1:]),
                               dtype=a.dtype, device=a.device)
            return torch.cat([a, tail])
        return a

    return EngineState(x=pad(state.x), lam_eq=pad(state.lam_eq),
                       lam_in=pad(state.lam_in), mu=state.mu)


def row_block(p: FleetProblem, rank: int, world: int) -> FleetProblem:
    """Block `rank` of `world` equal contiguous row blocks of a padded
    problem (host or device view): every per-workload field's rows, the
    carbon trace replicated. A multi-region device view's block gets the
    `RegionIndex` of its own rows."""
    if p.W % world:
        raise ValueError(f"row_block needs W ({p.W}) divisible by the "
                         f"block count {world}: pad_fleet first")
    n = p.W // world
    sl = slice(rank * n, (rank + 1) * n)
    out = dataclasses.replace(p, names=None, **{
        f: None if getattr(p, f) is None else getattr(p, f)[sl]
        for f in ROW_FIELDS})
    if p.region_index is not None:
        out = dataclasses.replace(out, region_index=region_index(
            out.region.cpu().numpy(), p.R, out.region.device))
    return out


def single_region_view(p: FleetProblem) -> FleetProblem:
    """Canonicalize the degenerate R = 1 problem to the single-region form
    (mci (T,), no region or topology), so that it takes the single-region
    code path bit for bit; a (T,) problem drops stray region fields too.
    Everything else passes through."""
    if p.is_multiregion and np.asarray(p.mci).shape[0] == 1:
        return dataclasses.replace(p, mci=np.asarray(p.mci)[0], region=None,
                                   topology=None, region_index=None)
    if not p.is_multiregion and (p.region is not None
                                 or p.topology is not None):
        return dataclasses.replace(p, region=None, topology=None,
                                   region_index=None)
    return p


def from_models(models: Sequence[PenaltyModel], mci: np.ndarray,
                day_hours: int = 24, max_curtail_frac: float = 0.5,
                ) -> FleetProblem:
    W = len(models)
    T = mci.shape[0]
    usage = np.stack([m.usage for m in models])
    ent = np.asarray([m.entitlement for m in models])
    k = np.asarray([m.k for m in models])
    rts = np.zeros((W, 3))
    betas = np.zeros((W, 3))
    x2k = np.zeros(W)
    jobs = np.ones((W, T))
    is_batch = np.zeros(W, bool)
    for i, m in enumerate(models):
        if m.kind == "realtime":
            rts[i] = m.params
        else:
            is_batch[i] = True
            betas[i] = m.params
            jobs[i] = m.jobs
            x2k[i] = 1.0 if m.feature_names[1] == "waiting_time_squared" \
                else 0.0
    return FleetProblem(usage=usage, entitlement=ent, k=k, rts_coeffs=rts,
                        betas=betas, x2_kind=x2k, jobs=jobs,
                        is_batch=is_batch, mci=mci, day_hours=day_hours,
                        max_curtail_frac=max_curtail_frac,
                        names=tuple(m.name for m in models))


def synthetic_fleet(num: int, hours: int = 48, seed: int = 0,
                    templates: dict[str, PenaltyModel] | None = None,
                    device: str | torch.device | None = None,
                    ) -> FleetProblem:
    """Clone the calibrated paper models into a fleet of `num` workloads
    with randomized scales/mix, the scaling benchmarks' input. Without
    `templates`, the paper fleet is built (or read from the cache) on
    `device`."""
    from repro_torch.core.carbon import caiso_2021
    from repro_torch.core.fleetcache import cached_paper_fleet
    templates = templates or cached_paper_fleet(hours=hours, device=device)
    rng = np.random.default_rng(seed)
    names = list(templates)
    models = []
    for i in range(num):
        base = templates[names[i % len(names)]]
        scale = float(rng.uniform(0.2, 3.0))
        models.append(dataclasses.replace(
            base, name=f"{base.name}-{i}", usage=base.usage * scale,
            entitlement=base.entitlement * scale,
            jobs=None if base.jobs is None else base.jobs * scale))
    return from_models(models, caiso_2021(hours).mci)


def regional_fleet(fleets: Sequence[FleetProblem], mcis: np.ndarray,
                   topology: RegionTopology | None = None) -> FleetProblem:
    """Concatenate R single-region fleets into one (region × workload)
    fleet: `fleets[r]` supplies region r's workloads (its own `mci` is
    ignored) and `mcis` is the (R, T) signal stack (e.g.
    `carbon.regional_traces`). Rows stay region-sorted; names become
    `label/name`; `upper` is filled with +inf where only some fleets have
    one."""
    mcis = np.asarray(mcis, float)
    R = len(fleets)
    if mcis.ndim != 2 or mcis.shape[0] != R:
        raise ValueError(
            f"mcis must be ({R}, T) — one trace per fleet; got {mcis.shape}")
    T = mcis.shape[1]
    if any(f.T != T for f in fleets):
        raise ValueError("every regional fleet must share the trace length")
    if any(f.is_multiregion for f in fleets):
        raise ValueError("regional_fleet composes single-region fleets")
    if topology is not None:
        topology.validate(R, T)

    def cat(field):
        parts = [getattr(f, field) for f in fleets]
        if any(a is None for a in parts):
            if all(a is None for a in parts):
                return None
            parts = [np.asarray(a, float) if a is not None
                     else np.full(f.usage.shape, np.inf)
                     for f, a in zip(fleets, parts)]
        return np.concatenate([np.asarray(a) for a in parts])

    names = None
    if all(f.names is not None for f in fleets):
        labels = topology.labels if topology is not None \
            and topology.labels is not None else tuple(range(R))
        names = tuple(f"{labels[r]}/{n}"
                      for r, f in enumerate(fleets) for n in f.names)
    region = np.concatenate(
        [np.full(f.W, r, np.int32) for r, f in enumerate(fleets)])
    return FleetProblem(
        usage=cat("usage"), entitlement=cat("entitlement"), k=cat("k"),
        rts_coeffs=cat("rts_coeffs"), betas=cat("betas"),
        x2_kind=cat("x2_kind"), jobs=cat("jobs"), is_batch=cat("is_batch"),
        mci=mcis, day_hours=fleets[0].day_hours,
        max_curtail_frac=fleets[0].max_curtail_frac, names=names,
        upper=cat("upper"), region=region, topology=topology)


def synthetic_regional_fleet(num: int, states: Sequence[str],
                             hours: int = 48, seed: int = 0,
                             year: int = 2050,
                             topology: RegionTopology | None = None,
                             utc_offsets=None,
                             templates: dict[str, PenaltyModel] | None = None,
                             device: str | torch.device | None = None,
                             ) -> FleetProblem:
    """`synthetic_fleet` across R Cambium state mixes: ~num/R workloads
    per region (region r drawn with seed + r), each region priced on its
    own `carbon.projection` trace (`utc_offsets` passes through to
    `carbon.regional_traces`; "auto" rolls each trace onto UTC). Default
    topology: uniform bandwidth at 5 % of fleet entitlement with a toll of
    2 per unit moved. `templates` and `device` as `synthetic_fleet`."""
    from repro_torch.core.carbon import regional_traces
    from repro_torch.core.fleetcache import cached_paper_fleet
    R = len(states)
    mcis, _ = regional_traces(states, year=year, hours=hours, seed=seed,
                              utc_offsets=utc_offsets)
    templates = templates or cached_paper_fleet(hours=hours, device=device)
    per = [num // R + (1 if r < num % R else 0) for r in range(R)]
    fleets = [synthetic_fleet(per[r], hours=hours, seed=seed + r,
                              templates=templates) for r in range(R)]
    if topology is None:
        ent = float(sum(np.asarray(f.entitlement).sum() for f in fleets))
        bw = np.full((R, R), 0.05 * ent / max(R - 1, 1))
        np.fill_diagonal(bw, 0.0)
        topology = RegionTopology(
            cost=np.full((R, R), 2.0), bandwidth=bw, labels=tuple(states))
    return regional_fleet(fleets, mcis, topology=topology)


def _features(d: Tensor, usage: Tensor, jobs: Tensor,
              use_kernel: bool) -> Tensor:
    """(..., W, 4): wait_jobs, wait_power, wait_sq, njobs (Table IV). The
    plain path uses `torch.maximum` for JAX's 0.5 tie gradient. Lanes
    ((N, W, T) plans; usage and jobs shared or per lane) go through the
    kernel as N·W stacked rows, one launch: a row's features depend on
    that row alone."""
    if use_kernel:
        from repro_torch.kernels.dr_features.ops import dr_features
        if d.dim() == 2:
            return dr_features(d, usage, jobs)
        T = d.shape[-1]
        rows = [a.expand(d.shape).reshape(-1, T) for a in (d, usage, jobs)]
        return dr_features(*rows).reshape(d.shape[:-1] + (4,))
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    rate = feat.jobs_rate(d, usage, jobs)
    wait_jobs = torch.maximum(torch.cumsum(rate, dim=-1), zero).sum(-1)
    wait_power = torch.maximum(torch.cumsum(d, dim=-1), zero).sum(-1)
    rate_sq = feat.squared_rate(d, usage, jobs)
    wait_sq = torch.maximum(torch.cumsum(rate_sq, dim=-1), zero).sum(-1)
    njobs = (jobs * torch.maximum(d, zero) / usage).sum(-1)
    return torch.stack([wait_jobs, wait_power, wait_sq, njobs], dim=-1)


def fleet_penalties(p: FleetProblem, D: Tensor,
                    use_kernel: bool | None = None) -> Tensor:
    """(W,) calibrated penalties, fully vectorized, on D's device. With
    lanes, D is (N, W, T) and the result (N, W); `p`'s usage, jobs (and
    entitlement) may then lead with N too."""
    use_kernel = resolve_use_kernel(use_kernel, D.device)

    def t(a, dtype=f32):
        return torch.as_tensor(a, dtype=dtype, device=D.device)

    usage = t(p.usage)
    delta = D / usage
    rts = t(p.rts_coeffs)
    a3, a2, a1 = (rts[:, i:i + 1] for i in range(3))
    f_rts = (a3 * delta**3 + a2 * delta**2 + a1 * delta).sum(dim=-1)
    X = _features(D, usage, t(p.jobs), use_kernel)
    x1 = X[..., 1]
    x2 = torch.where(t(p.x2_kind) > 0.5, X[..., 2], X[..., 3])
    b = t(p.betas)
    z = b[:, 0] + b[:, 1] * x1 + b[:, 2] * x2
    f_batch = torch.maximum(z, torch.zeros_like(z))
    raw = torch.where(t(p.is_batch, torch.bool), f_batch, f_rts)
    return t(p.k) * raw


def cr2_cap_plan(p: FleetProblem, cap_frac: float) -> np.ndarray:
    """(W, T) curtailment of a hypothetical equal power cap at cap_frac·E,
    max(U − cap_frac·E, 0), in float64 numpy: CR2's fairness targets are
    its penalties."""
    L = cap_frac * np.asarray(p.entitlement)[:, None]
    return np.maximum(np.asarray(p.usage) - L, 0.0)


def cr2_reference_fleet(p: FleetProblem, cap_frac: float,
                        device: str | torch.device | None = None,
                        ) -> np.ndarray:
    """C_i under a hypothetical equal power cap at cap_frac·E: CR2's
    fairness targets. The cap is taken in float64 numpy, the penalties in
    float32 on `device` (None = the CUDA device; the kernel runs there)."""
    device = resolve_device(device)
    D = torch.as_tensor(cr2_cap_plan(p, cap_frac), dtype=f32, device=device)
    return cr2_reference_tensor(p, D).cpu().numpy()


def cr2_reference_tensor(p: FleetProblem, cap_plan: Tensor) -> Tensor:
    """The device twin of `cr2_reference_fleet`: the (W,) targets as a
    float32 tensor on `cap_plan`'s device, with no round trip through the
    host, so that a CUDA graph can hold it. `cap_plan` is `cr2_cap_plan`
    of the window in float32 (a day rolls it with the window, which gives
    every tick the float64 cap that `solve()` takes); the kernel runs
    wherever the device has it, as in `cr2_reference_fleet`."""
    return fleet_penalties(p, cap_plan)


def _enter_tick(state: EngineState, shift: int, reset_mu: bool,
                mu0: float) -> EngineState:
    """Streaming-tick entry: roll the plan `shift` hours and restart the
    mu schedule at the policy's mu0 (multipliers keep their prices)."""
    if shift:
        state = state.shifted(shift)
    if reset_mu:
        state = dataclasses.replace(state, mu=torch.full_like(state.mu, mu0))
    return state


@dataclasses.dataclass(frozen=True)
class FleetSolveResult:
    """Uniform result of one fleet policy solve."""
    D: np.ndarray
    carbon_reduction_pct: float
    total_penalty_pct: float
    iters: int
    preservation_violation: float
    # Reusable engine carry for warm-started re-solves (rolling horizon).
    state: EngineState | None = None
    # Policy-specific outputs. CR3's fiscal clearing (Eq. 6) reports
    # "rho" (the clearing carbon price), "balanced" (did taxes cover
    # rebates) and "fiscal_deficit" (rebates − taxes when they did not,
    # NP·kgCO2/MWh); the other policies leave it empty.
    extras: dict = dataclasses.field(default_factory=dict)

    @property
    def balanced(self) -> bool:
        """CR3's Eq.-6 clearing converged (always True for the others)."""
        return bool(self.extras.get("balanced", True))

    @property
    def fiscal_deficit(self) -> float:
        """Rebates − taxes left when clearing failed (0.0 when balanced)."""
        return float(self.extras.get("fiscal_deficit", 0.0))


def _bounds(p: FleetProblem) -> tuple[Tensor, Tensor]:
    """Box bounds: curtail ≤ min(frac·E, U); batch may boost to U−d ≤ E.
    An operational `p.upper` cap tightens the curtail side further.
    Lane-stacked fields ((N, W, T) usage, (N, W) entitlement) give
    (N, W, T) bounds. An hour whose batch usage exceeds what the cap can
    bring under E (U − E > hi: an overload, as FleetJitter draws) gets
    lo = hi, the point a clip to [U − E, hi] takes; the exact day
    projection, kernel and plain version alike, needs lo ≤ hi."""
    usage = torch.as_tensor(p.usage, dtype=f32)
    E = torch.as_tensor(p.entitlement, dtype=f32,
                        device=usage.device)[..., None]
    hi = torch.minimum(p.max_curtail_frac * E, usage)
    if p.upper is not None:
        hi = torch.minimum(hi, torch.as_tensor(p.upper, dtype=f32,
                                               device=usage.device))
    isb = torch.as_tensor(p.is_batch, dtype=torch.bool, device=usage.device)
    lo = torch.where(isb[:, None], -(E - usage), torch.zeros_like(usage))
    return torch.minimum(lo, hi), hi


def _day_shift(Y: Tensor, L: Tensor, H: Tensor) -> Tensor:
    """The shift τ, (..., 1), with Σ clip(Y − τ, L, H) = 0 along the last
    axis. The sum falls piecewise-linearly in τ: past a kink Y − H an hour
    leaves its upper bound, past Y − L it reaches its lower one, and in
    between the sum falls by the number of free hours per unit of τ. The
    sorted kinks give the segment where the sum crosses zero; τ is then
    solved on that segment's free hours. A day whose bounds cannot sum to
    zero ends with every hour at its upper or every hour at its lower
    bound (the clip then saturates whatever τ is)."""
    n = Y.shape[-1]
    B, idx = torch.sort(torch.cat([Y - H, Y - L], dim=-1), dim=-1)
    n_free = torch.cumsum(torch.where(idx < n, 1, -1), dim=-1)
    drop = torch.cumsum(n_free[..., :-1] * torch.diff(B, dim=-1), dim=-1)
    G = H.sum(-1, keepdim=True) - torch.cat(
        [torch.zeros_like(drop[..., :1]), drop], dim=-1)
    k = ((G >= 0).sum(-1, keepdim=True) - 1).clamp(0, 2 * n - 2)
    mid = 0.5 * (B.gather(-1, k) + B.gather(-1, k + 1))
    at_hi, at_lo = Y - H >= mid, Y - L <= mid
    held = torch.where(at_hi, H, torch.where(at_lo, L, Y))
    cnt = (~(at_hi | at_lo)).sum(-1, keepdim=True)
    return torch.where(cnt > 0, held.sum(-1, keepdim=True)
                       / cnt.clamp(min=1).to(Y.dtype), B.gather(-1, k))


def project_days(x: Tensor, lo: Tensor, hi: Tensor, is_batch: Tensor,
                 day_hours: int) -> Tensor:
    """Euclidean projection onto the box ∩ {every whole day of a batch row
    sums to 0}: clip(x − τ, lo, hi) with one shift τ per batch row and day
    (`_day_shift`). RTS rows (`is_batch` (W,) false), and hours past the
    last whole day, are only clipped; a horizon under a day is one day.
    Lanes: x (N, W, T), with lo and hi (W, T) or (N, W, T), is projected
    as N·W rows."""
    W, T = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    day_hours = min(day_hours, T)
    n_days = T // day_hours
    span = n_days * day_hours
    lo, hi = lo.expand(x.shape), hi.expand(x.shape)
    y, L, H = (a[..., :span].reshape(lead + (W, n_days, day_hours))
               for a in (x, lo, hi))
    tau = torch.where(is_batch.reshape(W, 1, 1), _day_shift(y, L, H),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    days = torch.clamp(y - tau, L, H).reshape(lead + (W, span))
    return torch.cat([days, torch.clamp(x[..., span:], lo[..., span:],
                                        hi[..., span:])], dim=-1)


def _projection(p: FleetProblem, lo: Tensor, hi: Tensor):
    """The projection after every step (`project_days`). The JAX package
    takes a box clip and 3 rounds of day-mean removal instead, which stops
    short of the day sums where bounds are active."""
    is_batch = torch.as_tensor(p.is_batch, dtype=torch.bool,
                               device=lo.device)
    return lambda D: project_days(D, lo, hi, is_batch, p.day_hours)


def _mean_projection(p: FleetProblem, lo: Tensor, hi: Tensor):
    """The JAX package's projection: a box clip, then 3 rounds of batch
    day-mean removal, each followed by the clip. CR3's best responses
    take it, as the JAX package's do: the clearing rounds are discrete
    decisions on the plan's rebates, and the exact projection
    (`_projection`) moves them (2 rounds against the JAX package's 3 on
    a 16-row fleet at 150 steps). Lanes: x (N, W, T)."""
    W, T = lo.shape[-2:]
    day_hours = min(p.day_hours, T)   # as `project_days`
    n_days = T // day_hours
    span = n_days * day_hours
    is_batch = torch.as_tensor(p.is_batch, dtype=torch.bool,
                               device=lo.device)[:, None, None]

    def project(D: Tensor) -> Tensor:
        lead = tuple(D.shape[:-2])
        D = torch.clamp(D, lo, hi)
        for _ in range(3):
            Dd = D[..., :span].reshape(lead + (W, n_days, day_hours))
            Dd = torch.where(is_batch, Dd - Dd.mean(dim=-1, keepdim=True),
                             Dd)
            D = torch.clamp(torch.cat([Dd.reshape(lead + (W, span)),
                                       D[..., span:]], dim=-1), lo, hi)
        return D

    return project


def _report(p: FleetProblem, D: np.ndarray, pens: np.ndarray,
            iters: int, state: EngineState | None = None,
            extras: dict | None = None) -> FleetSolveResult:
    """Carbon reduction, penalty and preservation of a plan, in float64
    numpy on the host; a multi-region fleet prices each row on its
    region's trace."""
    mci = np.asarray(p.mci)
    if mci.ndim == 2:
        wmci = mci[np.asarray(p.region)]
        carbon_base = float((np.asarray(p.usage) * wmci).sum())
        car = float((D * wmci).sum())
    else:
        carbon_base = float((np.asarray(p.usage).sum(0) * mci).sum())
        car = float((D @ mci).sum())
    day_hours = min(p.day_hours, p.T)  # as `project_days`
    n_days = p.T // day_hours
    span = n_days * day_hours
    sums = D[:, :span].reshape(p.W, n_days, day_hours).sum(-1)
    is_batch = np.asarray(p.is_batch)
    viol = float(np.abs(sums[is_batch]).max()) if is_batch.any() else 0.0
    return FleetSolveResult(
        D=D, carbon_reduction_pct=100 * car / carbon_base,
        total_penalty_pct=100 * float(pens.sum())
        / float(np.asarray(p.entitlement).sum()),
        iters=iters, preservation_violation=viol, state=state,
        extras=extras or {})


# ---------------------------------------------------------------------------
# Deprecated per-policy entry points (thin shims over repro_torch.core.api)
# ---------------------------------------------------------------------------
def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} from repro_torch.core.api",
        DeprecationWarning, stacklevel=3)


def solve_cr1_fleet(p: FleetProblem, lam: float = 1.45, steps: int = 600,
                    use_kernel: bool | None = None,
                    warm: EngineState | None = None, *, mesh=None,
                    donate: bool = False, shift: int = 0,
                    reset_mu: bool = False,
                    device: str | torch.device | None = None,
                    ) -> FleetSolveResult:
    """Deprecated: `api.solve(p, CR1(lam=...), ctx=SolveContext(...))`."""
    from repro_torch.core.api import CR1, SolveContext, solve
    _warn_deprecated("solve_cr1_fleet",
                     "solve(p, CR1(lam=...), ctx=SolveContext(...))")
    return solve(p, CR1(lam=lam), ctx=SolveContext(
        device=device, mesh=mesh, donate=donate, shift=shift,
        reset_mu=reset_mu, warm=warm, use_kernel=use_kernel, steps=steps))


def solve_cr1_fleet_sweep(p: FleetProblem, lams: Sequence[float],
                          steps: int = 600, use_kernel: bool | None = None,
                          device: str | torch.device | None = None,
                          ) -> list[FleetSolveResult]:
    """Deprecated: `api.sweep(p, [CR1(lam=l) for l in lams], ctx=...)`."""
    from repro_torch.core.api import CR1, SolveContext, sweep
    _warn_deprecated("solve_cr1_fleet_sweep",
                     "sweep(p, [CR1(lam=l) for l in lams], ctx=...)")
    return sweep(p, [CR1(lam=float(lam)) for lam in lams],
                 ctx=SolveContext(device=device, steps=steps,
                                  use_kernel=use_kernel))


def solve_cr2_fleet(p: FleetProblem, cap_frac: float = 0.78,
                    steps: int = 400, outer: int = 6,
                    use_kernel: bool | None = None,
                    warm: EngineState | None = None, *, mesh=None,
                    donate: bool = False, shift: int = 0,
                    reset_mu: bool = False,
                    device: str | torch.device | None = None,
                    ) -> FleetSolveResult:
    """Deprecated: `api.solve(p, CR2(cap_frac=..., outer=...), ctx=...)`."""
    from repro_torch.core.api import CR2, SolveContext, solve
    _warn_deprecated("solve_cr2_fleet",
                     "solve(p, CR2(cap_frac=...), ctx=SolveContext(...))")
    return solve(p, CR2(cap_frac=cap_frac, outer=outer), ctx=SolveContext(
        device=device, mesh=mesh, donate=donate, shift=shift,
        reset_mu=reset_mu, warm=warm, use_kernel=use_kernel, steps=steps))


def solve_cr3_fleet(p: FleetProblem, rho: float = 0.02,
                    tax_frac: float = 0.2, steps: int = 600, outer: int = 3,
                    clearing_iters: int = 8,
                    use_kernel: bool | None = None,
                    warm: EngineState | None = None, *, mesh=None,
                    donate: bool = False, shift: int = 0,
                    reset_mu: bool = False,
                    device: str | torch.device | None = None,
                    ) -> tuple[FleetSolveResult, float]:
    """Deprecated: `api.solve(p, CR3(rho=..., tax_frac=...), ctx=...)`.

    The unified API returns a single `FleetSolveResult`; the clearing rho
    this shim's tuple carries lives in `result.extras["rho"]`."""
    from repro_torch.core.api import CR3, SolveContext, solve
    _warn_deprecated(
        "solve_cr3_fleet",
        "solve(p, CR3(rho=..., tax_frac=...), ctx=SolveContext(...)) "
        "(clearing rho is result.extras['rho'])")
    result = solve(p, CR3(rho=rho, tax_frac=tax_frac, outer=outer,
                          clearing_iters=clearing_iters),
                   ctx=SolveContext(device=device, mesh=mesh, donate=donate,
                                    shift=shift, reset_mu=reset_mu,
                                    warm=warm, use_kernel=use_kernel,
                                    steps=steps))
    return result, result.extras["rho"]
