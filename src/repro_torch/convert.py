"""Carry the JAX package's objects into the port, as numpy arrays.

Duck-typed: each function takes the fields of the reference's object
(arrays, or anything `np.asarray` reads) and never imports that package.
Typical use, with `p` a reference `FleetProblem`:

    fields = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    problem = fleet_problem_from_arrays(**fields)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.core.fleet_solver import DATA_FIELDS, FleetProblem
from repro_torch.core.penalty import PenaltyModel


def fleet_problem_from_arrays(*, topology=None, **fields) -> FleetProblem:
    """A port `FleetProblem` from the reference's data and meta fields.
    A migration `topology` is not ported yet and must be None."""
    if topology is not None:
        raise NotImplementedError("migration topologies are not ported yet")
    for name in DATA_FIELDS:
        if fields.get(name) is not None:
            fields[name] = np.asarray(fields[name]).copy()
    names = fields.get("names")
    if names is not None:
        fields["names"] = tuple(names)
    return FleetProblem(**fields)


def penalty_model_from_arrays(*, name, kind, usage, entitlement, k, params,
                              jobs=None, slo_hours=4,
                              feature_names=None) -> PenaltyModel:
    """A port `PenaltyModel` from the reference model's fields."""
    return PenaltyModel(
        name=str(name), kind=str(kind), usage=np.asarray(usage).copy(),
        entitlement=float(entitlement), k=float(k),
        params=tuple(float(a) for a in params),
        jobs=None if jobs is None else np.asarray(jobs).copy(),
        slo_hours=int(slo_hours),
        feature_names=None if feature_names is None
        else tuple(feature_names))


def engine_state_from_arrays(x, lam_eq, lam_in, mu,
                             device: str | torch.device) -> EngineState:
    """A warm-start `EngineState` (float32 tensors on `device`)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return EngineState(x=t(x), lam_eq=t(lam_eq), lam_in=t(lam_in), mu=t(mu))
