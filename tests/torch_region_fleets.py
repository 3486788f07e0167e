"""The JAX package's multi-region fleets, built for the port's parity tests
(`tests/test_torch_multiregion.py`, `tests/test_torch_migration.py`).

That package's `synthetic_regional_fleet` clones its paper fleet from
`var/fleet_*.npz`, the hash-seeded draw its own suite shares, which a
port test must never touch. So the fleet is composed here as that
function composes it, `regional_fleet([synthetic_fleet(n_r, hours,
seed + r, templates=T) ...], regional_traces(...)[0], topology)`, with
the templates calibrated small under the port's stable `name_hash`
(`tests/test_torch_solve.py`'s recipe), and carried into the port with
`repro_torch.convert`.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.penalty as jpen
from repro.core.carbon import regional_traces
from repro.core.fleet_solver import (RegionTopology, regional_fleet,
                                     synthetic_fleet)
from repro_torch import convert
from repro_torch.core import penalty as tpen

STATES = ("CA", "TX", "NY")


def paper_templates():
    """The JAX package's paper fleet at num_samples=32, num_jobs=1000, its
    job traces seeded with the port's `name_hash`, and the port's copy."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpen, "hash", tpen.name_hash, raising=False)
    try:
        jt = jpen.build_paper_fleet(num_samples=32, num_jobs=1000)
    finally:
        mp.undo()
    return jt, {n: convert.penalty_model_from_arrays(**{
        f.name: getattr(m, f.name) for f in dataclasses.fields(m)})
        for n, m in jt.items()}


def default_topology(fleets, states):
    """`synthetic_regional_fleet`'s default network: bandwidth 5 % of the
    fleet's entitlement over the R - 1 links out of a region, toll 2."""
    R = len(fleets)
    ent = float(sum(np.asarray(f.entitlement).sum() for f in fleets))
    bw = np.full((R, R), 0.05 * ent / max(R - 1, 1))
    np.fill_diagonal(bw, 0.0)
    return RegionTopology(cost=np.full((R, R), 2.0), bandwidth=bw,
                          labels=tuple(states))


def jax_regional_fleet(templates, num, states=STATES, hours=48, seed=0,
                       utc_offsets=None, topology="default"):
    """The JAX package's `synthetic_regional_fleet(num, states, hours,
    seed, utc_offsets=...)` with `templates` handed to each region's
    `synthetic_fleet`; `topology` None for none."""
    R = len(states)
    mcis, _ = regional_traces(list(states), year=2050, hours=hours,
                              seed=seed, utc_offsets=utc_offsets)
    per = [num // R + (1 if r < num % R else 0) for r in range(R)]
    fleets = [synthetic_fleet(per[r], hours=hours, seed=seed + r,
                              templates=templates) for r in range(R)]
    if isinstance(topology, str):
        topology = default_topology(fleets, states)
    return regional_fleet(fleets, mcis, topology=topology)


def carry(p):
    """A JAX `FleetProblem` (topology included) as the port's."""
    return convert.fleet_problem_from_arrays(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})
