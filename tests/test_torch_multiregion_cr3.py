"""CR3 over regions on the CPU: the port's per-region Eq.-6 clearing
(`CR3._solve_multiregion`) against the JAX package's, on the R = 3 draw
of `tests/torch_region_fleets.py` (the JAX side on its generic engine),
and against the port's own standalone solve of each region.

Tolerances, as `tests/test_torch_cr3.py`: the same rounds and balance;
carbon % and penalty % within 0.05 pp (`PP`); a region that cleared in
its first round keeps the configured price, held to 1e-4 (`RHO_ONE`);
one that took several rounds is held to 2 % (`RHO_MULTI`, the JAX
package's own one-ulp spread of its 150-step price) of the JAX package's
price, or of its standalone solve of that region's market where its
joint and standalone solves clear more than 2 % apart
(`test_multiregion_cr3_rho_spread`).
"""
import contextlib
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro_torch.core import api as tapi
from repro_torch.core import fleet_solver as tfs
from torch_region_fleets import STATES, carry, jax_regional_fleet, \
    paper_templates

PP = 0.05
RHO_ONE = 1e-4
RHO_MULTI = 0.02


@pytest.fixture(scope="module")
def fleets():
    """The R = 3 (CA, TX, NY) fleet of 12 rows of
    `tests/test_torch_multiregion.py`, JAX and port."""
    p = jax_regional_fleet(paper_templates()[0], 12, STATES, seed=3,
                           utc_offsets="auto", topology=None)
    return {3: (p, carry(p))}


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", **kw)


@contextlib.contextmanager
def _quiet():
    """CR3 warns where a region's clearing runs out of rounds."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def _gaps(a, b):
    return (abs(a.carbon_reduction_pct - b.carbon_reduction_pct),
            abs(a.total_penalty_pct - b.total_penalty_pct))


def _region_alone(p, r):
    """Region r's rows of the multi-region problem `p` (either package's)
    as a standalone single-region problem on its own trace."""
    rows = np.asarray(p.region) == r
    fields = {f: np.asarray(getattr(p, f))[rows]
              for f in ("usage", "entitlement", "k", "rts_coeffs", "betas",
                        "x2_kind", "jobs", "is_batch")}
    return dataclasses.replace(p, mci=np.asarray(p.mci)[r], region=None,
                               topology=None, names=None, **fields)


@pytest.fixture(scope="module")
def cr3_solves(fleets):
    """CR3 at its defaults on the R = 3 fleet, shared by the tests below:
    `get(package, steps, use_kernel=False, region=None)` with package
    "jax" or "port", and `region` r for that region's standalone solve."""
    p, tp = fleets[3]
    memo = {}

    def get(package, steps, use_kernel=False, region=None):
        key = (package, steps, use_kernel, region)
        if key not in memo:
            with _quiet():
                if package == "jax":
                    q = p if region is None else _region_alone(p, region)
                    memo[key] = japi.solve(q, japi.CR3(), ctx=(
                        japi.SolveContext(use_kernel=False, steps=steps)))
                else:
                    q = tp if region is None else _region_alone(tp, region)
                    memo[key] = tapi.solve(q, tapi.CR3(), ctx=_ctx(
                        use_kernel=use_kernel, steps=steps))
        return memo[key]

    return get


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("steps", [150, 600])
def test_multiregion_cr3_matches_jax(cr3_solves, steps, use_kernel):
    """Per-region clearing against the JAX package's: the same rounds and
    balance, carbon and penalty within `PP`, through the plain features
    and through `dr_features`' plain version. A region that cleared in
    its first round keeps the configured price (`RHO_ONE`); one that
    took several is held to `RHO_MULTI` of the JAX package's price, or,
    where that package's own joint and standalone solves of the region
    clear further apart than that (`test_multiregion_cr3_rho_spread`),
    to `RHO_MULTI` of its standalone solve's price."""
    want = cr3_solves("jax", steps)
    got = cr3_solves("port", steps, use_kernel)
    assert got.iters == want.iters and got.balanced == want.balanced
    dc, dp = _gaps(got, want)
    assert dc < PP and dp < PP, (dc, dp)
    assert got.preservation_violation < 1e-3
    assert got.state.lam_in.shape == (got.D.shape[0],)
    rho, rho_w = np.asarray(got.extras["rho"]), np.asarray(want.extras["rho"])
    assert rho.shape == (3,)
    for r in range(3):
        if rho_w[r] == 0.02:
            assert rho[r] == pytest.approx(rho_w[r], rel=RHO_ONE)
        elif rho[r] != pytest.approx(rho_w[r], rel=RHO_MULTI):
            # The JAX package's joint solve clears this region's market
            # more than RHO_MULTI from its own standalone solve of it (the
            # witness below); the port is held to the standalone one.
            alone = cr3_solves("jax", steps, region=r).extras["rho"]
            assert rho_w[r] != pytest.approx(alone, rel=RHO_MULTI), r
            assert rho[r] == pytest.approx(alone, rel=RHO_MULTI), r


@pytest.mark.parametrize("steps", [150])
def test_multiregion_cr3_clears_each_region_as_alone(fleets, cr3_solves,
                                                     steps):
    """Each region's market is its standalone market: the port's joint
    solve clears every region at the price of that region's
    single-region solve, in as many rounds as the slowest region, with
    its rows' penalties within 1e-5 (the zero-bandwidth decomposition, for
    CR3). Plans are not compared: a batch row on its zero-penalty plateau
    may rest anywhere on it (the regularizer breaks that tie only
    weakly), and a rounding change moves it there. The kernel path's
    clearing is the plain path's."""
    tp = fleets[3][1]
    region = np.asarray(tp.region)
    joint = cr3_solves("port", steps)
    rho = np.asarray(joint.extras["rho"])

    def pens(q, D):
        return tfs.fleet_penalties(q, torch.as_tensor(D)).numpy()

    alone = [cr3_solves("port", steps, region=r) for r in range(3)]
    for r, a in enumerate(alone):
        assert rho[r] == pytest.approx(a.extras["rho"], rel=1e-6)
        np.testing.assert_allclose(pens(tp, joint.D)[region == r],
                                   pens(_region_alone(tp, r), a.D),
                                   atol=1e-5)
    assert joint.iters == max(a.iters for a in alone)
    np.testing.assert_array_equal(
        rho, cr3_solves("port", steps, use_kernel=True).extras["rho"])


def test_multiregion_cr3_rho_spread(cr3_solves, capsys):
    """The witness behind `test_multiregion_cr3_matches_jax`'s reference:
    the JAX package's own joint solve and standalone solve of one region,
    the same market, clear at prices more than `RHO_MULTI` apart at 150
    steps on this draw (run with -s to print them); the port's joint
    solve is within `RHO_MULTI` of that standalone price."""
    gaps = []
    for r in range(3):
        joint = cr3_solves("jax", 150).extras["rho"][r]
        alone = cr3_solves("jax", 150, region=r).extras["rho"]
        port = cr3_solves("port", 150).extras["rho"][r]
        gaps.append(abs(joint / alone - 1.0))
        assert port == pytest.approx(alone, rel=RHO_MULTI)
        with capsys.disabled():
            print(f"\nregion {r}: JAX joint {joint:.6g}, JAX alone "
                  f"{alone:.6g}, port joint {port:.6g}")
    assert max(gaps) > RHO_MULTI


def test_multiregion_cr3_sweep_solves_per_policy(fleets):
    """A CR3 sweep of a multi-region fleet solves per policy, as in the JAX
    package: each lane is its `solve()`."""
    _, tp = fleets[3]
    pols = [tapi.CR3(rho=rho, outer=2) for rho in (0.01, 0.03)]
    ctx = _ctx(steps=60)
    with _quiet():
        lanes = tapi.sweep(tp, pols, ctx=ctx)
        loop = [tapi.solve(tp, pl, ctx=ctx) for pl in pols]
    for a, b in zip(lanes, loop):
        np.testing.assert_array_equal(a.D, b.D)
        np.testing.assert_array_equal(a.extras["rho"], b.extras["rho"])
