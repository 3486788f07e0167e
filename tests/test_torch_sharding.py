"""Fleet row sharding on `torch.distributed` (`launch/mesh.py`,
`engine.al_minimize_sharded`, the sharded CR1/CR2/CR3 lanes of
`api.solve`) on the CPU, against the port's unsharded solve and the JAX
package's.

The ranks are gloo processes spawned once per world size for the whole
module (`tests/torch_sharding_worker.py`: the spawn start method, a
`FileStore` under a temporary directory, one thread each); every rank
solves every job, so each result is held to rank 0's (bitwise: every
rank returns the same result) and rank 0's to the unsharded solves. The
fleets are `tests/test_torch_solve.py`'s recipe at W = 17 (padded to 18
at world 2 and to 20 on the 2 x 2 mesh) and a three-region fleet of 13
rows (`tests/torch_region_fleets.py`), built here and handed to the
ranks.

Bounds: the sharded plan within 0.01 pp of the unsharded one in carbon
and penalty (the JAX package's own sharded bound,
`tests/test_fleet_sharding.py:84-97`), within 0.05 pp of the JAX
package's generic engine (its fused-vs-generic bound); CR3 with the
same rounds and `balanced`, rho within 1e-4 relative for one round and
`RHO_MULTI` (2 %) for several (`tests/test_torch_cr3.py`); pad rows of
the state exactly 0; a warm re-solve from the sharded (padded) state
within 1e-4 NP of one from the unsharded state
(`tests/test_fleet_sharding.py:132`); telemetry's objective, squared
gradient norm, mean |dx| and step_scale within 1e-5 relative and the
worst violation exact.
"""
import numpy as np
import pytest
import torch

import torch_sharding_worker as worker
from repro.core import api as japi
from repro.core.engine import EngineState as JEngineState
from repro.core.fleet_solver import PAD_FILLS as J_PAD_FILLS
from repro.core.fleet_solver import _pad_state as jpad_state
from repro.core.fleet_solver import pad_fleet as jpad_fleet
from repro.core.fleet_solver import synthetic_fleet
from repro.core.regional import (CR1_NORM_FILLS as J_CR1_FILLS,
                                 CR2_NORM_FILLS as J_CR2_FILLS,
                                 pad_row_norms as jpad_row_norms)
from repro_torch.core import api as tapi
from repro_torch.core import fleet_solver as tfs
from repro_torch.core import regional as treg
from repro_torch.core.engine import EngineState
from repro_torch.launch import mesh as tmesh
from repro_torch.obs.telemetry import TelemetryConfig
from torch_region_fleets import carry, jax_regional_fleet, paper_templates

SHARD_PP = 0.01
JAX_PP = 0.05
RHO_ONE = 1e-4
RHO_MULTI = 0.02
W = 17
W_REG = 13
TEL = TelemetryConfig(every=10)


@pytest.fixture(scope="module")
def fleets():
    """The 17-row mixed fleet and the 13-row three-region fleet, JAX and
    port copies."""
    jt, _ = paper_templates()
    p = synthetic_fleet(W, hours=48, seed=0, templates=jt)
    pr = jax_regional_fleet(jt, W_REG, seed=0)
    return {"mixed": (p, carry(p)), "regions": (pr, carry(pr)),
            "templates": jt}


def _ctx(**kw):
    return tapi.SolveContext(device="cpu", **kw)


def _jobs(fleets, world):
    """(name, job) pairs for a `world`-rank group."""
    p, tp = fleets["mixed"]
    pr, tpr = fleets["regions"]
    pols = {"cr1": (tapi.CR1(lam=1.45), japi.CR1(lam=1.45)),
            "cr2": (tapi.CR2(cap_frac=0.78, outer=3),
                    japi.CR2(cap_frac=0.78, outer=3)),
            "cr3": (tapi.CR3(), japi.CR3())}
    steps = {"cr1": 200, "cr2": 120, "cr3": 150}
    jobs = [(name, dict(fleet=tp, policy=pols[name][0],
                        jax=(p, pols[name][1]),
                        ctx=dict(steps=steps[name], use_kernel=False)))
            for name in ("cr1", "cr2", "cr3")]
    if world == 4:
        return [(name, dict(job, regions=2)) for name, job in jobs]
    cr1 = pols["cr1"][0]
    for name in ("cr1", "cr2"):
        jobs.append((name + "-fused", dict(
            fleet=tp, policy=pols[name][0],
            ctx=dict(steps=steps[name], use_kernel=True))))
    chain = dict(steps=100, shift=1, reset_mu=True)
    jobs.append(("cr1-warm", dict(fleet=tp, policy=cr1, ctx=dict(steps=200),
                                  chain=chain)))
    jobs.append(("cr1-given", dict(fleet=tp, policy=cr1, ctx=dict(chain),
                                   warm_state=_cold_cr1(fleets))))
    jobs.append(("cr1-tel", dict(fleet=tp, policy=cr1, ctx=dict(
        steps=60, use_kernel=False, telemetry=TEL))))
    jobs.append(("cr2-tel", dict(fleet=tp, policy=tapi.CR2(outer=2),
                                 ctx=dict(steps=30, use_kernel=False,
                                          telemetry=TEL))))
    jobs.append(("reg-cr1-tel", dict(fleet=tpr, policy=cr1, ctx=dict(
        steps=60, use_kernel=False, telemetry=TEL))))
    for regions, tag in ((None, ""), (2, "-2x1")):
        for name in ("cr1", "cr2"):
            jobs.append((f"reg-{name}{tag}", dict(
                fleet=tpr, policy=pols[name][0], regions=regions,
                jax=(pr, pols[name][1]),
                ctx=dict(steps=steps[name], use_kernel=False))))
        jobs.append((f"reg-cr3{tag}", dict(
            fleet=tpr, policy=tapi.CR3(outer=2), regions=regions,
            ctx=dict(steps=60))))
    return jobs


def _cold_cr1(fleets):
    """The unsharded cold CR1 state (numpy), a warm start for the ranks."""
    r = tapi.solve(fleets["mixed"][1], tapi.CR1(lam=1.45),
                   ctx=_ctx(steps=200))
    return tuple(getattr(r.state, f).numpy()
                 for f in ("x", "lam_eq", "lam_in", "mu"))


def _unsharded(jobs, memo):
    """Each job's unsharded solves: name -> (port result, JAX result or
    None), a chained job's second solve as "<name>/chain"; `memo` shares
    equal solves between groups."""
    want = {}
    for name, job in jobs:
        kw = dict(job.get("ctx", {}))
        if "warm_state" in job:
            kw["warm"] = EngineState(*(torch.as_tensor(a)
                                       for a in job["warm_state"]))
        key = (id(job["fleet"]), job["policy"], repr(sorted(kw.items())))
        if key not in memo:
            solo = tapi.solve(job["fleet"], job["policy"], ctx=_ctx(**kw))
            jres = None
            if "jax" in job:
                jp, jpl = job["jax"]
                jres = japi.solve(jp, jpl, ctx=japi.SolveContext(
                    use_kernel=False, steps=kw["steps"]))
            memo[key] = (solo, jres)
        want[name] = memo[key]
        if "chain" in job:
            want[name + "/chain"] = (tapi.solve(
                job["fleet"], job["policy"],
                ctx=_ctx(warm=want[name][0].state, **job["chain"])), None)
    return want


def _run(fleets, world, memo):
    """Start the ranks, solve unsharded beside them, then collect."""
    jobs = _jobs(fleets, world)
    group = worker.Group(world, [(n, {k: v for k, v in j.items()
                                      if k != "jax"}) for n, j in jobs])
    try:
        want = _unsharded(jobs, memo)
    finally:
        results = group.results()
    return results, want


@pytest.fixture(scope="module")
def memo():
    return {}


@pytest.fixture(scope="module")
def world2(fleets, memo):
    return _run(fleets, 2, memo)


@pytest.fixture(scope="module")
def mesh2x2(fleets, memo):
    return _run(fleets, 4, memo)


def _same_clearing(got, want, tol_one=RHO_ONE):
    """CR3's clearing: rounds, balance and rho (A6's bounds)."""
    assert got["iters"] == want.iters
    assert got["extras"]["balanced"] == want.extras["balanced"]
    rho, rho_w = (np.asarray(got["extras"]["rho"]),
                  np.asarray(want.extras["rho"]))
    tol = tol_one if _one_round(want) else RHO_MULTI
    assert float(np.max(np.abs(rho - rho_w) / rho_w)) < tol


def _one_round(r) -> bool:
    """A one-round CR3 keeps its configured rho (0.02 here)."""
    return bool(np.all(np.asarray(r.extras["rho"]) == 0.02))


def _check(results, want, name, W_true, W_pad):
    got = results[0][name]
    for other in results[1:]:
        o = other[name]
        np.testing.assert_array_equal(o["D"], got["D"])
        np.testing.assert_array_equal(o["x"], got["x"])
        assert (o["carbon"], o["penalty"]) == (got["carbon"],
                                               got["penalty"])
    solo, jres = want[name]
    assert got["D"].shape == (W_true, 48) and np.isfinite(got["D"]).all()
    assert got["x"].shape == (W_pad, 48)
    assert not np.any(got["x"][W_true:])
    for lam in (got["lam_eq"], got["lam_in"]):
        assert lam.shape in ((0,), (W_pad,))
        assert not np.any(lam[W_true:])
    assert got["iters"] == solo.iters
    assert abs(got["carbon"] - solo.carbon_reduction_pct) < SHARD_PP
    assert abs(got["penalty"] - solo.total_penalty_pct) < SHARD_PP
    if "rho" in solo.extras:
        _same_clearing(got, solo)
    if jres is not None:
        assert abs(got["carbon"] - jres.carbon_reduction_pct) < JAX_PP
        assert abs(got["penalty"] - jres.total_penalty_pct) < JAX_PP
    return got, solo


# ---------------------------------------------------------------------------
# Padding, against the JAX package's functions on the same numpy inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("W_, multiple", [(13, 8), (16, 8), (16, 16)])
@pytest.mark.parametrize("regions", [False, True])
def test_pad_fleet_matches_jax(fleets, W_, multiple, regions):
    """W = 13 pads to 16 with the JAX package's inert rows; a divisible W
    passes through with `upper` materialized; names and topology go."""
    jt = fleets["templates"]
    p = jax_regional_fleet(jt, W_, seed=1) if regions \
        else synthetic_fleet(W_, hours=48, seed=2, templates=jt)
    want, W_want = jpad_fleet(p, multiple)
    got, W_got = tfs.pad_fleet(carry(p), multiple)
    assert (W_got, got.W) == (W_want, want.W) == (W_, -(-W_ // multiple)
                                                   * multiple)
    for f in tfs.DATA_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.names is None and got.topology is None
    assert tfs.PAD_FILLS == J_PAD_FILLS


def test_pad_fleet_rows_are_inert(fleets):
    """Pad rows: box [0, 0], zero penalties at any plan, finite norms."""
    _, tp = fleets["mixed"]
    pp, W_ = tfs.pad_fleet(tp, 8)
    assert (W_, pp.W) == (17, 24)
    lo, hi = tfs._bounds(pp)
    assert not torch.any(lo[17:]) and not torch.any(hi[17:])
    D = torch.cat([0.1 * torch.as_tensor(tp.usage, dtype=torch.float32),
                   torch.zeros((7, 48))])
    pens = tfs.fleet_penalties(pp, D)
    assert torch.isfinite(pens).all() and not torch.any(pens[17:])


@pytest.mark.parametrize("shape", [(13, 16), (16, 16), (16, 20)])
def test_pad_state_matches_jax(shape):
    """`_pad_state` zero-pads x and the per-row multipliers as the JAX
    package's; an already padded state passes through as it is."""
    W_, W_pad = shape
    rng = np.random.default_rng(W_pad)
    x = rng.normal(size=(W_, 48)).astype(np.float32)
    lam = rng.normal(size=W_).astype(np.float32)
    for n_eq, n_in in ((W_, 0), (0, W_), (0, 0)):
        leaves = (x, lam[:n_eq], lam[:n_in], np.float32(7.0))
        want = jpad_state(JEngineState(*leaves), W_pad)
        st = EngineState(*(torch.as_tensor(a) for a in leaves))
        got = tfs._pad_state(st, W_pad)
        if W_ == W_pad:
            assert got is st
        for f in ("x", "lam_eq", "lam_in", "mu"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_pad_row_norms_matches_jax(fleets, policy):
    """The multi-region per-row norms padded with the JAX package's
    fills (weights 0, divisors 1)."""
    _, tpr = fleets["regions"]
    view = tfs.device_view(tpr, torch.device("cpu"))
    if policy == "cr1":
        norms, fills, jfills = treg.cr1_norms(view), treg.CR1_NORM_FILLS, \
            J_CR1_FILLS
    else:
        refs = torch.as_tensor(tfs.cr2_reference_fleet(tpr, 0.78, "cpu"))
        norms, fills, jfills = treg.cr2_norms(view, refs), \
            treg.CR2_NORM_FILLS, J_CR2_FILLS
    assert fills == jfills
    got = treg.pad_row_norms(norms, 16, fills)
    want = jpad_row_norms([a.numpy() for a in norms], 16, jfills)
    for a, b in zip(got, want):
        assert a.shape[0] == 16
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert treg.pad_row_norms(norms, W_REG, fills)[0] is norms[0]


def test_row_block_takes_rows_and_keeps_the_trace(fleets):
    """Blocks of a padded problem tile its rows; the carbon trace is
    replicated; a device view's block gets its own RegionIndex."""
    _, tpr = fleets["regions"]
    pp, _ = tfs.pad_fleet(tpr, 2)
    view = tfs.device_view(pp, torch.device("cpu"))
    blocks = [tfs.row_block(view, i, 2) for i in range(2)]
    for f in tfs.ROW_FIELDS:
        torch.testing.assert_close(
            torch.cat([getattr(b, f) for b in blocks]), getattr(view, f),
            rtol=0, atol=0)
    for b in blocks:
        assert b.mci is view.mci and b.W == 7
        want = tfs.region_index(b.region.numpy(), 3, "cpu")
        assert torch.equal(b.region_index.order, want.order)
        assert b.region_index.counts == want.counts
    host = tfs.row_block(pp, 1, 2)
    np.testing.assert_array_equal(host.usage, np.asarray(pp.usage)[7:])
    with pytest.raises(ValueError, match="divisible"):
        tfs.row_block(tpr, 0, 2)


# ---------------------------------------------------------------------------
# The mesh helpers
# ---------------------------------------------------------------------------
def test_make_fleet_mesh_needs_a_process_group():
    """No silent world of one: without a default group the mesh refuses."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_fleet_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_fleet_mesh(regions=1, device_type="cpu")


@pytest.mark.parametrize("policy", [tapi.CR1(), tapi.CR2(), tapi.CR3()])
def test_solve_refuses_a_mesh_that_is_not_a_device_mesh(fleets, policy):
    _, tp = fleets["mixed"]
    with pytest.raises(TypeError, match="DeviceMesh"):
        tapi.solve(tp, policy, ctx=_ctx(steps=2, mesh=object()))


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_helpers_on_gloo_groups(world2, mesh2x2, world):
    """1-D and 2-D meshes, the "must divide" and span refusals, a mesh on
    another device type than the solve's, a mesh without a fleet axis,
    and one that would replicate rows over an axis W does not shard."""
    facts = (world2 if world == 2 else mesh2x2)[0][0]["mesh"]
    assert facts["1d"] == ("fleet", "fleet", world, ("fleet",))
    assert facts["2d"] == ("fleet", ("region", "fleet"), world,
                           (2, world // 2))
    for bad in (3, 0):
        assert facts[f"regions={bad}"] == (
            f"regions={bad} must divide the device count {world}")
    assert "spans the process group" in facts["n_devices"]
    assert "'cpu' devices but the solve runs on 'cuda'" in \
        facts["device_type"]
    assert "needs a 'fleet' axis" in facts["no fleet axis"]
    assert "would replicate rows" in facts["replicated"]


# ---------------------------------------------------------------------------
# Sharded solves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["cr1", "cr2", "cr3", "cr1-fused",
                                  "cr2-fused"])
def test_sharded_matches_unsharded_world2(world2, name):
    """World 2, a 1-D mesh: 17 rows pad to 18; every rank returns the
    same result, within 0.01 pp of the port's unsharded solve (CR1/CR2
    bitwise on the CPU in practice) and 0.05 pp of the JAX package's."""
    _check(*world2, name, W, 18)


@pytest.mark.parametrize("name", ["cr1", "cr2", "cr3"])
def test_sharded_matches_unsharded_2x2(mesh2x2, name):
    """A 2 x 2 (region, fleet) mesh: 17 rows pad to 20 over 4 blocks."""
    _check(*mesh2x2, name, W, 20)


def test_sharded_warm_chain(world2):
    """A re-solve warm from the sharded (padded) state, shifted an hour
    with mu reset, against one warm from the unsharded state (padded on
    entry; |dD| < 1e-4) and against the unsharded chain (0.01 pp)."""
    results, want = world2
    own, solo = _check(results, want, "cr1-warm/chain", W, 18)
    given, _ = _check(results, want, "cr1-given", W, 18)
    assert np.abs(own["D"] - given["D"]).max() < 1e-4
    assert own["mu"] == given["mu"] == pytest.approx(10.0 * 2)


@pytest.mark.parametrize("name, W_true, W_pad", [
    ("cr1-tel", W, 18), ("cr2-tel", W, 18), ("reg-cr1-tel", W_REG, 14)])
def test_sharded_telemetry_is_the_unsharded_trace(world2, name, W_true,
                                                  W_pad):
    """The generic engine's trace all-reduced over the blocks: objective,
    squared gradient norm, mean |dx| and step_scale (per row on the
    three-region fleet) within 1e-5 relative, the means over the true
    rows, worst violation exact, the same steps and mu."""
    results, want = world2
    got, solo = _check(results, want, name, W_true, W_pad)
    tel, ref = got["telemetry"], solo.extras["telemetry"]
    np.testing.assert_array_equal(tel["step"], ref.step)
    np.testing.assert_array_equal(tel["mu"], ref.mu)
    np.testing.assert_allclose(tel["objective"], ref.objective, rtol=1e-5)
    np.testing.assert_allclose(tel["grad_norm"] ** 2, ref.grad_norm ** 2,
                               rtol=1e-5)
    np.testing.assert_allclose(tel["dx"], ref.dx, rtol=1e-5)
    np.testing.assert_allclose(tel["step_scale"], ref.step_scale, rtol=1e-5)
    np.testing.assert_array_equal(tel["violation"], ref.violation)


@pytest.mark.parametrize("name", ["reg-cr1", "reg-cr2", "reg-cr3",
                                  "reg-cr1-2x1", "reg-cr2-2x1",
                                  "reg-cr3-2x1"])
def test_sharded_three_regions(world2, name):
    """The three-region fleet (13 rows, padded to 14; the pad row in
    region 0) on a 1-D mesh and on a (2, 1) (region, fleet) mesh: norms
    of the whole unpadded fleet, CR3's per-region clearing, the migration
    post-stage on the gathered plan."""
    _check(*world2, name, W_REG, 14)
