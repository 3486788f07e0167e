"""The port's fleet data model against the JAX package's on random
fleets and plans, on the CPU: bounds, projection, penalties (value and
autograd gradient, including the cold start D = 0 where every hinge
ties), the CR1/CR2 normalizers and the CR2 references.

Tolerances: 1e-5 relative for elementwise float32 work, 1e-4 where sums
over the horizon or the fleet run in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet_solver as jfs
from repro.core import regional as jreg
from repro_torch import convert
from repro_torch.core import fleet_solver as tfs
from repro_torch.core import regional as treg

T = 48


def _ref_problem(W, seed):
    """A random single-region fleet in the JAX package's FleetProblem."""
    rng = np.random.default_rng(seed)
    usage = np.abs(rng.normal(20.0, 6.0, (W, T))) + 2.0
    ent = usage.max(1) * rng.uniform(1.05, 1.4, W)
    isb = np.arange(W) % 2 == 1
    rts = np.where(isb[:, None], 0.0,
                   np.where(np.arange(W)[:, None] % 4 == 0,
                            [[6.3, -13.0, 51.6]], [[-4.0, -3.5, 42.5]]))
    betas = np.where(isb[:, None],
                     np.c_[rng.uniform(-2, 2, W), rng.uniform(0.01, 0.1, W),
                           rng.uniform(0.001, 0.05, W)], 0.0)
    jobs = np.where(isb[:, None], np.abs(rng.normal(30.0, 8.0, (W, T))), 1.0)
    return jfs.FleetProblem(
        usage=usage, entitlement=ent, k=rng.uniform(0.001, 0.02, W),
        rts_coeffs=rts, betas=betas,
        x2_kind=(np.arange(W) % 4 == 3).astype(float), jobs=jobs,
        is_batch=isb, mci=np.linspace(250.0, 420.0, T) + 30 * np.sin(
            np.arange(T) / 3.0), names=tuple(f"w{i}" for i in range(W)))


def _carry(p):
    return convert.fleet_problem_from_arrays(
        **{f.name: getattr(p, f.name) for f in dataclasses.fields(p)})


def _plan(p, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return (scale * p.usage * rng.uniform(-1.0, 1.0, p.usage.shape)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def problems():
    p = _ref_problem(13, seed=0)
    return p, _carry(p)


def test_convert_carries_every_field(problems):
    p, tp = problems
    for f in dataclasses.fields(tp):
        if f.name == "region_index":   # the port's device views only
            assert tp.region_index is None
            continue
        a, b = getattr(tp, f.name), getattr(p, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def test_bounds_match_jax(problems):
    p, tp = problems
    for ours, theirs in zip(tfs._bounds(tp), jfs._bounds(p)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=0)


def test_bounds_with_an_operational_cap(problems):
    p, _ = problems
    p = dataclasses.replace(p, upper=0.2 * p.usage)
    for ours, theirs in zip(tfs._bounds(_carry(p)), jfs._bounds(p)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=0)


def _day_sums(p, D):
    return np.abs(D.reshape(p.W, -1, p.day_hours).sum(-1)[p.is_batch]).max()


def _exact_projection(p, lo, hi, D):
    """Independent float64 reference: each batch row's whole days shifted
    by the τ that bisection finds for Σ clip(D − τ, lo, hi) = 0."""
    out = np.clip(D.astype(np.float64), lo, hi)
    dh = p.day_hours
    for i in np.nonzero(p.is_batch)[0]:
        for s in range(0, p.T - dh + 1, dh):
            y, l, h = D[i, s:s + dh].astype(np.float64), lo[i, s:s + dh], \
                hi[i, s:s + dh]
            a, b = (y - h).min() - 1.0, (y - l).max() + 1.0
            for _ in range(200):
                m = 0.5 * (a + b)
                a, b = (m, b) if np.clip(y - m, l, h).sum() > 0 else (a, m)
            out[i, s:s + dh] = np.clip(y - 0.5 * (a + b), l, h)
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_projection_matches_jax(problems, seed):
    """The port's projection (the generic engine's, and the kernel plain
    version's `_project`) is the exact one: in the box, with batch day
    sums 0, and equal to a float64 bisection. The JAX package's 3 rounds
    of day-mean removal reach the same point where no bound is active,
    and stop short of the day sums where bounds are."""
    from repro_torch.kernels.al_step.ref import _project
    p, tp = problems
    lo, hi = jfs._bounds(p)
    tlo, thi = tfs._bounds(tp)
    lo64, hi64 = tlo.numpy().astype(np.float64), thi.numpy().astype(
        np.float64)
    isb = torch.as_tensor(p.is_batch, dtype=torch.float32)[:, None]
    for scale in (0.8, 0.05):
        D = _plan(p, seed, scale=scale)
        want = np.asarray(jfs._projection(p, lo, hi)(jnp.asarray(D)))
        got = tfs._projection(tp, tlo, thi)(torch.as_tensor(D)).numpy()
        fixed = _project(torch.as_tensor(D), tlo, thi, isb,
                         p.day_hours).numpy()
        exact = _exact_projection(p, lo64, hi64, D)
        np.testing.assert_array_equal(fixed, got)
        np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
        assert (got >= tlo.numpy()).all() and (got <= thi.numpy()).all()
        assert _day_sums(p, got) < 1e-3
        if scale == 0.05:    # no bound active: one mean removal is exact
            assert ((exact > lo64) & (exact < hi64))[p.is_batch].all()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert _day_sums(p, got) <= _day_sums(p, want) + 1e-4


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("cold", [False, True])
def test_fleet_penalties_value_and_grad_match_jax(problems, use_kernel,
                                                  cold):
    """Value and gradient of Σ w·pens against `jax.grad`; at D = 0 the
    plain path must give autodiff's one half at every tie (the JAX
    engine's convention), the kernel path the strict `>` of the custom
    VJP."""
    p, tp = problems
    D = np.zeros_like(p.usage, np.float32) if cold else _plan(p, 3)
    w = np.random.default_rng(4).uniform(0.5, 1.5, p.W).astype(np.float32)

    def jloss(dd):
        return (jfs.fleet_penalties(p, dd, use_kernel=use_kernel) * w).sum()

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(D))
    Dt = torch.as_tensor(D).requires_grad_(True)
    pens = tfs.fleet_penalties(tp, Dt, use_kernel=use_kernel)
    (tgrad,) = torch.autograd.grad((pens * torch.as_tensor(w)).sum(), Dt)
    np.testing.assert_allclose(
        pens.detach().numpy(),
        np.asarray(jfs.fleet_penalties(p, jnp.asarray(D), use_kernel)),
        rtol=1e-4, atol=1e-6)
    assert float((pens.detach() * torch.as_tensor(w)).sum()) == \
        pytest.approx(float(jval), rel=1e-4)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-6)


def test_fleet_penalties_kernel_grad_is_plain_grad_off_ties(problems):
    """Off the hinge ties the kernel path's closed-form backward takes the
    plain path's gradient bit for bit: its indicators come from the same
    running sums, its products in autograd's order."""
    _, tp = problems
    D = _plan(tp, 3)
    w = torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, tp.W).astype(np.float32))
    grads = []
    for use_kernel in (True, False):
        Dt = torch.as_tensor(D).requires_grad_(True)
        pens = tfs.fleet_penalties(tp, Dt, use_kernel=use_kernel)
        grads.append(torch.autograd.grad((pens * w).sum(), Dt)[0].numpy())
    assert np.abs(grads[1]).max() > 0
    np.testing.assert_array_equal(grads[0], grads[1])


def test_norms_match_jax(problems):
    p, tp = problems
    pv = tfs.device_view(tp, torch.device("cpu"))
    for ours, theirs in zip(treg.cr1_norms(pv), jreg.cr1_norms(p)):
        assert float(ours) == pytest.approx(float(theirs), rel=1e-5)
    refs = np.abs(np.random.default_rng(5).normal(1.0, 0.3, p.W))
    tr = torch.as_tensor(refs, dtype=torch.float32)
    for ours, theirs in zip(treg.cr2_norms(pv, tr),
                            jreg.cr2_norms(p, jnp.asarray(refs,
                                                          jnp.float32))):
        assert float(ours) == pytest.approx(float(theirs), rel=1e-5)


def test_cr2_references_match_jax(problems):
    p, tp = problems
    np.testing.assert_allclose(tfs.cr2_reference_fleet(tp, 0.78, "cpu"),
                               jfs.cr2_reference_fleet(p, 0.78), rtol=1e-4,
                               atol=1e-6)


def test_report_matches_jax(problems):
    p, tp = problems
    D = _plan(p, 6)
    pens = np.asarray(jfs.fleet_penalties(p, jnp.asarray(D)))
    a, b = tfs._report(tp, D, pens, iters=3), jfs._report(p, D, pens, 3)
    assert a.carbon_reduction_pct == b.carbon_reduction_pct
    assert a.total_penalty_pct == b.total_penalty_pct
    assert a.preservation_violation == b.preservation_violation


def test_multi_region_is_not_ported(problems):
    """Multi-region fleets are ported (`tests/test_torch_multiregion.py`):
    R = 1 canonicalizes, R = 2 passes through with per-row normalizers.
    What stays refused is what the JAX package refuses: the per-workload
    SLSQP view of a multi-region fleet; and a topology must carry the
    network's arrays."""
    _, tp = problems
    one = dataclasses.replace(tp, mci=tp.mci[None, :],
                              region=np.zeros(tp.W, np.int32))
    assert tfs.single_region_view(one).mci.shape == (T,)
    two = dataclasses.replace(tp, mci=np.stack([tp.mci, tp.mci]),
                              region=np.arange(tp.W) % 2)
    assert tfs.single_region_view(two) is two and two.R == 2
    with pytest.raises(ValueError, match="single-region"):
        two.to_problem()
    pen, car, step = treg.cr1_norms(tfs.device_view(two, torch.device("cpu")))
    assert pen.shape == car.shape == (tp.W,) and step.shape == (tp.W, 1)
    with pytest.raises(AttributeError):
        convert.fleet_problem_from_arrays(
            **{f.name: getattr(tp, f.name) for f in dataclasses.fields(tp)
               if f.name != "topology"}, topology=object())
