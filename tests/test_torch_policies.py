"""The per-workload policy layer on the CPU: the port's `DRProblem`, the
policy specs (CR1, CR2, CR3's per-workload problem, B2, B4) and the
closed-form baselines (B1, B3) against the JAX package's
`repro.core.policies` / `repro.core.baselines`, on the paper's
four-workload problem (RTS1, RTS2, AITraining, DataPipeline over
`caiso_2021(48)`).

The same seeded plans go through both packages. Tolerances: float32
rtol 1e-5 (against the largest magnitude of the compared quantity, so a
value near zero is held to the same absolute error as its neighbours);
float64 rtol 1e-10, the JAX side under `jax.enable_x64`. The closed
forms are numpy in both packages and must agree exactly. CR2's spec is
compared with both packages holding the same fairness targets (the
targets themselves are float32 penalties, compared at float32's bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.penalty as jpen
from repro.core import baselines as jbase
from repro.core import policies as jpol
from repro.core.carbon import caiso_2021
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import penalty as tpen
from repro_torch.core import policies as tpol

ORDER = ("RTS1", "RTS2", "AITraining", "DataPipeline")
RTOL = {"float32": 1e-5, "float64": 1e-10}


@pytest.fixture(scope="module")
def problems():
    """The four-workload problem in both packages: the JAX package's
    paper fleet calibrated at num_samples=32, num_jobs=1000 with the
    port's stable `name_hash` for the job traces, carried into the port
    model by model."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpen, "hash", tpen.name_hash, raising=False)
    try:
        templates = jpen.build_paper_fleet(num_samples=32, num_jobs=1000)
    finally:
        mp.undo()
    models = tuple(templates[n] for n in ORDER)
    mci = np.asarray(caiso_2021(48).mci)
    jp = jpol.DRProblem(models=models, mci=mci)
    tp = tpol.DRProblem(models=tuple(
        convert.penalty_model_from_arrays(**{
            f.name: getattr(m, f.name) for f in dataclasses.fields(m)})
        for m in models), mci=mci)
    return jp, tp


def _plans(p, n=3, seed=0):
    """Seeded plans inside the box, batch rows near their day sums."""
    rng = np.random.default_rng(seed)
    lo, hi = p.bounds()
    return [lo + (hi - lo) * rng.uniform(0.2, 0.8, lo.shape)
            for _ in range(n)]


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


def _jax_eval(fn, D, dtype):
    """fn(D) in the JAX package at `dtype` (x64 on for float64)."""
    with jax.enable_x64(dtype == "float64"):
        return np.asarray(fn(jnp.asarray(D, dtype)))


def _jax_grad(fn, D, dtype, jac=False):
    with jax.enable_x64(dtype == "float64"):
        f = jax.jacrev(lambda x: jnp.atleast_1d(fn(x))) if jac \
            else jax.grad(fn)
        return np.asarray(f(jnp.asarray(D, dtype)))


def _torch_eval(fn, D, dtype):
    with torch.no_grad():
        return fn(torch.as_tensor(D, dtype=getattr(torch, dtype))).numpy()


def _torch_grad(fn, D, dtype, jac=False):
    x = torch.as_tensor(D, dtype=getattr(torch, dtype))
    if jac:
        return torch.func.jacrev(lambda y: torch.atleast_1d(fn(y)))(x
                                                                    ).numpy()
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(fn(x), x)
    return g.numpy()


TERMS = {
    "penalties": lambda p: p.penalties,
    "penalties_kinked": lambda p: lambda D: p.penalties(D, smooth=0.0),
    "total_penalty": lambda p: p.total_penalty,
    "carbon_per_workload": lambda p: p.carbon_reduction_per_workload,
    "carbon": lambda p: p.carbon_reduction,
    "peak": lambda p: p.peak,
    "soft_peak": lambda p: p.soft_peak,
    "day_sums": lambda p: p.day_sums,
    "preservation_residual": lambda p: p.preservation_residual,
    "project_preservation": lambda p: p.project_preservation,
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("term", sorted(TERMS))
def test_problem_terms_match_jax(problems, term, dtype):
    jp, tp = problems
    for D in _plans(jp):
        D = D.astype(dtype)
        _close(_torch_eval(TERMS[term](tp), D, dtype),
               _jax_eval(TERMS[term](jp), D, dtype), dtype)


def test_problem_views_match_jax(problems):
    jp, tp = problems
    for name in ("usage", "entitlements", "batch_mask", "bounds"):
        got, want = getattr(tp, name), getattr(jp, name)
        if callable(got):
            got, want = got(), want()
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (tp.W, tp.T, tp.num_days, tp.names) == (jp.W, jp.T, jp.num_days,
                                                   jp.names)
    assert tp.capacity_limit == jp.capacity_limit
    assert tp.total_carbon_baseline == jp.total_carbon_baseline


def test_cr2_targets_match_jax(problems):
    jp, tp = problems
    upper = 0.8 * jp.bounds()[1]
    for up in (None, upper):
        want = jpol.cr2_reference_losses(jp, 0.78, up)
        got = tpol.cr2_reference_losses(tp, 0.78, up, device="cpu")
        _close(got, want, "float32")


def _specs(mod, p, base, cpu=False):
    kw = {"device": "cpu"} if cpu else {}
    return {
        "cr1": lambda: mod.cr1_spec(p, 1.45),
        "cr2": lambda: mod.cr2_spec(p, 0.78, **kw),
        "cr3_w0": lambda: mod.cr3_workload_spec(p, 0, 0.02),
        "cr3_w2": lambda: mod.cr3_workload_spec(p, 2, 0.015, 0.25),
        "cr3_w3": lambda: mod.cr3_workload_spec(p, 3, 0.02),
        "b2": lambda: base.b2_spec(p, 1.3),
        "b4": lambda: base.b4_spec(p, 0.1),
    }


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("spec", ["cr1", "cr2", "cr3_w0", "cr3_w2",
                                  "cr3_w3", "b2", "b4"])
def test_spec_objective_gradient_and_constraints_match_jax(
        problems, spec, dtype, monkeypatch):
    jp, tp = problems
    js = _specs(jpol, jp, jbase)[spec]()
    if spec == "cr2":        # both packages hold the same targets
        refs = jpol.cr2_reference_losses(jp, 0.78)
        monkeypatch.setattr(tpol, "cr2_reference_losses",
                            lambda *a, **k: refs)
    ts = _specs(tpol, tp, tbase, cpu=True)[spec]()
    assert ts.name == js.name
    for field in ("free", "lower", "upper"):
        a, b = getattr(ts, field), getattr(js, field)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (len(ts.eq_constraints), len(ts.ineq_constraints)) == (
        len(js.eq_constraints), len(js.ineq_constraints))
    for D in _plans(jp, n=2, seed=3):
        D = D.astype(dtype)
        _close(_torch_eval(ts.objective, D, dtype),
               _jax_eval(js.objective, D, dtype), dtype)
        _close(_torch_grad(ts.objective, D, dtype),
               _jax_grad(js.objective, D, dtype), dtype)
        for tc, jc in zip(ts.eq_constraints + ts.ineq_constraints,
                          js.eq_constraints + js.ineq_constraints):
            _close(_torch_eval(tc, D, dtype), _jax_eval(jc, D, dtype), dtype)
            _close(_torch_grad(tc, D, dtype, jac=True),
                   _jax_grad(jc, D, dtype, jac=True), dtype)


@pytest.mark.parametrize("F", [0.55, 0.75, 0.9])
def test_b1_adjustments_match_jax_exactly(problems, F):
    jp, tp = problems
    np.testing.assert_array_equal(tbase.b1_adjustments(tp, F),
                                  jbase.b1_adjustments(jp, F))


@pytest.mark.parametrize("depth,max_cut,priority", [
    (0.1, 0.2, None), (0.3, 0.3, None), (0.6, 0.3, None),
    (0.3, 0.2, ("RTS2", "RTS1"))])
def test_b3_adjustments_match_jax_exactly(problems, depth, max_cut,
                                          priority):
    jp, tp = problems
    np.testing.assert_array_equal(
        tbase.b3_adjustments(tp, depth, max_cut, priority),
        jbase.b3_adjustments(jp, depth, max_cut, priority))


def test_cr3_fiscal_balance_matches_jax(problems):
    jp, tp = problems
    for D in _plans(jp, n=2, seed=5):
        assert tpol.cr3_fiscal_balance(tp, D, 0.02, 0.2) == \
            jpol.cr3_fiscal_balance(jp, D, 0.02, 0.2)


def test_penalty_constants_follow_the_plan_dtype(problems):
    """A float64 plan is scored in float64 throughout; float32 stays
    float32, as the fleet paths take it."""
    _, tp = problems
    D = _plans(tp, n=1)[0]
    for dt in (torch.float32, torch.float64):
        assert tp.penalties(torch.as_tensor(D, dtype=dt)).dtype == dt
        assert tp.soft_peak(torch.as_tensor(D, dtype=dt)).dtype == dt
