"""The SLSQP reference and the AL-Adam spec solver on the CPU: the port's
`core/solver.py` against the JAX package's `repro.core.solver`, on the
four-workload problem of `test_torch_policies.py`, the same inputs
through both.

The JAX package's solver module does not import on this jax as it
stands (it imports `jax.experimental.enable_x64`, which jax 0.9 moved to
`jax.enable_x64`); the `jsolver` fixture hands it that name for this
file only and takes the module, and `repro.core.fleet`, which imports
it, back out of `sys.modules` afterwards, so every other test sees the
package as it is.

Tolerances: `evaluate` of one plan at float32's 1e-5 (both report in
float32); SLSQP (float64 on both sides) at 0.01 pp of carbon and penalty
with the same iteration count; `solve_adam` (float32 projected Adam, a
chaotic iteration under the hinge) and the SLSQP CR3 driver at 0.05 pp,
the bound the fleet engine is held to against the JAX package.
"""
import dataclasses
import importlib
import sys

import jax
import numpy as np
import pytest

import repro.core
import repro.core.penalty as jpen
from repro.core import baselines as jbase
from repro.core import policies as jpol
from repro.core.carbon import caiso_2021
from repro_torch import convert
from repro_torch.core import baselines as tbase
from repro_torch.core import penalty as tpen
from repro_torch.core import policies as tpol
from repro_torch.core import solver as tsol

ORDER = ("RTS1", "RTS2", "AITraining", "DataPipeline")
SLSQP_PP = 0.01
ADAM_PP = 0.05


@pytest.fixture(scope="module")
def jsolver():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
               raising=False)
    try:
        yield importlib.import_module("repro.core.solver")
    finally:
        mp.undo()
        for name in ("repro.core.fleet", "repro.core.solver"):
            sys.modules.pop(name, None)
            if hasattr(repro.core, name.rsplit(".", 1)[1]):
                delattr(repro.core, name.rsplit(".", 1)[1])


@pytest.fixture(scope="module")
def problems():
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


def _pp(got, want, tol):
    assert abs(got.carbon_reduction_pct - want.carbon_reduction_pct) < tol
    assert abs(got.total_penalty_pct - want.total_penalty_pct) < tol


def test_evaluate_matches_jax(problems, jsolver):
    jp, tp = problems
    lo, hi = jp.bounds()
    D = lo + (hi - lo) * np.random.default_rng(0).uniform(0.3, 0.7, lo.shape)
    for jspec, tspec in ((jpol.cr1_spec(jp, 1.45), tpol.cr1_spec(tp, 1.45)),
                         (jbase.b4_spec(jp, 0.1), tbase.b4_spec(tp, 0.1))):
        want = jsolver.evaluate(jspec, D, "x", 3)
        got = tsol.evaluate(tspec, D, "x", 3, device="cpu")
        assert (got.name, got.solver, got.nit) == (want.name, "x", 3)
        assert sorted(got.violations) == sorted(want.violations)
        for k, v in want.violations.items():
            assert got.violations[k] == pytest.approx(v, rel=1e-5,
                                                      abs=1e-5)
        for f in ("objective", "carbon_reduction", "carbon_reduction_pct",
                  "total_penalty", "total_penalty_pct", "peak"):
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=1e-5, abs=1e-6)
        for f in ("per_penalty", "per_carbon"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["cr1", "cr2"])
def test_slsqp_matches_jax(problems, jsolver, policy):
    jp, tp = problems
    if policy == "cr1":
        jspec, tspec = jpol.cr1_spec(jp, 1.45), tpol.cr1_spec(tp, 1.45)
    else:
        jspec = jpol.cr2_spec(jp, 0.78)
        tspec = tpol.cr2_spec(tp, 0.78, device="cpu")
    want = jsolver.solve_slsqp(jspec, maxiter=60)
    got = tsol.solve_slsqp(tspec, maxiter=60, device="cpu")
    assert got.solver == "slsqp" and got.nit == want.nit
    assert got.D.dtype == np.float64 and np.isfinite(got.D).all()
    _pp(got, want, SLSQP_PP)


def test_adam_matches_jax(problems, jsolver):
    jp, tp = problems
    jcfg = jsolver.AdamALConfig(inner_steps=80, outer_steps=3)
    tcfg = tsol.AdamALConfig(inner_steps=80, outer_steps=3)
    for jspec, tspec in ((jpol.cr1_spec(jp, 1.45), tpol.cr1_spec(tp, 1.45)),
                         (jpol.cr2_spec(jp, 0.78),
                          tpol.cr2_spec(tp, 0.78, device="cpu"))):
        want = jsolver.solve_adam(jspec, jcfg)
        got = tsol.solve_adam(tspec, tcfg, device="cpu")
        assert got.solver == "adam-al" and got.nit == want.nit == 240
        _pp(got, want, ADAM_PP)
        assert got.violations["preservation"] < 1e-3


def test_cr3_driver_matches_jax(problems, jsolver):
    """SLSQP per workload, then the clearing; its result and rho."""
    jp, tp = problems
    want, jrho = jsolver.solve_cr3(jp, rho=0.02)
    got, trho = tsol.solve_cr3(tp, rho=0.02, device="cpu")
    assert got.nit == want.nit and got.name == want.name
    assert trho == pytest.approx(jrho, rel=1e-4)
    _pp(got, want, ADAM_PP)


def test_solvers_want_the_card_by_default(problems):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    _, tp = problems
    spec = tpol.cr1_spec(tp, 1.45)
    for call in (lambda: tsol.solve_slsqp(spec, maxiter=1),
                 lambda: tsol.solve_adam(spec),
                 lambda: tsol.evaluate(spec, np.zeros((4, 48)), "x", 0),
                 lambda: tpol.cr2_spec(tp, 0.78)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
