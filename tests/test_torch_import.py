"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package; entry points want the
card unless the caller asks for the CPU."""
import ast
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.api import CR1, solve
from repro_torch.core.fleet_solver import FleetProblem

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _is_foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_port_module_loads_no_jax_or_reference():
    mods = _port_modules()
    for m in ("core.api", "kernels.al_step.kernel", "kernels.rmsnorm.ops",
              "kernels.flash_attention.ops", "configs.stablelm_3b",
              "models.transformer", "launch.serve", "configs.mamba2_780m",
              "kernels.ssd_scan.kernel", "kernels.ssd_scan.ops",
              "kernels.ssd_scan.ref", "models.ssm", "core.streaming",
              "core.daygraph", "core.scenario", "core.ensemble",
              "core.policies", "core.baselines", "core.solver",
              "core.fleet", "power.model", "core.regional",
              "core.migration", "obs", "obs.events", "obs.telemetry",
              "obs.spans", "obs.report", "analysis", "analysis.sanitize",
              "analysis.recompile", "analysis.rules", "analysis.lint",
              "optim", "optim.adamw", "data.pipeline", "runtime",
              "runtime.checkpoint", "runtime.ft", "launch.steps",
              "launch.train", "kernels.rmsnorm.grad",
              "kernels.flash_attention.grad", "launch.analytics",
              "configs.jamba_v0_1_52b"):
        assert f"repro_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(repr(bad))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_reference(path):
    """Static check, so imports inside functions count too."""
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if _is_foreign(n)] == []


def _tiny_problem():
    T = 48
    return FleetProblem(
        usage=np.full((2, T), 2.0), entitlement=np.array([3.0, 3.0]),
        k=np.array([1.0, 1.0]), rts_coeffs=np.array([[6.3, -13.0, 51.6],
                                                     [0.0, 0.0, 0.0]]),
        betas=np.array([[0.0, 0.0, 0.0], [0.1, 0.02, 0.01]]),
        x2_kind=np.zeros(2), jobs=np.ones((2, T)),
        is_batch=np.array([False, True]), mci=np.linspace(300, 400, T))


def _tiny_dr():
    """The tiny fleet as the SLSQP reference's per-workload problem."""
    return _tiny_problem().to_problem()


def test_solve_wants_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(_tiny_problem(), CR1())


@pytest.mark.parametrize("entry", [
    "cr2_reference_fleet", "fit_lasso_cv", "init_params", "init_cache",
    "transformer_params_from_arrays", "init_params_ssm", "init_cache_ssm",
    "solve_day", "rolling_horizon_step", "sweep", "ensemble",
    "streaming_ensemble", "cr3", "b1", "b3", "solve_slsqp", "solve_adam",
    "solve_cr3", "cr2_spec", "coordinator_plan", "train",
    "adamw_state_from_arrays"])
def test_other_entry_points_want_the_card_by_default(entry, tmp_path):
    """Entry points below `solve`, and the model's, take the card too when
    no device is named, and raise without one rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import transformer_params_from_arrays
    from repro_torch.core.fleet_solver import cr2_reference_fleet
    from repro_torch.core import policies, solver
    from repro_torch.core.api import ensemble, solve_day, sweep
    from repro_torch.core.carbon import ForecastStream, caiso_2021
    from repro_torch.core.fleet import FleetCoordinator, FleetJob
    from repro_torch.power.model import JobPowerModel
    from repro_torch.core.ensemble import run_streaming_ensemble
    from repro_torch.core.lasso import fit_lasso_cv
    from repro_torch.core.streaming import RollingHorizonSolver
    from repro_torch.models import transformer as tf
    from repro_torch.configs.base import ShapeCell
    from repro_torch.convert import adamw_state_from_arrays
    from repro_torch.launch.train import train
    rng = np.random.default_rng(0)
    cfg = reduced(get_config("stablelm-3b"))
    ssm_cfg = reduced(get_config("mamba2-780m"))
    calls = {
        "cr2_reference_fleet": lambda: cr2_reference_fleet(_tiny_problem(),
                                                           0.78),
        "fit_lasso_cv": lambda: fit_lasso_cv(rng.normal(size=(20, 3)),
                                             rng.normal(size=20)),
        "init_params": lambda: tf.init_params(cfg),
        "init_cache": lambda: tf.init_cache(cfg, 2, 8),
        "transformer_params_from_arrays": lambda: (
            transformer_params_from_arrays({"ln_f": {"scale": np.ones(4)}})),
        "init_params_ssm": lambda: tf.init_params(ssm_cfg),
        "init_cache_ssm": lambda: tf.init_cache(ssm_cfg, 2, 8),
        "solve_day": lambda: solve_day(
            _tiny_problem(), CR1(), np.stack([_tiny_problem().mci] * 2)),
        "rolling_horizon_step": lambda: RollingHorizonSolver(
            _tiny_problem(), ForecastStream.caiso(n_ticks=2)).step(),
        "sweep": lambda: sweep(_tiny_problem(), [CR1(lam=1.0), CR1()]),
        "ensemble": lambda: ensemble(_tiny_problem(), CR1(), "duck_perturb"),
        "streaming_ensemble": lambda: run_streaming_ensemble(
            _tiny_problem(), CR1(), [ForecastStream.caiso(n_ticks=2)]),
        "cr3": lambda: solve(_tiny_problem(), "cr3"),
        "b1": lambda: solve(_tiny_problem(), "b1"),
        "b3": lambda: solve(_tiny_problem(), "b3"),
        "solve_slsqp": lambda: solver.solve_slsqp(
            policies.cr1_spec(_tiny_dr(), 1.45), maxiter=1),
        "solve_adam": lambda: solver.solve_adam(
            policies.cr1_spec(_tiny_dr(), 1.45)),
        "solve_cr3": lambda: solver.solve_cr3(_tiny_dr(), 0.02),
        "cr2_spec": lambda: policies.cr2_spec(_tiny_dr(), 0.78),
        "coordinator_plan": lambda: FleetCoordinator(
            [FleetJob("t", "train", JobPowerModel("t", 8, 0.5, 1.0))],
            caiso_2021(48)).plan(),
        "train": lambda: train(cfg, ShapeCell("t", 8, 2, "train"), 1,
                               str(tmp_path)),
        "adamw_state_from_arrays": lambda: adamw_state_from_arrays(
            {"m": {}, "v": {}, "step": 0}),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_solve_on_cpu_when_asked():
    from repro_torch.core.api import SolveContext
    r = solve(_tiny_problem(), CR1(), ctx=SolveContext(device="cpu",
                                                       steps=5))
    assert r.D.shape == (2, 48) and np.isfinite(r.D).all()


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """Alone in a directory, or on a machine without CUDA, chip_smoke.py
    exits nonzero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
            capture_output=True, text=True, timeout=300))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


WANT = {"al_step": 2094, "dr_features": 192}
SHORT = {"al_step": 2094, "dr_features": 191}


@pytest.mark.parametrize("traces,ok", [
    ([(WANT, 12443)], True),
    ([(SHORT, 12442), (WANT, 12443)], True),        # a lost record
    ([(SHORT, 12442), (SHORT, 12441), (WANT, 12443)], True),
    ([(SHORT, 12443), (WANT, 12443)], False),       # nothing lost
    ([(SHORT, 12442)] * 3, False),                  # never complete
    ([({"al_step": 2094, "dr_features": 193}, 12444)], False),
])
def test_chip_smoke_device_launches_tells_lost_records_from_launches(
        monkeypatch, traces, ok):
    """chip_smoke's trace count of a replay's launches takes a short
    trace again, and lets it go only when it holds fewer device records
    than the trace that reads the expected launches."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    it = iter(traces)
    monkeypatch.setattr(cs, "_traced_launches",
                        lambda torch, fn, names: next(it))
    if ok:
        assert cs.device_launches(torch, "day", lambda: None, WANT) == WANT
    else:
        with pytest.raises(AssertionError, match="day: the device ran"):
            cs.device_launches(torch, "day", lambda: None, WANT)
