"""The port's correctness tooling (`repro_torch.analysis`), on the CPU: the
sanitizer against the JAX package's checkify lane (the same site and array
named for the same NaN, on the generic and the fused path, in a solve and
in a day), its own contracts (sanitize on is bitwise off, the refusals,
the device flag), `recompile_guard` through the capture and build
counters, and drlint for the port's tree (each rule, the suppressions,
the registry, the shipped tree, the CLI).

The fleet is `tests/test_torch_solve.py`'s 16 rows (the paper fleet
calibrated small, the JAX package's job traces seeded with the port's
stable hash). The JAX package runs its fused path in Pallas interpret
mode, the port its al_step plain version.
"""
import dataclasses
import pathlib
import re
import textwrap

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.fleet_solver import synthetic_fleet
from repro_torch.analysis import (RecompileError, SanitizeError, Sanitizer,
                                  check_all_finite, checked, recompile_guard)
from repro_torch.analysis.lint import lint_paths, main as lint_main
from repro_torch.analysis.rules import RULES, lint_source
from repro_torch.core import api as tapi
from torch_region_fleets import carry, paper_templates

SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SITE = re.compile(r"(al-[\w-]+): non-finite values in (\w+)")
POLICIES = {"cr1": (japi.CR1(lam=1.45), tapi.CR1(lam=1.45)),
            "cr2": (japi.CR2(cap_frac=0.78, outer=2),
                    tapi.CR2(cap_frac=0.78, outer=2))}


@pytest.fixture(scope="module")
def fleet16():
    jt, _ = paper_templates()
    p = synthetic_fleet(16, hours=48, seed=0, templates=jt)
    return p, carry(p)


def _stack(p, n=3):
    rng = np.random.default_rng((11, 4))
    base = np.asarray(p.mci, float)
    return np.stack([np.roll(base, -i) * (1 + 0.01 * rng.standard_normal(
        base.shape)) for i in range(n)])


def _site(exc) -> tuple[str, str]:
    m = SITE.search(str(exc))
    assert m, str(exc)
    return m.groups()


# ---------------------------------------------------------------------------
# The sanitizer against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["generic", "fused"])
@pytest.mark.parametrize("entry", ["solve", "day"])
def test_sanitize_names_the_jax_site(fleet16, entry, use_kernel):
    """A NaN in the carbon trace (a solve's hour 3, a 3-tick day's tick 1)
    raises `SanitizeError` naming the site and array the JAX package's
    checkify lane names; without the sanitizer the port returns NaNs.
    The fused day runs CR2 only (each interpret-mode day of the JAX
    package compiles for ~10 s; CR2's day also rounds its multipliers)."""
    p, tp = fleet16
    names = ["cr2"] if entry == "day" and use_kernel else sorted(POLICIES)
    for name in names:
        jpol, tpol = POLICIES[name]
        jctx = japi.SolveContext(sanitize=True, use_kernel=use_kernel)
        tctx = tapi.SolveContext(device="cpu", sanitize=True,
                                 use_kernel=use_kernel)
        if entry == "solve":
            mci = np.asarray(p.mci, float).copy()
            mci[3] = np.nan
            jp, q = dataclasses.replace(p, mci=mci), dataclasses.replace(
                tp, mci=mci)
            silent = tapi.solve(q, tpol, ctx=dataclasses.replace(
                tctx, sanitize=False, steps=8))
            with pytest.raises(Exception) as want:
                japi.solve(jp, jpol, ctx=dataclasses.replace(jctx, steps=8))
            with pytest.raises(SanitizeError) as got:
                tapi.solve(q, tpol, ctx=dataclasses.replace(tctx, steps=8))
            assert np.isnan(silent.D).any()
        else:
            stack = _stack(p)
            stack[1, 5] = np.nan
            kw = dict(cold_steps=8, warm_steps=8)
            silent = tapi.solve_day(tp, tpol, stack, ctx=dataclasses.replace(
                tctx, sanitize=False), **kw)
            with pytest.raises(Exception) as want:
                japi.solve_day(p, jpol, stack, ctx=jctx, **kw)
            with pytest.raises(SanitizeError) as got:
                tapi.solve_day(tp, tpol, stack, ctx=tctx, **kw)
            assert np.isnan(silent.committed).any()
        assert "non-finite" in str(want.value), name
        assert _site(got.value) == _site(want.value), name
        assert _site(got.value)[0] == ("al-fused-inner" if use_kernel
                                       else "al-inner")


# ---------------------------------------------------------------------------
# The port's own sanitizer contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["generic", "fused"])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_sanitize_on_is_bitwise_off(fleet16, policy, use_kernel):
    _, tp = fleet16
    tpol = POLICIES[policy][1]
    ctx = tapi.SolveContext(device="cpu", use_kernel=use_kernel, steps=40)
    plain = tapi.solve(tp, tpol, ctx=ctx)
    checked_ = tapi.solve(tp, tpol, ctx=dataclasses.replace(ctx,
                                                            sanitize=True))
    np.testing.assert_array_equal(plain.D, checked_.D)
    for f in ("x", "lam_eq", "lam_in", "mu"):
        assert torch.equal(getattr(plain.state, f),
                           getattr(checked_.state, f))
    stack, kw = _stack(tp), dict(cold_steps=24, warm_steps=8)
    day = tapi.solve_day(tp, tpol, stack, ctx=ctx, **kw)
    day_s = tapi.solve_day(tp, tpol, stack, ctx=dataclasses.replace(
        ctx, sanitize=True), **kw)
    np.testing.assert_array_equal(day.committed, day_s.committed)
    assert torch.equal(day.last.state.x, day_s.last.state.x)


def test_sanitize_refuses_unsupported_combos(fleet16):
    from repro_torch.core.ensemble import evaluate_ensemble
    _, tp = fleet16
    ctx = tapi.SolveContext(device="cpu", sanitize=True, steps=8)
    for pol in (tapi.CR3(), tapi.B1(), tapi.B3()):
        with pytest.raises(NotImplementedError, match="no sanitized lane"):
            tapi.solve(tp, pol, ctx=ctx)
    for field in (dict(donate=True), dict(coupled_migration=True),
                  dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="solo debug lane"):
            tapi.solve(tp, tapi.CR1(), ctx=dataclasses.replace(ctx, **field))
    with pytest.raises(NotImplementedError, match="solo debug lane"):
        tapi.solve_day(tp, tapi.CR1(), _stack(tp, 2),
                       ctx=dataclasses.replace(ctx, donate=True))
    with pytest.raises(NotImplementedError, match="no sanitized lane"):
        tapi.solve_day(tp, tapi.CR3(), _stack(tp, 2), ctx=ctx)
    with pytest.raises(NotImplementedError, match="solo-solve debug lane"):
        tapi.sweep(tp, [tapi.CR1(lam=1.2), tapi.CR1(lam=1.6)], ctx=ctx)
    with pytest.raises(NotImplementedError, match="solo-solve debug lane"):
        tapi.ensemble(tp, tapi.CR1(), "duck_perturb", ctx=ctx)
    with pytest.raises(NotImplementedError, match="solo-solve debug lane"):
        evaluate_ensemble(tp, tapi.CR1(), "duck_perturb", ctx=ctx)


def test_check_all_finite_on_its_own():
    def f(x, sanitizer):
        y = x * 2
        check_all_finite(sanitizer, "unit", y=y)
        check_all_finite(sanitizer, "unit-2", z=y + 1)
        return y

    san, out = checked(f)(torch.ones(4))
    san.throw()                          # clean input: no error
    assert san.code.dtype == torch.int32 and int(san.code) == 0
    assert torch.equal(out, 2 * torch.ones(4))
    san, _ = checked(f)(torch.tensor([1.0, np.inf, 3.0, 4.0]))
    with pytest.raises(SanitizeError, match="unit: non-finite values in y"):
        san.throw()                      # the first failing site wins
    san = Sanitizer("cpu")
    check_all_finite(san, "unit", a=torch.ones(2), b=torch.ones(2))
    check_all_finite(san, "unit", c=torch.tensor([np.nan]))
    with pytest.raises(SanitizeError, match="in c — the solve diverged"):
        san.throw()
    Sanitizer().throw()                  # nothing checked: clean


def test_engine_sanitizer_sites_in_order():
    """al-init before al-inner: a NaN in the warm start names x0."""
    from repro_torch.core.engine import EngineConfig, EngineState, al_minimize
    x0 = torch.tensor([1.0, np.nan])
    init = EngineState.cold(x0)
    for kw, want in ((dict(init=init), "al-init: non-finite values in x0"),
                     (dict(), "al-init: non-finite values in x0")):
        san = Sanitizer()
        al_minimize(lambda x, _: (x * x).sum(), lambda x: x, x0,
                    cfg=EngineConfig(inner_steps=2), sanitizer=san, **kw)
        with pytest.raises(SanitizeError, match=want):
            san.throw()
    san = Sanitizer()
    al_minimize(lambda x, _: (x * x).sum(), lambda x: x, torch.ones(2),
                eq_residual=lambda x, _: x.sum()[None] * np.inf,
                cfg=EngineConfig(inner_steps=2), sanitizer=san)
    with pytest.raises(SanitizeError, match="al-inner: non-finite values "
                                            "in grad"):
        san.throw()


# ---------------------------------------------------------------------------
# recompile_guard: through the capture and build counters
# ---------------------------------------------------------------------------
def test_recompile_guard_measures_and_fires(monkeypatch):
    from repro_torch.core import daygraph
    from repro_torch.kernels import build

    with recompile_guard(None) as stats:
        monkeypatch.setattr(daygraph, "CAPTURES", daygraph.CAPTURES + 1)
    assert stats.captures == 1 and stats.builds == 0 and stats.compiled
    with recompile_guard(0) as stats:
        pass                             # nothing compiled: no error
    assert not stats.compiled
    with pytest.raises(RecompileError, match="forced: guarded region "
                                             "compiled: 0 graph capture"):
        with recompile_guard(0, label="forced"):
            monkeypatch.setattr(build, "BUILDS", build.BUILDS + 2)
    with recompile_guard(None) as outer:       # guards nest
        monkeypatch.setattr(build, "BUILDS", build.BUILDS + 1)
        with pytest.raises(RecompileError):
            with recompile_guard(0):
                monkeypatch.setattr(daygraph, "CAPTURES",
                                    daygraph.CAPTURES + 1)
        with recompile_guard(1) as inner:
            monkeypatch.setattr(daygraph, "CAPTURES", daygraph.CAPTURES + 1)
    assert (outer.captures, outer.builds) == (2, 1)
    assert (inner.captures, inner.builds) == (1, 0)
    with pytest.raises(KeyError):              # the body's error, unchanged
        with recompile_guard(0):
            monkeypatch.setattr(daygraph, "CAPTURES", daygraph.CAPTURES + 1)
            raise KeyError("body")


def test_warm_cpu_solves_and_days_compile_nothing(fleet16):
    """On the CPU nothing is captured or built: the solver's own guard
    runs every warm tick and day under `recompile_guard(0)`."""
    from repro_torch.core.carbon import ForecastStream
    from repro_torch.core.streaming import RollingHorizonSolver
    _, tp = fleet16
    solver = RollingHorizonSolver(
        tp, ForecastStream.caiso(n_ticks=12, horizon=48, seed=1),
        cold_steps=16, warm_steps=4, device="cpu", guard_recompiles=True)
    solver.run(3)
    solver.run_scanned(3)
    solver.run_scanned(3)
    assert ("day", 3, True) in solver._seen
    with recompile_guard(0, label="day 3"):
        solver.run_scanned(3)


# ---------------------------------------------------------------------------
# drlint for the port: one detection per rule, and legal code passes
# ---------------------------------------------------------------------------
def _lint(source: str, path: str = "src/repro_torch/core/api.py"):
    return lint_source(path, textwrap.dedent(source))


def _rules(violations):
    return [v.rule for v in violations]


def test_rule_registry():
    assert set(RULES) == {"host-sync-in-capture", "host-copy-in-capture",
                          "tuple-seed", "deprecated-shim"}
    assert lint_main(["--list-rules"]) == 0


def test_host_sync_in_capture():
    bad = _lint("""
        import torch
        from repro_torch import obs

        def _day_impl(day, inputs):
            x = inputs["x"]
            n = int(x.sum())
            torch.cuda.synchronize()
            with obs.span("tick"):
                y = helper(x)
            return y.item(), x.cpu(), x.numpy(), x.tolist(), float(y), n

        def helper(x):
            return bool(x.any())
    """)
    assert _rules(bad) == ["host-sync-in-capture"] * 9
    assert "`int()`" in bad[0].message and "_day_impl" in bad[0].message
    assert "`bool()`" in bad[-1].message and "helper" in bad[-1].message
    ok = _lint("""
        import torch

        def _day_impl(day, inputs):
            x = inputs["x"]
            n = int(x.shape[0]) + len(inputs) + float(2)
            return torch.full((n,), day.lam, device=x.device)

        def host_side(result):
            torch.cuda.synchronize()
            return result.cpu().numpy(), float(result.sum())
    """)
    assert ok == []


def test_host_copy_in_capture():
    bad = _lint("""
        import numpy as np
        import torch

        def al_minimize(objective, x0):
            a = torch.tensor([1.0, 2.0])
            b = torch.as_tensor(0.5, device=x0.device)
            c = torch.as_tensor(np.ones(3), device=x0.device)
            d = np.exp(2.0)
            return a, b, c, d
    """, path="src/repro_torch/core/engine.py")
    assert _rules(bad) == ["host-copy-in-capture"] * 5
    ok = _lint("""
        import numpy as np
        import torch

        def al_minimize(objective, x0, mu):
            n = np.ndim(x0)
            return torch.as_tensor(mu, device=x0.device), torch.zeros(n)

        def report(D):
            return torch.tensor(np.asarray(D))
    """, path="src/repro_torch/core/engine.py")
    assert ok == []
    # the same call outside every capture root is host code
    assert _lint("""
        import torch

        def al_minimize(x):
            return torch.tensor([1.0])
    """, path="src/repro_torch/core/other.py") == []


def test_tuple_seed():
    bad = _lint("""
        import numpy as np
        import torch

        def batch(seed, step):
            torch.manual_seed(seed + step)
            return np.random.default_rng(seed * 4093 + step)
    """)
    assert _rules(bad) == ["tuple-seed", "tuple-seed"]
    ok = _lint("""
        import numpy as np

        def batch(seed, step, host):
            return np.random.default_rng((seed, step, host))
    """)
    assert ok == []


def test_deprecated_shim():
    bad = _lint("""
        from repro_torch.core.fleet_solver import solve_cr1_fleet

        def run(p):
            return solve_cr1_fleet(p, lam=1.4)
    """, path="src/repro_torch/core/ensemble.py")
    assert _rules(bad) == ["deprecated-shim"]
    assert _lint("""
        def caller(p):
            return solve_cr2_fleet(p)
    """, path="src/repro_torch/core/fleet_solver.py") == []


# ---------------------------------------------------------------------------
# drlint: suppressions
# ---------------------------------------------------------------------------
def test_suppression_with_rationale_on_the_line_above():
    assert _lint("""
        def _day_impl(day, inputs):
            # drlint: disable=host-sync-in-capture -- day.n is a host int
            return int(day.n)
    """) == []


def test_suppression_same_line_and_multi_rule():
    assert _lint("""
        import numpy as np

        def _day_impl(day, inputs):
            return float(np.sum(day.w))  # drlint: disable=host-sync-in-capture,host-copy-in-capture -- host-side config
    """) == []


def test_suppression_without_rationale_is_a_violation():
    vs = _lint("""
        def _day_impl(day, inputs):
            # drlint: disable=host-sync-in-capture
            return int(day.n)
    """)
    assert _rules(vs) == ["suppression-rationale"]


def test_suppression_does_not_reach_two_lines_down():
    vs = _lint("""
        def _day_impl(day, inputs):
            # drlint: disable=host-sync-in-capture -- too far away
            y = 1
            return int(day.n) + y
    """)
    assert _rules(vs) == ["host-sync-in-capture"]


# ---------------------------------------------------------------------------
# drlint: the shipped tree and the CLI
# ---------------------------------------------------------------------------
def test_shipped_tree_lints_clean():
    """src/repro_torch has no unsuppressed violation, and every
    suppression in it carries a rationale."""
    vs = lint_paths([str(SRC)])
    assert vs == [], "\n".join(v.format() for v in vs)
    sups = [line for f in SRC.rglob("*.py")
            for line in f.read_text().splitlines() if "drlint: disable" in line]
    assert sups and all(" -- " in line for line in sups)


def test_capture_roots_name_functions_that_exist():
    """Every root of `EXTRA_CAPTURE_ROOTS` names a function of its module,
    so a rename cannot silently take code out of the check."""
    import ast
    from repro_torch.analysis.rules import EXTRA_CAPTURE_ROOTS
    for suffix, names in EXTRA_CAPTURE_ROOTS.items():
        tree = ast.parse((SRC / suffix).read_text())
        defined = {n.name for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)}
        assert names <= defined, (suffix, names - defined)


def test_cli_exit_and_format(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import numpy as np
        rng = np.random.default_rng(7 * 1000 + 3)
    """))
    assert lint_main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"{bad}:3:" in out and "tuple-seed" in out
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint_main([str(good)]) == 0
    assert lint_main([]) == 0            # the shipped tree, by default
    with pytest.raises(FileNotFoundError):
        lint_main([str(tmp_path / "notes.txt")])
