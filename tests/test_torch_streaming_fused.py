"""Rolling-horizon streaming on the fused path, on the CPU: the port's
`RollingHorizonSolver` and `solve_day` with `use_kernel=True` (the
`al_step` and `dr_features` plain versions here) against the JAX
package's fused path (its Pallas kernels in interpret mode), on the
fleet and forecasts of `test_torch_streaming.py`, at its tolerances.

A file of its own: the JAX package compiles its interpret-mode kernel
for every solve and day configuration (~5 s each on the CPU).
"""
import pytest

from test_torch_streaming import (POLICIES, check_day, check_rts_only,
                                  check_run, check_scan, fleet16,
                                  make_runs)

__all__ = ["fleet16"]     # the shared module-scoped fixture


@pytest.fixture(scope="module", params=POLICIES)
def runs(request, fleet16):
    return make_runs(fleet16, request.param, True)


def test_fused_run_matches_reference(runs):
    check_run(*runs[:2])


def test_fused_run_scanned_matches_run(runs):
    check_scan(*runs[1:])


@pytest.mark.parametrize("policy", POLICIES)
def test_fused_solve_day_matches_reference(fleet16, policy):
    """A cold day, then the next day warm-started from it."""
    check_day(fleet16, policy, True, days=2)


@pytest.mark.parametrize("policy", POLICIES)
def test_fused_rts_only_committed_hours_match_reference(fleet16, policy):
    check_rts_only(fleet16, policy, True)
