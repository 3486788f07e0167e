"""`repro_torch.analysis`: the port's correctness tooling.

Two halves, as in the JAX package's `repro.analysis`:

  * **drlint** (`.lint` / `.rules`): an AST pass over the port's tree
    for the invariants a CUDA-graph capture needs (no host sync and no
    host copy in code a day capture reaches) and for tuple seeding,
    with per-rule suppression comments. Run it with
    ``python -m repro_torch.analysis.lint``.
  * **runtime guards** (`.sanitize` / `.recompile`):
    `SolveContext(sanitize=True)` records non-finite checks on a device
    flag through the CR1/CR2 solves and days, and `recompile_guard()`
    asserts that a warm region captures no graph and builds no kernel.
"""
from repro_torch.analysis.recompile import (RecompileError, RecompileStats,
                                            recompile_guard)
from repro_torch.analysis.sanitize import (SanitizeError, Sanitizer,
                                           check_all_finite, checked)

__all__ = ["RecompileError", "RecompileStats", "SanitizeError", "Sanitizer",
           "check_all_finite", "checked", "recompile_guard"]
