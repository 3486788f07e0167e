"""`recompile_guard`: assert that a region compiles nothing, at runtime.

In the JAX package "recompile" means a jit trace or an XLA lowering. In
the port, what can compile on a warm path is:

  * a CUDA-graph capture: `solve_day` captures its day once per static
    configuration (`core/daygraph.py`, `CAPTURES`), then replays; and
  * a kernel library build or load: `kernels/build.py` compiles a
    `csrc/*.cu` with `nvcc` and loads it with `ctypes` (`BUILDS`).

The claims are the JAX package's: a warm re-solve compiles nothing, and
a day of a configuration already seen is one replay with no capture::

    with recompile_guard() as stats:          # max_compiles=0
        solver.run_scanned(24)                 # must replay the graph
    # raises RecompileError on exit if anything was captured or built

The guard reads the module-level counters those two modules increment
(nothing is monkeypatched), so guards nest: each one counts the
difference between its entry and its exit. It fires when either count
exceeds `max_compiles` on normal exit (an exception inside the body
propagates unchanged); `max_compiles=None` only measures.
"""
from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["RecompileError", "RecompileStats", "recompile_guard"]


class RecompileError(RuntimeError):
    """A `recompile_guard` region compiled more than it promised."""


@dataclasses.dataclass
class RecompileStats:
    """Counts for one guard region (updated live while it runs)."""
    captures: int = 0      # CUDA-graph captures (day-graph cache misses)
    builds: int = 0        # kernel library builds and loads

    @property
    def compiled(self) -> bool:
        return self.captures > 0 or self.builds > 0


def _counters() -> tuple[int, int]:
    from repro_torch.core import daygraph
    from repro_torch.kernels import build
    return daygraph.CAPTURES, build.BUILDS


@contextlib.contextmanager
def recompile_guard(max_compiles: int | None = 0, *, label: str = ""):
    """Count graph captures and kernel builds in the region; raise if over
    budget.

    Args:
      max_compiles: fail on exit when `captures` or `builds` exceeds
        this. 0 (default) asserts the region compiles nothing, the
        warm-path contract; None only measures.
      label: prefix for the error message (e.g. the tick being run).

    Yields a `RecompileStats`, filled in on exit.
    """
    stats = RecompileStats()
    c0, b0 = _counters()
    try:
        yield stats
    finally:
        c1, b1 = _counters()
        stats.captures, stats.builds = c1 - c0, b1 - b0
    if max_compiles is not None and (stats.captures > max_compiles
                                     or stats.builds > max_compiles):
        where = f"{label}: " if label else ""
        raise RecompileError(
            f"{where}guarded region compiled: {stats.captures} graph "
            f"capture(s), {stats.builds} kernel build(s) (allowed "
            f"{max_compiles}) — a static configuration, shape or dtype "
            f"drifted and the graph cache missed")
