"""Span timing and profiler hooks: measure compute, not launch.

CUDA launches are asynchronous: `fn(x)` returns once its kernels are
queued, so a `perf_counter` pair around it times the Python side, not
the device. `span` synchronizes first: bind the outputs the span covers
and it synchronizes the CUDA device of every tensor among them before
it reads the clock on exit::

    with obs.span("cr1-solve", writer=w) as sp:
        sp.bind(solve(problem, CR1(lam=1.45)))
    print(sp.elapsed_s)

These are host-side tools. Never call `span` (or anything else that
waits for the device) in code a CUDA-graph capture runs: drlint's
`host-sync-in-capture` rule fires on exactly that; in-solve telemetry
writes device buffers instead (`repro_torch.obs.telemetry`).

`profile(dir)` wraps `torch.profiler.profile` (CPU and, where there is
one, CUDA activity) and writes a Chrome trace into `dir`;
`compile_count()` is `analysis.recompile_guard(None)`, the graph-capture
and kernel-build counters in measurement mode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Optional

from repro_torch.obs.events import EventWriter, SpanEvent

__all__ = ["span", "SpanScope", "profile", "compile_count"]

# Host time a CUDA profiling session holds on each side of its block, and
# the spin kernels it runs before the block (PROFILE_FILL_CYCLES clock
# cycles each).
PROFILE_PAD_S = 0.25
PROFILE_FILL, PROFILE_FILL_CYCLES = 256, 100_000


@dataclasses.dataclass
class SpanScope:
    """Live handle yielded by `span`; read `elapsed_s` after the block."""
    name: str
    elapsed_s: float = 0.0
    _bound: tuple = ()

    def bind(self, *values: Any) -> Any:
        """Attach outputs to synchronize on at span exit.

        Returns the single value (or the tuple) unchanged, so a call site
        can wrap an expression in line::

            result = sp.bind(solve(...))
        """
        self._bound = self._bound + values
        return values[0] if len(values) == 1 else values


def _cuda_devices(value: Any, out: set) -> set:
    """The CUDA devices of the tensors in `value`: tensors, nested
    tuples, lists and dicts, and dataclasses such as `FleetSolveResult`
    or `EngineState`."""
    if hasattr(value, "is_cuda") and hasattr(value, "device"):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)
    return out


@contextlib.contextmanager
def span(name: str, *, writer: Optional[EventWriter] = None,
         meta: dict | None = None):
    """Time a block on a monotonic clock, device-synchronized on exit.

    Every CUDA device that holds a tensor passed to the scope's
    `.bind(...)` is synchronized before the closing timestamp, so the
    span covers the device work those values depend on. With nothing
    bound on the card the span is a plain wall-clock timer.

    With `writer`, a `SpanEvent` is appended on exit, also when the
    body raises (the partial timing is still real).
    """
    scope = SpanScope(name=name)
    t0 = time.perf_counter()
    try:
        yield scope
    finally:
        devices = _cuda_devices(scope._bound, set())
        if devices:
            import torch
            for dev in devices:
                torch.cuda.synchronize(dev)
        scope.elapsed_s = time.perf_counter() - t0
        if writer is not None:
            writer.write(SpanEvent(name=name, elapsed_s=scope.elapsed_s,
                                   meta=meta))


@contextlib.contextmanager
def profile(logdir, *, name: str = "trace.json"):
    """`torch.profiler.profile` around any lane, CPU and CUDA activity
    (CUDA where the host has a device), written as a Chrome trace to
    `logdir/name` on exit. Yields the profiler, whose `key_averages()`
    and `events()` stay readable after the block::

        with obs.profile("var/profile"):
            solve_day(problem, CR1(lam=1.45), mci_stack)

    With CUDA traced, the session waits for the device and holds
    `PROFILE_PAD_S` of host time on each side of the block: the profiler
    keeps only the device records that lie inside its window on the
    host's clock, and late in a long process the card's timestamps can
    stand late on it, which lost a block's tail of records, or all of a
    short block's. Such a trace can also lose its head, up to its first
    ~50 device records, so the session then runs `PROFILE_FILL` spin
    kernels (`spin_kernel` in the trace, ~13 ms on an H100) before the
    block, and a loss there takes them instead of the block's records.
    """
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(os.fspath(logdir), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            time.sleep(PROFILE_PAD_S)
            for _ in range(PROFILE_FILL):
                torch.cuda._sleep(PROFILE_FILL_CYCLES)
            torch.cuda.synchronize()
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
    prof.export_chrome_trace(os.path.join(os.fspath(logdir), name))


def compile_count(label: str = ""):
    """Count graph captures and kernel builds in a region without a
    budget: `analysis.recompile.recompile_guard(None)`. Yields a live
    `RecompileStats`; read `.captures` / `.builds` after the block.
    Nests inside (or around) a failing-mode guard."""
    from repro_torch.analysis.recompile import recompile_guard

    return recompile_guard(None, label=label)
