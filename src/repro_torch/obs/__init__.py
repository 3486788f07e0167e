"""repro_torch.obs: structured observability for the port's fleet engine.

Four pieces, one schema (the JAX package's `repro.obs`, whose ledgers
this package reads and whose readers read this package's):

  * `TelemetryConfig` / `ConvergenceTrace`: in-solve convergence
    telemetry, written into preallocated device buffers inside the
    generic AL loop and surfaced as `result.extras["telemetry"]`
    (`SolveContext(telemetry=TelemetryConfig(every=10))`).
  * `EventWriter` / `read_events`: an append-only, schema-versioned
    JSONL ledger of typed events (streaming ticks, spans, telemetry
    samples).
  * `span` / `profile` / `compile_count`: host-side timing that
    synchronizes the CUDA device before reading the clock, a
    `torch.profiler` trace, and the capture and kernel-build counters.
  * `python -m repro_torch.obs.report run.jsonl`: the terminal report
    (convergence curves, tick ledger, spans, recompile audit).

Import discipline: `repro_torch.obs` never imports `repro_torch.core`,
so the engine can depend on it without cycles.
"""
from repro_torch.obs.events import (SCHEMA_VERSION, EventWriter, SpanEvent,
                                    TelemetryEvent, TickEvent, host_meta,
                                    read_events)
from repro_torch.obs.spans import SpanScope, compile_count, profile, span
from repro_torch.obs.telemetry import ConvergenceTrace, TelemetryConfig

__all__ = [
    "SCHEMA_VERSION", "EventWriter", "SpanEvent", "TelemetryEvent",
    "TickEvent", "host_meta", "read_events",
    "SpanScope", "compile_count", "profile", "span",
    "ConvergenceTrace", "TelemetryConfig",
]
