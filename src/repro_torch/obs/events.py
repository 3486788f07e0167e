"""Structured run events: typed records and an append-only JSONL ledger.

One schema for what the port records: streaming tick ledgers
(`core.streaming`), span timings (`obs.spans`) and per-solve convergence
samples all go through `EventWriter`, and `python -m
repro_torch.obs.report run.jsonl` renders any of them. The layout is the
JAX package's (`repro.obs.events`, schema 1), so a ledger written by
either package reads in the other; only the header's host fingerprint
differs (torch and CUDA fields here, jax fields there).

File format: one JSON object per line. The first record is a header
(`{"kind": "header", "schema": N, "host": {...}, "tags": {...}}`),
written when the writer opens an empty file; `read_events` refuses a
file whose header is missing or whose schema is not `SCHEMA_VERSION`.

Appends are atomic: the file is opened `O_APPEND` and each record goes
down in a single `os.write`, so concurrent writers interleave whole
lines, never bytes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, ClassVar, Optional

__all__ = ["SCHEMA_VERSION", "host_meta", "TickEvent", "SpanEvent",
           "TelemetryEvent", "EventWriter", "read_events"]

SCHEMA_VERSION = 1


def host_meta() -> dict:
    """Host and device fingerprint stamped into ledger headers.

    Imports torch lazily, so the report side can read ledgers without
    it."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "platform": "cuda" if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


@dataclasses.dataclass(frozen=True)
class TickEvent:
    """One streaming tick of the rolling-horizon ledger."""
    kind: ClassVar[str] = "tick"
    tick: int
    revision: float              # ‖forecast − previous shifted‖ / ‖prev‖
    warm_steps: int              # inner-step budget actually spent
    cold: bool                   # True on the cold (tick-0) solve
    objective_proxy: Optional[float]  # carbon_reduction_pct of the plan
    latency_s: float             # wall clock of the solve (0.0 on a
                                 # day's later ticks: one replay ran them)
    committed_carbon: list       # per-region kgCO2 committed this tick
    realized_carbon: list        # per-region kgCO2 at realized MCI
    migration_credit: float      # net kgCO2 saved by cross-region moves
    recompiles: int              # graph captures + kernel builds
    dispatches: int              # solves or day replays issued for it


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One timed span (device-synchronized; see `obs.spans.span`)."""
    kind: ClassVar[str] = "span"
    name: str
    elapsed_s: float
    meta: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One in-solve convergence sample, tagged with its tick."""
    kind: ClassVar[str] = "telemetry"
    tick: int
    step: int
    objective: float
    grad_norm: float
    violation: float
    dx: float
    mu: float


class EventWriter:
    """Append-only JSONL ledger with a schema-versioned header.

    Usage::

        with EventWriter("run.jsonl", tags={"policy": "cr1"}) as w:
            w.write(TickEvent(...))

    The header (schema version, `host_meta()`, tags) is written only
    when the file is empty, so reopening a ledger appends events under
    its original header.
    """

    def __init__(self, path, *, tags: dict | None = None):
        self.path = os.fspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fd = os.open(self.path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        if os.fstat(self._fd).st_size == 0:
            self._write_record({"kind": "header", "schema": SCHEMA_VERSION,
                                "host": host_meta(), "tags": tags or {}})

    def _write_record(self, rec: dict) -> None:
        os.write(self._fd, (json.dumps(rec) + "\n").encode())

    def write(self, event: Any) -> None:
        """Append one event (a typed record dataclass, or a plain dict)."""
        if dataclasses.is_dataclass(event) and not isinstance(event, type):
            rec = {"kind": type(event).kind, **dataclasses.asdict(event)}
        elif isinstance(event, dict):
            if "kind" not in event:
                raise ValueError("dict events need an explicit 'kind'")
            rec = event
        else:
            raise TypeError(
                f"EventWriter.write wants an event dataclass or dict, "
                f"got {type(event).__name__}")
        self._write_record(rec)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_events(path) -> list[dict]:
    """Read a JSONL ledger, validating the schema pin.

    Returns every record (header first). Raises `ValueError` when the
    file has no header record or its schema is not `SCHEMA_VERSION`.
    """
    records = []
    with open(os.fspath(path), "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    if not records or records[0].get("kind") != "header":
        raise ValueError(
            f"{path}: not an event ledger (first record must be a "
            f"'header'; found "
            f"{records[0].get('kind') if records else 'empty file'!r})")
    schema = records[0].get("schema")
    if schema != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: ledger schema {schema!r} != supported "
            f"{SCHEMA_VERSION} — re-record or use a matching reader")
    return records
