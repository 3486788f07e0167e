"""Run report CLI: render a JSONL event ledger as a terminal summary.

    python -m repro_torch.obs.report var/run.jsonl

A copy of the JAX package's report (`repro.obs.report`): the ledgers of
both packages share one schema, and each report renders either. Only two
things name the writer: the header line shows the torch and CUDA fields
of a port ledger and the jax fields of a JAX one, and the recompile
audit counts what that writer counts (graph captures and kernel builds
for the port, jit traces for the JAX package).

Sections (each rendered only when the ledger has matching events):

  * header      — schema, host fingerprint, tags
  * convergence — per-tick ASCII curves of the in-solve telemetry
                  (objective + grad norm sparklines, final violation)
  * tick ledger — revision / budget / latency / carbon table with
                  totals, committed vs realized drift, migration credit
  * spans       — per-name count / total / mean wall time
  * recompiles  — dispatch + compile audit: which ticks compiled, which
                  rode the warm cache

Imports neither torch nor jax, so it runs anywhere the ledger lands.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict

from repro_torch.obs.events import read_events

__all__ = ["main", "render"]

_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(values, width: int = 48) -> str:
    """Downsample to `width` columns and map onto block glyphs."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        # bucket-mean downsample, preserving endpoints
        out = []
        for i in range(width):
            lo = i * len(vals) // width
            hi = max(lo + 1, (i + 1) * len(vals) // width)
            out.append(sum(vals[lo:hi]) / (hi - lo))
        vals = out
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return _BLOCKS[0] * len(vals)
    return "".join(
        _BLOCKS[min(len(_BLOCKS) - 1,
                    int((v - lo) / (hi - lo) * (len(_BLOCKS) - 1)))]
        for v in vals)


def _fmt(x, nd: int = 3) -> str:
    if x is None:
        return "-"
    ax = abs(x)
    if ax != 0 and (ax >= 1e5 or ax < 10 ** -nd):
        return f"{x:.{nd}g}"
    return f"{x:,.{nd}f}"


def _is_port(header: dict) -> bool:
    """True for a ledger the port wrote (its host has a torch field)."""
    return "torch" in (header.get("host") or {})


def _render_header(out, header: dict) -> None:
    host = header.get("host", {})
    tags = header.get("tags") or {}
    out.append(f"ledger schema v{header.get('schema')}")
    where = (f"{host.get('platform', '?')} x{host.get('n_devices', '?')} "
             f"({host.get('device_kind', '?')})")
    if _is_port(header):
        out.append(f"host: {where}, torch {host.get('torch', '?')}, "
                   f"cuda {host.get('cuda') or 'none'}")
    else:
        out.append(
            f"host: {where}, jax {host.get('jax', '?')}"
            + (f", jaxlib {host['jaxlib']}" if host.get("jaxlib") else "")
            + (f", pallas_interpret={host['pallas_interpret']}"
               if host.get("pallas_interpret") else ""))
    if tags:
        out.append("tags: " + ", ".join(f"{k}={v}"
                                        for k, v in sorted(tags.items())))


def _render_convergence(out, tel_events: list[dict]) -> None:
    by_tick = defaultdict(list)
    for ev in tel_events:
        by_tick[ev.get("tick", 0)].append(ev)
    out.append("")
    out.append(f"== convergence ({len(tel_events)} samples, "
               f"{len(by_tick)} solves) ==")
    for tick in sorted(by_tick):
        rows = sorted(by_tick[tick], key=lambda e: e["step"])
        obj = [e["objective"] for e in rows]
        gn = [e["grad_norm"] for e in rows]
        viol = [e["violation"] for e in rows]
        out.append(f"tick {tick}: {len(rows)} samples, "
                   f"steps {rows[0]['step']}..{rows[-1]['step']}, "
                   f"mu {_fmt(rows[0]['mu'])} -> {_fmt(rows[-1]['mu'])}")
        out.append(f"  objective {_sparkline(obj)}  "
                   f"{_fmt(obj[0])} -> {_fmt(obj[-1])}")
        out.append(f"  grad norm {_sparkline(gn)}  "
                   f"{_fmt(gn[0])} -> {_fmt(gn[-1])}")
        if any(v > 0 for v in viol):
            out.append(f"  violation {_sparkline(viol)}  "
                       f"max {_fmt(max(viol))}, final {_fmt(viol[-1])}")
        else:
            out.append("  violation 0 throughout (unconstrained lane)")


def _render_ticks(out, ticks: list[dict]) -> None:
    ticks = sorted(ticks, key=lambda e: e["tick"])
    out.append("")
    out.append(f"== tick ledger ({len(ticks)} ticks) ==")
    out.append("  tick  mode  steps  revision  latency_s  committed  "
               "realized  credit  recompiles")
    tot_c = tot_r = tot_m = 0.0
    for ev in ticks:
        c = sum(ev.get("committed_carbon") or [0.0])
        r = sum(ev.get("realized_carbon") or [0.0])
        m = ev.get("migration_credit") or 0.0
        tot_c, tot_r, tot_m = tot_c + c, tot_r + r, tot_m + m
        out.append(
            f"  {ev['tick']:>4d}  {'cold' if ev.get('cold') else 'warm'}"
            f"  {ev.get('warm_steps', 0):>5d}"
            f"  {_fmt(ev.get('revision'), 3):>8s}"
            f"  {_fmt(ev.get('latency_s'), 3):>9s}"
            f"  {_fmt(c, 1):>9s}  {_fmt(r, 1):>8s}"
            f"  {_fmt(m, 1):>6s}  {ev.get('recompiles', 0):>10d}")
    out.append(f"  total committed {_fmt(tot_c, 1)} kgCO2, realized "
               f"{_fmt(tot_r, 1)} kgCO2 "
               f"(drift {_fmt(tot_r - tot_c, 1)}), migration credit "
               f"{_fmt(tot_m, 1)} kgCO2")
    regions = max(len(ev.get("committed_carbon") or []) for ev in ticks)
    if regions > 1:
        per = [sum((ev.get("realized_carbon") or [0.0] * regions)[i]
                   for ev in ticks) for i in range(regions)]
        out.append("  realized by region: "
                   + ", ".join(f"r{i}={_fmt(v, 1)}"
                               for i, v in enumerate(per)))


def _render_spans(out, spans: list[dict]) -> None:
    agg = defaultdict(list)
    for ev in spans:
        agg[ev["name"]].append(float(ev["elapsed_s"]))
    out.append("")
    out.append(f"== spans ({len(spans)} events) ==")
    out.append("  name                          n     total_s      mean_s")
    for name in sorted(agg, key=lambda n: -sum(agg[n])):
        ts = agg[name]
        out.append(f"  {name:<28s} {len(ts):>3d}  {sum(ts):>10.4f}"
                   f"  {sum(ts) / len(ts):>10.4f}")


def _render_recompile_audit(out, ticks: list[dict], port: bool) -> None:
    """What compiled, in the writer's terms: graph captures and kernel
    builds for the port, jit traces for the JAX package."""
    what, cache, guard = (
        ("graph capture(s) / kernel build(s)", "graph and kernel cache",
         "repro_torch.analysis.recompile_guard") if port else
        ("jit trace(s)", "jit cache", "analysis.recompile_guard"))
    traced = [ev for ev in sorted(ticks, key=lambda e: e["tick"])
              if ev.get("recompiles", 0) > 0]
    warm_traced = [ev for ev in traced if not ev.get("cold")]
    dispatches = sum(ev.get("dispatches", 0) for ev in ticks)
    out.append("")
    out.append("== recompile audit ==")
    out.append(f"  {dispatches} dispatch(es) over {len(ticks)} ticks, "
               f"{sum(ev.get('recompiles', 0) for ev in ticks)} {what} "
               f"in {len(traced)} tick(s)")
    if warm_traced:
        at = ", ".join(str(ev["tick"]) for ev in warm_traced)
        out.append(f"  WARNING: warm tick(s) {at} recompiled — a static "
                   f"argument drifted (see {guard})")
    elif ticks:
        out.append(f"  warm ticks all rode the {cache} (compiles only "
                   f"on cold/first solves)")


def render(records: list[dict]) -> str:
    """Format a parsed ledger (header-first record list) as the report."""
    out: list[str] = []
    _render_header(out, records[0])
    by_kind = defaultdict(list)
    for rec in records[1:]:
        by_kind[rec.get("kind")].append(rec)
    if by_kind["telemetry"]:
        _render_convergence(out, by_kind["telemetry"])
    if by_kind["tick"]:
        _render_ticks(out, by_kind["tick"])
        _render_recompile_audit(out, by_kind["tick"], _is_port(records[0]))
    if by_kind["span"]:
        _render_spans(out, by_kind["span"])
    if not records[1:]:
        out.append("(no events)")
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a JSONL event ledger as a terminal "
                    "summary (convergence curves, tick ledger, spans, "
                    "recompile audit).")
    parser.add_argument("ledger", help="path to a run .jsonl file")
    args = parser.parse_args(argv)
    try:
        records = read_events(args.ledger)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(render(records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
