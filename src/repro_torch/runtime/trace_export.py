"""Chrome/Perfetto ``trace_event`` export: open a flush in a trace viewer.

Converts :class:`~repro_torch.runtime.tracing.Span` records into the JSON
object format Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``
load — the ``{"traceEvents": [...]}`` envelope with microsecond
timestamps:

  * ``sync`` spans    -> ``ph: "X"`` complete slices (nested slices stack);
  * ``async`` spans   -> ``ph: "b"`` / ``ph: "e"`` async begin/end pairs
                         (containers like release/invocation/held overlap
                         on one lane without implying a call stack);
  * ``instant`` spans -> ``ph: "i"`` thread-scoped instants.

Each tracer *lane* ("sched", "host", "device0"...) becomes one tid, named
via ``M``-phase ``thread_name`` metadata, so a traced sharded flush renders
as a swimlane per device under the host staging lane.  Timestamps are
rebased to the earliest span so traces start at t=0 regardless of the
clock's epoch.

Also here: :func:`stage_sums` / :func:`reconcile` (do the per-stage charged
sums add back up to the measured wall? — the 10% acceptance gate) and
:func:`summarize` (the one-screen trace digest the example prints).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Sequence

__all__ = ["to_trace_events", "write_trace", "stage_sums", "reconcile",
           "summarize"]

_PID = 1

# Span attrs measuring one invocation's charged stage decomposition — the
# executor writes these at retirement (see executor._retire).
_CHARGED = ("hold_s", "stage_s", "compute_s", "shadow_s")


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def _lane_tids(spans: Sequence) -> dict[str, int]:
    lanes: dict[str, None] = {}
    for s in spans:
        lanes.setdefault(s.lane)
    order = sorted(lanes, key=lambda la: (la != "sched", la != "host", la))
    return {lane: i + 1 for i, lane in enumerate(order)}


def to_trace_events(spans: Iterable) -> list[dict]:
    """Spans -> Chrome ``trace_event`` dicts (ts/dur in microseconds)."""
    spans = [s for s in spans if s.t1 is not None]
    if not spans:
        return []
    tids = _lane_tids(spans)
    base = min(s.t0 for s in spans)
    events: list[dict] = [
        {"ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
         "args": {"name": lane}}
        for lane, tid in tids.items()]
    for s in sorted(spans, key=lambda s: (s.t0, s.span_id)):
        common = {
            "name": s.name, "pid": _PID, "tid": tids[s.lane],
            "ts": (s.t0 - base) * 1e6,
            "args": _jsonable(dict(s.attrs, span_id=s.span_id,
                                   parent_id=s.parent_id)),
        }
        if s.kind == "instant":
            events.append(dict(common, ph="i", s="t"))
        elif s.kind == "async":
            # async pairs share an id scope; cat is mandatory for b/e
            events.append(dict(common, ph="b", cat=s.name,
                               id=s.span_id))
            events.append({"ph": "e", "cat": s.name, "id": s.span_id,
                           "name": s.name, "pid": _PID,
                           "tid": tids[s.lane],
                           "ts": (s.t1 - base) * 1e6})
        else:
            events.append(dict(common, ph="X",
                               dur=max(s.t1 - s.t0, 0.0) * 1e6))
    return events


def write_trace(path: str, spans: Iterable) -> dict:
    """Write the Perfetto-loadable envelope; returns the payload written."""
    payload = {"traceEvents": to_trace_events(spans),
               "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


def stage_sums(spans: Iterable) -> dict[str, float]:
    """Charged seconds per stage, summed over completed invocation spans.

    Uses the *charged* attrs the executor writes at retirement (hold /
    stage / compute / shadow), not raw leaf-span geometry: charged time
    never double-bills pipeline overlap, so these sums are the ones that
    reconcile with a flush's measured wall."""
    out = {k[:-2]: 0.0 for k in _CHARGED}
    out["wall"] = 0.0
    for s in spans:
        if s.name != "invocation" or s.t1 is None:
            continue
        for k in _CHARGED:
            out[k[:-2]] += float(s.attrs.get(k, 0.0))
        out["wall"] += float(s.attrs.get("wall_s", 0.0))
    return out


def reconcile(spans: Iterable, measured_wall_s: float) -> dict:
    """Do the per-stage charged sums add back up to the measured wall?

    Returns the stage sums plus ``coverage`` = (stage + compute + hold +
    shadow) / measured_wall_s.  Coverage ~= 1 means the span decomposition
    accounts for the flush end to end (the acceptance gate asserts within
    10%); a shortfall is un-attributed host time between dispatches."""
    sums = stage_sums(spans)
    attributed = (sums["stage"] + sums["compute"] + sums["hold"]
                  + sums["shadow"])
    return dict(sums, attributed_s=attributed,
                measured_wall_s=measured_wall_s,
                coverage=(attributed / measured_wall_s
                          if measured_wall_s > 0.0 else float("nan")))


def summarize(spans: Iterable) -> str:
    """One-screen digest: span counts and total duration per (lane, name)."""
    spans = [s for s in spans if s.t1 is not None]
    rows = ["trace summary:"]
    if not spans:
        return rows[0] + " (no spans)"
    agg: dict[tuple[str, str], list[float]] = {}
    for s in spans:
        acc = agg.setdefault((s.lane, s.name), [0, 0.0])
        acc[0] += 1
        acc[1] += s.duration_s
    rows.append(f"  {'lane':>8}  {'span':<16} {'count':>5}  {'total':>10}")
    for (lane, name), (count, total) in sorted(agg.items()):
        rows.append(f"  {lane:>8}  {name:<16} {count:5d}  {total:10.3e}s")
    sums = stage_sums(spans)
    if sums["wall"] > 0.0:
        rows.append(
            f"  charged: stage={sums['stage']:.3e}s "
            f"compute={sums['compute']:.3e}s hold={sums['hold']:.3e}s "
            f"shadow={sums['shadow']:.3e}s (wall {sums['wall']:.3e}s)")
    return "\n".join(rows)
