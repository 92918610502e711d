"""Sampler exporters: CSV / JSONL time series, pcm-accel style — plus the
Chrome/Perfetto ``trace_event`` exporter for descriptor-lifecycle traces.

CSV/JSONL are one record per tick.  CSV is wide-form — one column per
metric, mirroring ``pcm-accel -csv`` — with the column set fixed at export
time (metrics that appear mid-run backfill earlier rows with empty cells).
JSONL writes each tick's row as one JSON object, which round-trips ragged
rows exactly; non-finite values (NaN/inf) are serialized as ``null`` so
every emitted line is strict JSON (Python's default would write bare
``NaN`` tokens no JSON parser accepts).

``to_perfetto`` renders a ``repro_torch.obs.trace.Tracer`` as trace_event JSON
loadable as-is in chrome://tracing or https://ui.perfetto.dev: one process
track for the host plus one per engine, one thread lane per descriptor,
complete ("X") slices per lifecycle phase, flow arrows for ``after=`` /
``then`` dependency edges, and a host lane of WaitPolicy wait spans;
with ``stages=``, the program's stage spans on a process track of their
own, one lane per thread.
"""
from __future__ import annotations

import csv as _csv
import io
import json
import math
from pathlib import Path
from typing import Any, Dict, Optional


def to_csv(sampler, path: Optional[str] = None) -> str:
    """Render the sampler's buffered ticks as CSV; optionally also write
    the text to ``path``.  Returns the CSV text."""
    rows = sampler.rows()
    columns = sampler.columns()
    buf = io.StringIO()
    writer = _csv.DictWriter(buf, fieldnames=columns, restval="",
                             extrasaction="ignore", lineterminator="\n")
    writer.writeheader()
    for row in rows:
        writer.writerow({k: _fmt(v) for k, v in row.items()})
    text = buf.getvalue()
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(text)
    return text


def to_jsonl(sampler, path: Optional[str] = None) -> str:
    """Render the buffered ticks as JSON Lines (one strict-JSON object per
    tick; NaN/inf become null); optionally also write to ``path``."""
    lines = [
        json.dumps({k: _json_safe(v) for k, v in row.items()},
                   sort_keys=True, allow_nan=False)
        for row in sampler.rows()
    ]
    text = "\n".join(lines) + ("\n" if lines else "")
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(text)
    return text


def to_perfetto(tracer, path: Optional[str] = None, *,
                flows: bool = True, stages=None) -> str:
    """Render a Tracer's retained traces as Chrome/Perfetto trace_event
    JSON ({"traceEvents": [...]}); optionally also write to ``path``.

    Layout: pid 1 is the host (tid = descriptor id per lane, tid 0 holds
    the WaitPolicy wait spans); each engine that dispatched a sampled
    descriptor gets its own pid.  ``stages`` (``STAGES.spans()``, or any
    ``StageSpan``s) adds the program's stage spans on the "stages" track,
    a lane per thread; ``tracer`` may then be None.  Timestamps are
    microseconds from the earliest retained mark or span, clamped
    non-negative with dur >= 0, so the file always passes strict-JSON and
    monotonicity validation."""
    traces = tracer.traces() if tracer is not None else []
    waits = tracer.wait_spans() if tracer is not None else []
    stages = list(stages or [])
    starts = [dt.start for dt in traces if dt.marks]
    starts += [w.t0 for w in waits]
    starts += [sp.t0 for sp in stages]
    base = min(starts, default=0.0)

    def us(t: float) -> float:
        return round(max((t - base) * 1e6, 0.0), 3)

    pids: Dict[str, int] = {"host": 1}

    def pid_for(track: str) -> int:
        pid = pids.get(track)
        if pid is None:
            pid = pids[track] = 1 + len(pids)
        return pid

    events = []
    by_id = {}
    for dt in traces:
        if not dt.marks:
            continue
        by_id[dt.desc_id] = dt
        engine = dt.attrs.get("engine")
        args = {"trace_id": dt.trace_id, "op": dt.op,
                "nbytes": dt.nbytes}
        for k, v in dt.attrs.items():
            args[k] = _json_safe(v)
        for sp in dt.spans():
            track = "host" if sp.track == "host" else (engine or "engine")
            events.append({
                "name": sp.phase,
                "cat": "desc",
                "ph": "X",
                "ts": us(sp.t0),
                "dur": round(max(sp.t1 - sp.t0, 0.0) * 1e6, 3),
                "pid": pid_for(track),
                "tid": int(dt.desc_id),
                "args": args,
            })
    if flows and tracer is not None:
        for parent, child, kind in tracer.edges():
            pdt, cdt = by_id.get(parent), by_id.get(child)
            if pdt is None or cdt is None:
                continue
            flow_id = f"{parent}-{child}"
            events.append({
                "name": kind, "cat": "dep", "ph": "s", "id": flow_id,
                "ts": us(pdt.end), "pid": pids["host"], "tid": int(parent),
            })
            events.append({
                "name": kind, "cat": "dep", "ph": "f", "bp": "e",
                "id": flow_id,
                "ts": us(max(cdt.start, pdt.end)),
                "pid": pids["host"], "tid": int(child),
            })
    for w in waits:
        events.append({
            "name": f"wait/{w.policy}",
            "cat": "wait",
            "ph": "X",
            "ts": us(w.t0),
            "dur": round(max(w.t1 - w.t0, 0.0) * 1e6, 3),
            "pid": pids["host"],
            "tid": 0,
            "args": {"busy_s": _json_safe(w.busy_s),
                     "free_s": _json_safe(w.free_s),
                     "completions": w.completions},
        })
    lanes: Dict[int, int] = {}
    for sp in stages:
        lane = lanes.setdefault(sp.thread, len(lanes) + 1)
        args = {"sid": sp.sid, "parent": sp.parent, "ts_ns": sp.t0_ns}
        if sp.req is not None:
            args["trace_id"] = sp.req
        if sp.mode is not None:
            args["mode"] = sp.mode
        events.append({
            "name": sp.phase,
            "cat": "stage",
            "ph": "X",
            "ts": us(sp.t0),
            "dur": round(max(sp.t1 - sp.t0, 0.0) * 1e6, 3),
            "pid": pid_for("stages"),
            "tid": lane,
            "args": args,
        })
    for thread, lane in lanes.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pids["stages"],
                       "tid": lane, "args": {"name": f"thread {thread}"}})
    for track, pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"dsa-repro/{track}"}})
    if waits:
        events.append({"name": "thread_name", "ph": "M", "pid": pids["host"],
                       "tid": 0, "args": {"name": "waits"}})
    text = json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                      sort_keys=True, allow_nan=False)
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(text)
    return text


def _json_safe(v: Any) -> Any:
    """Strict-JSON value: non-finite floats become None, everything the
    JSON encoder can't take becomes its repr."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return repr(v)


def _fmt(v) -> str:
    """Compact numeric cells: integers stay integral, floats keep enough
    digits to reconcile byte counts exactly; non-finite floats render as
    empty cells (spreadsheet-safe, matching JSONL's null)."""
    if isinstance(v, float) and not math.isfinite(v):
        return ""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, float):
        return f"{v:.9g}"
    return str(v)
